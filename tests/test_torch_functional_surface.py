"""The port's library surface against the JAX package on the CPU: the
blockwise 8-bit and 4-bit quantizers, QuantState, the kernel-layout
repack, int8_double_quant, the 4-bit matmul routes (the port's kernels B
and E as their plain versions, the JAX kernels in interpret mode), the
autograd functions and the package root. Inputs are numpy arrays from a
seed.

Tolerances:
- bit for bit: codes, packed bytes and raw absmax of every quantizer,
  int8_double_quant, the kernel-layout repack (raw scales), whole-tensor
  codes, histogram sums of integer-valued floats;
- nested statistics: the port subtracts ``torch.mean`` of the absmax,
  which can differ from ``jnp.mean`` in the last bit; nested codes are
  then at least 99.9% equal and never more than one step apart, and bit
  for bit when the JAX package's mean is fed in;
- dequantized values: equal (measured), held within 1e-6 relative to the
  largest for the nested ones;
- matmul outputs and gradients: f32 within F32_TOL (sums in another
  order; the LLM.int8 epilogue of the port's fused route rounds unlike the
  JAX CPU default), bf16 within one bf16 ulp of the largest output
  (``_bf16_close``: a sum's order moves a bf16 rounding);
- stochastic rounding draws from a torch.Generator: no bias over many
  draws and every code one of the two bracketing entries, as the JAX
  package's own test holds its PRNG path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_sycl_tpu as jbnb
import bitsandbytes_sycl_tpu.autograd as JA
import bitsandbytes_sycl_tpu.functional as JF
import bitsandbytes_sycl_tpu_torch as bnb
from bitsandbytes_sycl_tpu.ops import common as JC
from bitsandbytes_sycl_tpu_torch import autograd as TA
from bitsandbytes_sycl_tpu_torch import functional as TF
from bitsandbytes_sycl_tpu_torch.convert import quant_state_from_jax
from bitsandbytes_sycl_tpu_torch.ops import common as TC

F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side runs small products on one thread: beside the
    suite's other workers, PyTorch's thread pool oversubscribes the cores
    (phase 8's wiring took 85 s instead of 2 in six processes of eight
    threads on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.detach().float().numpy()


def _bf16_close(got, want):
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max() + 1e-6


def _pair(a, dtype="float32"):
    """The same array in both packages, rounded to ``dtype`` first."""
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(getattr(torch, dtype))


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _custom_code(seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, 256).astype(np.float32)[rng.permutation(256)]


@pytest.mark.parametrize("blocksize", [64, 256, 4096])
@pytest.mark.parametrize("quant_type", ["dynamic", "dynamic_unsigned", "linear", "fp8", "custom"])
def test_quantize_blockwise_bit_for_bit(quant_type, blocksize):
    a = np.random.default_rng(blocksize).normal(size=(2 * 4096 + 17,)).astype(np.float32)
    if quant_type == "dynamic_unsigned":
        a = np.abs(a)
    a[:blocksize] = 0.0  # an all-zero block
    code = _custom_code() if quant_type == "custom" else None
    kw = dict(blocksize=blocksize, quant_type="dynamic" if code is not None else quant_type)
    qj, sj = JF.quantize_blockwise(jnp.asarray(a), code=None if code is None else jnp.asarray(code), **kw)
    qt, st = TF.quantize_blockwise(torch.from_numpy(a), code=None if code is None else torch.from_numpy(code), **kw)
    _same(qj, qt)
    _same(sj.absmax, st.absmax)
    _same(sj.code, st.code)
    assert st.quant_type == sj.quant_type and st.shape == tuple(sj.shape) and st.dtype == sj.dtype
    if blocksize == 256:  # the decode's parity needs one blocksize per codebook
        _same(JF.dequantize_blockwise(qj, sj), TF.dequantize_blockwise(qt, st))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocksize", [64, 128])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4", "int4", "af4"])
def test_quantize_4bit_bit_for_bit(quant_type, blocksize, dtype):
    a = np.random.default_rng(7).normal(size=(9 * blocksize + 13,)).astype(np.float32)  # odd numel
    a[blocksize:2 * blocksize] = 0.0
    ja, ta = _pair(a, dtype)
    pj, sj = JF.quantize_4bit(ja, blocksize=blocksize, quant_type=quant_type)
    pt, st = TF.quantize_4bit(ta, blocksize=blocksize, quant_type=quant_type)
    assert pt.shape == ((a.size + 1) // 2,)
    _same(pj, pt)
    _same(sj.absmax, st.absmax)
    assert st.dtype == sj.dtype == dtype
    np.testing.assert_array_equal(_np(JF.dequantize_4bit(pj, sj)), _np(TF.dequantize_4bit(pt, st)))


def test_nf4_tie_goes_to_the_lower_code():
    mids = np.asarray(jbnb.codebooks.code_midpoints(np.sort(jbnb.codebooks.get_4bit_type("nf4"))))
    a = np.zeros(64, np.float32)
    a[0] = 1.0  # absmax 1: the block is its own normalization
    a[1:16] = mids
    pj, _ = JF.quantize_nf4(jnp.asarray(a))
    pt, _ = TF.quantize_nf4(torch.from_numpy(a))
    _same(pj, pt)
    codes = TF.unpack_4bit(pt, 64).numpy()
    np.testing.assert_array_equal(codes[1:16], np.arange(15))  # midpoint k -> code k, not k + 1


def _step_apart(cj, ct):
    cj, ct = np.asarray(cj).astype(np.int32), ct.numpy().astype(np.int32)
    assert np.abs(cj - ct).max() <= 1
    assert (cj == ct).mean() >= 0.999


@pytest.mark.parametrize("kind", ["4bit", "blockwise"])
def test_nested_statistics(kind):
    # the shapes of test_kernel_layout_of_a_nested_state and of the 8-bit test
    a = _weight(256, 1024, seed=2).reshape(-1) if kind == "4bit" else \
        np.random.default_rng(64).normal(size=(2 * 4096 + 17,)).astype(np.float32)
    if kind == "4bit":
        pj, sj = JF.quantize_4bit(jnp.asarray(a), compress_statistics=True)
        pt, st = TF.quantize_4bit(torch.from_numpy(a), compress_statistics=True)
        dj, dt = JF.dequantize_4bit(pj, sj), TF.dequantize_4bit(pt, st)
    else:
        pj, sj = JF.quantize_blockwise(jnp.asarray(a), blocksize=64, nested=True)
        pt, st = TF.quantize_blockwise(torch.from_numpy(a), blocksize=64, nested=True)
        dj, dt = JF.dequantize_blockwise(pj, sj), TF.dequantize_blockwise(pt, st)
    assert st.nested and sj.nested and st.state2.blocksize == 256
    _same(pj, pt)  # the element codes see the raw absmax
    np.testing.assert_allclose(float(st.offset), float(sj.offset), rtol=1e-6)
    _step_apart(sj.absmax, st.absmax)
    np.testing.assert_allclose(st.state2.absmax.numpy(), np.asarray(sj.state2.absmax), rtol=1e-5)
    np.testing.assert_allclose(_np(st.dequant_absmax()), np.asarray(sj.dequant_absmax()),
                               rtol=0, atol=1e-6 * float(np.abs(np.asarray(sj.dequant_absmax())).max()))
    np.testing.assert_allclose(_np(dt), _np(dj), rtol=0, atol=1e-5 * np.abs(a).max())
    # the JAX package's own mean in: the nested level bit for bit
    bs = sj.blocksize
    raw = np.abs(np.pad(a, (0, -a.size % bs)).reshape(-1, bs)).max(1)
    q2, s2 = TF.quantize_blockwise(torch.from_numpy(raw) - torch.from_numpy(np.asarray(sj.offset)),
                                   blocksize=256)
    _same(sj.absmax, q2)
    _same(sj.state2.absmax, s2.absmax)


def test_stochastic_rounding_unbiased_between_bracketing_entries():
    val = 0.30103
    a = np.full((4096,), val, np.float32)
    a[0] = 1.0  # pins the block absmax, so val stays between entries
    q_rtn, qs = TF.quantize_blockwise(torch.from_numpy(a), blocksize=4096)
    d_rtn = float(TF.dequantize_blockwise(q_rtn, qs)[1])
    code = np.asarray(jbnb.codebooks.create_dynamic_map())
    lo, hi = code[code <= val].max(), code[code >= val].min()
    means = []
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        q, qs2 = TF.quantize_blockwise(torch.from_numpy(a), blocksize=4096, generator=gen)
        vals = np.unique(code[q[1:].numpy()])
        np.testing.assert_array_equal(vals, [lo, hi])  # exactly the two bracketing entries
        means.append(float(TF.dequantize_blockwise(q, qs2)[1:].mean()))
    assert abs(np.mean(means) - val) < abs(d_rtn - val) * 0.5


def test_stochastic_rounding_custom_code():
    code = np.linspace(-1, 1, 256).astype(np.float32)
    a = (np.random.default_rng(8).normal(size=(1024,)) * 0.5).astype(np.float32)
    q, qs = TF.quantize_blockwise(torch.from_numpy(a), code=torch.from_numpy(code), blocksize=256,
                                  generator=torch.Generator().manual_seed(0))
    assert qs.quant_type == "custom"
    assert np.abs(TF.dequantize_blockwise(q, qs).numpy() - a).mean() < 0.02


def test_whole_tensor_quantize_bit_for_bit():
    a = np.random.default_rng(4).normal(size=(33, 31)).astype(np.float32)
    qj, (mj, cj) = JF.quantize(jnp.asarray(a))
    qt, (mt, ct) = TF.quantize(torch.from_numpy(a))
    _same(qj, qt)
    _same(mj, mt)
    _same(JF.dequantize(qj, (mj, cj)), TF.dequantize(qt, (mt, ct)))
    _same(JF.quantize_no_absmax(jnp.asarray(a / 4)), TF.quantize_no_absmax(torch.from_numpy(a / 4)))
    _same(JF.dequantize_no_absmax(qj), TF.dequantize_no_absmax(qt))


@pytest.mark.parametrize("threshold", [0.0, 6.0])
def test_int8_double_quant_bit_for_bit(threshold):
    A = np.random.default_rng(5).normal(size=(48, 96)).astype(np.float32)
    A[:, 7] *= 20.0
    A[3] = 0.0
    for j, t in zip(JF.int8_double_quant(jnp.asarray(A), threshold),
                    TF.int8_double_quant(torch.from_numpy(A), threshold)):
        _same(j, t)


def _weight(N, K, seed=0):
    return (np.random.default_rng(seed).normal(size=(N, K)) * 0.05).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_layout_repack_bit_for_bit(dtype):
    jw, tw = _pair(_weight(256, 512), dtype)
    pj, sj = JF.quantize_nf4(jw)
    pt, st = TF.quantize_nf4(tw)
    kj, kt = JC.to_kernel_layout(pj, sj), TC.to_kernel_layout(pt, st)
    _same(kj.packed, kt.packed)
    _same(kj.absmax, kt.absmax)
    assert kt.dtype == kj.dtype == dtype and not kt.compressed
    native = TC.quantize_4bit_native(tw)  # the same bytes straight into the layout
    _same(native.packed, kt.packed)
    _same(native.absmax, kt.absmax)
    bj, qj = JC.from_kernel_layout(kj)
    bt, qt = TC.from_kernel_layout(kt)
    _same(bj, bt)
    _same(pt, bt)  # the round trip gives back the bytes
    _same(qj.absmax, qt.absmax)
    assert qt.shape == (256, 512) and qt.quant_type == "nf4"


def test_nested_state_from_jax_kernel_layout_and_qtensor():
    a = _weight(256, 1024, seed=2)
    pj, sj = JF.quantize_nf4(jnp.asarray(a), compress_statistics=True)
    st = quant_state_from_jax(jax.tree.map(np.asarray, sj), device="cpu")
    assert st.nested and st.state2.quant_type == "dynamic" and st.to("cpu").state2.absmax.numel()
    pt = torch.from_numpy(np.asarray(pj))
    np.testing.assert_array_equal(_np(bnb.QTensor(pt, st).dequantize()),
                                  _np(jbnb.QTensor(pj, sj).dequantize()))
    kj, kt = JC.to_kernel_layout(pj, sj), TC.to_kernel_layout(pt, st)
    assert kt.compressed and kj.absmax_scale is not None
    _same(kj.packed, kt.packed)
    _step_apart(kj.absmax, kt.absmax)
    np.testing.assert_allclose(kt.scales_f32().numpy(), np.asarray(kj.scales_f32()), rtol=1e-5)
    # the docstring path on the nested state: the kernel route (its
    # recompressed scales) against the plain route (the nested absmax)
    x = torch.from_numpy(np.random.default_rng(11).normal(size=(4, 1024)).astype(np.float32))
    np.testing.assert_allclose(bnb.matmul_4bit(x, pt, st).numpy(),
                               TF.matmul_4bit_ref(x, pt, st).numpy(), rtol=1e-2, atol=1e-2)
    b = np.random.default_rng(64).normal(size=(2 * 4096 + 17,)).astype(np.float32)
    qb, sb = JF.quantize_blockwise(jnp.asarray(b), blocksize=256)
    tb = bnb.QTensor(torch.from_numpy(np.asarray(qb)), quant_state_from_jax(sb, device="cpu"))
    assert tb.shape == b.shape and tb.dtype == torch.float32
    _same(jbnb.QTensor(qb, sb).dequantize(), tb.dequantize())


# (M, N, K, blocksize): the kernel route (K a multiple of 2 * bs) and the plain one
ROUTES = [(4, 256, 512, 64), (3, 128, 96, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ROUTES, ids=["kernel", "plain"])
def test_matmul_4bit_and_its_gradient(shape, dtype):
    M, N, K, bs = shape
    jw, tw = _pair(_weight(N, K), dtype)
    pj, sj = JF.quantize_4bit(jw, blocksize=bs)
    pt, st = TF.quantize_4bit(tw, blocksize=bs)
    x = np.random.default_rng(1).normal(size=(M, K)).astype(np.float32)
    b = np.random.default_rng(2).normal(size=(N,)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jb, tb = _pair(b, dtype)
    close = (lambda g, w: np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)) \
        if dtype == "float32" else _bf16_close
    # JAX's matmul_4bit routes as its gemv_4bit does: one forward serves both
    out_j, vjp = jax.vjp(lambda a, c: JA.matmul_4bit(a, pj, sj, c), jx, jb)
    close(TF.gemv_4bit(tx, pt, st, tb), out_j)
    close(TF.matmul_4bit_ref(tx, pt, st, tb), JF.matmul_4bit_ref(jx, pj, sj, jb))
    gy = np.random.default_rng(3).normal(size=(M, N)).astype(np.float32)
    jg, tg = _pair(gy, dtype)
    gx_j, gb_j = vjp(jg)
    txg, tbg = tx.clone().requires_grad_(), tb.clone().requires_grad_()
    out = TA.matmul_4bit(txg, pt, st, tbg)
    close(out.detach(), out_j)
    out.backward(tg)
    close(txg.grad, gx_j)
    close(tbg.grad, gb_j)


def test_kernel_layout_cache_sees_writes_in_place():
    w = torch.from_numpy(_weight(128, 256, seed=9))
    packed, qs = TF.quantize_nf4(w)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 256)).astype(np.float32))
    y0 = TA.matmul_4bit(x, packed, qs)
    assert TF._route_fused_4bit(x, packed, qs) is TF._route_fused_4bit(x, packed, qs)  # cached
    packed.bitwise_xor_(0x11)  # flip a nibble of every byte, in place
    y1 = TA.matmul_4bit(x, packed, qs)
    np.testing.assert_allclose(y1.numpy(), TF.matmul_4bit_ref(x, packed, qs).numpy(), **F32_TOL)
    assert not torch.allclose(y0, y1)
    qs.absmax.mul_(2.0)
    np.testing.assert_allclose(TA.matmul_4bit(x, packed, qs).numpy(), 2 * y1.numpy(), rtol=1e-5)
    key = (id(packed), id(qs.absmax))
    assert key in TF._KERNEL_LAYOUT_CACHE
    del packed, qs
    assert key not in TF._KERNEL_LAYOUT_CACHE  # dropped with the weight


def _int8_weight(N, K, seed=0):
    CB, SCB = JF.int8_vectorwise_quant(jnp.asarray(_weight(N, K, seed)))
    return (CB, SCB), (torch.from_numpy(np.asarray(CB)), torch.from_numpy(np.asarray(SCB)))


@pytest.mark.parametrize("mode", ["threshold0", "outliers", "per_call"])
def test_matmul_8bit_lt_and_its_gradient(mode):
    (CBj, SCBj), (CBt, SCBt) = _int8_weight(128, 256)
    A = np.random.default_rng(1).normal(size=(6, 256)).astype(np.float32)
    A[:, 7] *= 20.0
    bias = np.random.default_rng(2).normal(size=(128,)).astype(np.float32)
    th = 0.0 if mode == "threshold0" else 6.0
    oj = ot = None
    if mode == "outliers":
        oj = JF.llm_int8_prepare_outliers(CBj, SCBj, jnp.asarray([7, 100], jnp.int32))
        ot = TF.llm_int8_prepare_outliers(CBt, SCBt, [7, 100])
    gy = np.random.default_rng(3).normal(size=(6, 128)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: JA.matmul_8bit_lt(a, CBj, SCBj, th, b, oj),
                        jnp.asarray(A), jnp.asarray(bias))
    gj = vjp(jnp.asarray(gy))
    ta = torch.from_numpy(A).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    out = TA.matmul_8bit_lt(ta, CBt, SCBt, th, tb, ot)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    out.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(gj[0]), **F32_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gj[1]), **F32_TOL)


@pytest.mark.parametrize("threshold", [0.0, 6.0])
def test_matmul_8bit_train_and_matmul(threshold):
    W = _weight(96, 128, seed=4)
    A = np.random.default_rng(5).normal(size=(5, 128)).astype(np.float32)
    A[:, 3] *= 20.0
    bias = np.random.default_rng(6).normal(size=(96,)).astype(np.float32)
    gy = np.random.default_rng(7).normal(size=(5, 96)).astype(np.float32)
    jargs = [jnp.asarray(v) for v in (A, W, bias)]
    want, vjp = jax.vjp(lambda a, w, b: JA.matmul_8bit_train(a, w, threshold, b), *jargs)
    gj = vjp(jnp.asarray(gy))
    targs = [torch.from_numpy(v).requires_grad_() for v in (A, W, bias)]
    out = TA.matmul_8bit_train(targs[0], targs[1], threshold, targs[2])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    out.backward(torch.from_numpy(gy))
    for t, j in zip(targs, gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **F32_TOL)
    # bnb.matmul's three forms: in the JAX package each is llm_int8_matmul
    # over int8_vectorwise_quant(W), the forward of matmul_8bit_train
    want = np.asarray(jbnb.matmul(jargs[0], jargs[1], threshold=threshold))
    ta, tw = targs[0].detach(), targs[1].detach()
    CBt, SCBt = TF.int8_vectorwise_quant(tw)
    ts = bnb.MatmulLtState(CB=CBt, SCB=SCBt, threshold=threshold, has_fp16_weights=False)
    for got in (bnb.matmul(ta, tw, threshold=threshold), bnb.matmul(ta, CBt, SCBt, threshold=threshold),
                bnb.matmul(ta, None, state=ts)):
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_histogram_scatter_add_2d_exact():
    rng = np.random.default_rng(12)
    hist = rng.integers(0, 5, size=(16, 16)).astype(np.float32)
    i1, i2 = rng.integers(0, 16, 500).astype(np.int32), rng.integers(0, 16, 500).astype(np.int32)
    src = rng.integers(-3, 4, 500).astype(np.float32)  # integer values: every sum order is exact
    want = JF.histogram_scatter_add_2d(jnp.asarray(hist), jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(src))
    th = torch.from_numpy(hist)
    got = TF.histogram_scatter_add_2d(th, torch.from_numpy(i1), torch.from_numpy(i2), torch.from_numpy(src))
    _same(want, got)
    np.testing.assert_array_equal(th.numpy(), hist)  # a copy: hist is left as it was


def test_outlier_pooler_and_layout_indices():
    for mod in (JA, TA):
        mod.GlobalOutlierPooler._instance = None
    jp, tp = JA.GlobalOutlierPooler.get_instance(), TA.GlobalOutlierPooler.get_instance()
    for idx, dim in (([3, 1], 64), ([5], 64), ([9], 128)):
        jp.add_outliers(np.asarray(idx), dim)
        tp.add_outliers(torch.tensor(idx), dim)
    _same(jp.get_current_outlier_idx(), tp.get_current_outlier_idx())

    def tile(t):  # a transposed 4 x 8 tile
        return t.reshape(4, 8).T

    ij = JA.get_inverse_transform_indices(tile, (4, 8))
    it = TA.get_inverse_transform_indices(tile, (4, 8))
    _same(ij, it)
    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    permuted = x.T.reshape(4, 8)
    _same(JA.undo_layout(jnp.asarray(permuted), ij), TA.undo_layout(torch.from_numpy(permuted), it))


def test_the_root_exports_the_jax_surface():
    left_out = {"legacy", "matmul_cublas", "mm_cublas", "bmm_cublas"}  # ROADMAP Queue A #11
    missing = [n for n in jbnb.__all__ if n not in left_out and not hasattr(bnb, n)]
    assert not missing
    assert set(jbnb.__all__) - left_out <= set(bnb.__all__)
    assert bnb.nn.LinearNF4 and bnb.utils.replace_linear and bnb.autograd.matmul_4bit_kernel


def test_the_docstring_example():
    w = _weight(256, 512, seed=10)
    x = np.random.default_rng(11).normal(size=(4, 512)).astype(np.float32)
    packed, qs = bnb.quantize_nf4(torch.from_numpy(w))
    y = bnb.matmul_4bit(torch.from_numpy(x), packed, qs)
    pj, sj = jbnb.quantize_nf4(jnp.asarray(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(jbnb.matmul_4bit(jnp.asarray(x), pj, sj)),
                               **F32_TOL)


def test_llama_int8_linear_backward():
    """The Llama model's LLM.int8 linear records autograd's backward when x
    requires grad: grad_x = g @ (CB * SCB / 127), the forward unchanged."""
    from bitsandbytes_sycl_tpu_torch.models import llama as TL

    cfg = TL.LlamaConfig.tiny(num_layers=1, quant="int8")
    (_, _), (CB, SCB) = _int8_weight(128, 256, seed=13)
    w = {"CB": CB, "SCB": SCB, "outliers": TF.llm_int8_prepare_outliers(CB, SCB, [3, 9])}
    x = torch.from_numpy(np.random.default_rng(14).normal(size=(2, 3, 256)).astype(np.float32))
    with torch.no_grad():
        want = TL.apply_linear(x, w, cfg)
    xg = x.clone().requires_grad_()
    out = TL.apply_linear(xg, w, cfg)
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(g)
    W = CB.float() * (SCB.float() / 127.0)[:, None]
    torch.testing.assert_close(xg.grad, (g.reshape(-1, 128) @ W).reshape(x.shape), **F32_TOL)
