"""Compressed statistics (``compress_stats``, the QLoRA paper's double
quantization) in the port against the JAX package on the CPU: the scale
codec, the quantizer, carrying compressed weights across, the routes of
kernels B, E and F on compressed weights (their plain versions here, the
JAX kernels in interpret mode), a tiny compressed Llama and one QLoRA step
on it. Inputs are numpy arrays from a seed.

Rounding, and the tolerances it sets:
- the port decodes a scale as ``fma(table[code], range, mean)`` rounded
  once, with the port's dynamic-map table (the JAX package's eager one);
  the JAX package's jitted decode contracts its table chain into FMAs (62
  of the 256 codes differ by up to 2 ulps) and its eager decode rounds the
  product and the sum apart. Decoded scales agree within 2 ulps (measured:
  1);
- ``compress_absmax`` takes the column mean with ``torch.mean``, whose
  order can differ from ``jnp.mean`` in the last bit; then a code moves by
  one step: codes at least 99.9% equal and never more than one step apart,
  the mean within 1e-6 relative (measured: 99.99% and 2.3e-7), and the
  range (the largest centred magnitude) apart by no more than the means
  are, plus 1e-6 of itself (measured 1.1e-6 relative where the
  subtraction cancels);
- quantized nibbles: at least 99.9% equal (measured: all), dequantized
  weights within 1e-4 of the largest (a scale code one step apart moves
  its block by up to a 1/64 step of the dynamic map's finest decade:
  measured 1.7e-5);
- kernel E's route: bf16 output bit for bit (the scale difference is
  below a bf16 ulp of the product), f32 within 2 f32 ulps of each value
  (the product of a scale within an ulp); kernel B's route: f32 x within
  rtol 1e-5, bf16 within one bf16 ulp of the largest output (the sums'
  order and a bf16 rounding); kernel F's route (W8A8): int8 codes within
  one step and the product within 1% of the largest output (an f32 scale
  an ulp apart can move a code at a rounding boundary);
- the tiny model (f32 activations, exact routes: compressed weights never
  take W4A8; test_torch_kv4.py serves it through the engine): logits
  within rtol 1e-4 of the largest; one QLoRA step's loss within rtol 1e-5
  and each adapter gradient within 1e-3 relative L2, as
  test_torch_qlora.py holds the exact path.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_sycl_tpu.ops.matmul_4bit as J4
import bitsandbytes_sycl_tpu.ops.matmul_w4a8 as JW
from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu.models import lora as JLo
from bitsandbytes_sycl_tpu.ops import common as JC
from bitsandbytes_sycl_tpu_torch import ops as T
from bitsandbytes_sycl_tpu_torch.convert import lora_from_jax, params_from_jax
from bitsandbytes_sycl_tpu_torch.models import llama as TL
from bitsandbytes_sycl_tpu_torch.models import lora as TLo
from bitsandbytes_sycl_tpu_torch.ops import common as TC
from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8 as TW

BF16_ULP = 2.0 ** -7


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want) / np.spacing(np.maximum(np.abs(got), np.abs(want)))


def _weight(N, K, seed=0):
    return (np.random.default_rng(seed).normal(size=(N, K)) * 0.02).astype(np.float32)


def _scales(N, K, bs=64, seed=0):
    W = _weight(N, K, seed)
    return np.abs(W.reshape(N, K // bs, bs)).max(2).T.reshape(2, K // (2 * bs), N)


# ------------------------------------------------------------ the scale codec


@pytest.mark.parametrize("N,K", [(128, 11008)])  # 86 blocks a column, as the 7B down_proj
def test_compress_absmax_matches_jax(N, K):
    amax = _scales(N, K)
    jc, js, jo = JC.compress_absmax(jnp.asarray(amax))
    tc, ts, to = TC.compress_absmax(torch.from_numpy(amax))
    jc, tc = np.asarray(jc), tc.numpy()
    assert tc.dtype == np.uint8 and tc.shape == amax.shape and ts.shape == to.shape == (2, 1, N)
    assert (jc == tc).mean() >= 0.999
    assert np.abs(jc.astype(np.int32) - tc.astype(np.int32)).max() <= 1
    js, jo = np.array(js), np.array(jo)
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-6)
    assert (np.abs(ts.numpy() - js) <= np.abs(to.numpy() - jo) + 1e-6 * js).all()
    # with JAX's own mean and range the codes are JAX's bit for bit
    from bitsandbytes_sycl_tpu_torch.ops.dynamic8 import dynamic_encode
    c = torch.from_numpy(amax) - torch.from_numpy(jo)
    again = dynamic_encode(c * TC.safe_inv(torch.from_numpy(js)), signed=True)
    np.testing.assert_array_equal(again.numpy(), jc)


def test_decode_absmax_matches_jax():
    amax = _scales(512, 1152, seed=1)
    jc, js, jo = JC.compress_absmax(jnp.asarray(amax))
    got = TC.decode_absmax(*(torch.from_numpy(np.asarray(a)) for a in (jc, js, jo))).numpy()
    for want in (np.asarray(jax.jit(JC.decode_absmax)(jc, js, jo)),
                 np.asarray(JC.decode_absmax(jc, js, jo))):
        assert _ulps(got, want).max() <= 2
    # every code decodes to fma(table[code], range, mean) rounded once
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(2, 128, 1)
    sc, off = torch.tensor([[[0.37]], [[1.9e-3]]]), torch.tensor([[[0.51]], [[-3e-4]]])
    dec = TC.decode_absmax(codes, sc, off).numpy().ravel()
    table = T.dynamic8.decode_table("cpu")[:256].numpy()
    for i in range(256):
        p = i // 128
        exact = Fraction(float(table[i])) * Fraction(float(sc[p, 0, 0])) + \
            Fraction(float(off[p, 0, 0]))
        assert abs(Fraction(float(dec[i])) - exact) <= abs(
            Fraction(float(np.spacing(np.float32(dec[i]))))) / 2


def test_fma_f32_rounds_once():
    """The one case a float64 sum rounds twice: a sum exactly halfway
    between two f32 values after the float64 rounding."""
    a = torch.tensor([1 + 2 ** -15, -(1 + 2 ** -15), 3.0, 0.0])
    b = torch.tensor([(1 - 2 ** -15) * 2 ** -24] * 2 + [0.1, 5.0])
    c = torch.tensor([1 + 2 ** -23, -(1 + 2 ** -23), -0.3, 2.5])
    got = TC.fma_f32(a, b, c).numpy()
    naive = (a.double() * b.double() + c.double()).float().numpy()
    assert got[0] == np.float32(1 + 2 ** -23) and naive[0] == np.float32(1 + 2 ** -22)
    assert got[1] == -got[0]
    assert got[3] == np.float32(2.5)
    exact = Fraction(3.0) * Fraction(float(np.float32(0.1))) + Fraction(float(np.float32(-0.3)))
    assert abs(Fraction(float(got[2])) - exact) <= abs(Fraction(float(np.spacing(got[2])))) / 2


@pytest.mark.parametrize("qt", ["nf4", "int4"])
def test_quantize_compressed_matches_jax(qt):
    W = _weight(384, 1152, seed=2)
    W[5, 70] = 0.0
    a = JC.quantize_4bit_native(jnp.asarray(W), blocksize=64, quant_type=qt,
                                compress_statistics=True)
    b = TC.quantize_4bit_native(torch.from_numpy(W), blocksize=64, quant_type=qt,
                                compress_statistics=True)
    assert b.compressed and b.absmax.dtype == torch.uint8
    assert b.absmax_scale.shape == b.absmax_offset.shape == (2, 1, 384)
    assert (np.asarray(a.packed) == b.packed.numpy()).mean() >= 0.999
    assert np.abs(np.asarray(a.absmax, np.int32) - b.absmax.numpy().astype(np.int32)).max() <= 1
    wa, wb = np.asarray(a.dequantize(), np.float32), b.dequantize().numpy()
    assert np.abs(wa - wb).max() <= 1e-4 * np.abs(wa).max()
    # the nibbles absorb the decoded scales: renormalized and clipped
    assert np.abs(wb - W).max() <= np.abs(W).max() * 0.2


# ------------------------------------------------------------ the routes


@pytest.fixture(scope="module")
def weights():
    out = {}
    for N, K in ((256, 512), (384, 1152)):  # 1152: half-K not a multiple of 8 blocks
        ja = JC.quantize_4bit_native(jnp.asarray(_weight(N, K, seed=K)), blocksize=64,
                                     compress_statistics=True)
        out[K] = (ja, params_from_jax({"w": jax.tree.map(np.asarray, ja)}, None,
                                      device="cpu")["w"])
    return out


@pytest.mark.parametrize("K,od", [(512, "bfloat16"), (1152, "float32")])
def test_dequantize_transposed_compressed_matches_jax(weights, K, od):
    ja, tw = weights[K]
    want = np.asarray(J4.dequantize_transposed(ja, jnp.dtype(od)), np.float32)
    got = T.dequantize_transposed(tw, getattr(torch, od)).float().numpy()
    if od == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        assert _ulps(got, want).max() <= 2


@pytest.mark.parametrize("K,M,cd", [(512, 1, "bfloat16"), (512, 4, "float32"),
                                    (512, 256, "bfloat16"), (1152, 256, "float32")])
def test_matmul_4bit_compressed_matches_jax(weights, K, M, cd):
    """Kernel B's plain version at 1, 4 and 256 rows (and at K = 1152 and
    256 rows, the dequantize-once route through kernel E), and the W4A8
    and grouped entries, which send compressed weights to it."""
    ja, tw = weights[K]
    x = np.random.default_rng(M).normal(size=(M, K)).astype(np.float32)
    jdt, tdt = jnp.dtype(cd), getattr(torch, cd)
    want = np.asarray(J4.matmul_4bit_fused(jnp.asarray(x), ja, compute_dtype=jdt), np.float32)
    got = T.matmul_4bit_fused(torch.from_numpy(x), tw, compute_dtype=tdt).float().numpy()
    if cd == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=BF16_ULP * np.abs(want).max())
    for entry in (T.matmul_4bit_w4a8, T.matmul_4bit_w4a8_grouped):
        again = entry(torch.from_numpy(x), tw, None, tdt)
        assert torch.equal(again, T.matmul_4bit_fused(torch.from_numpy(x), tw, compute_dtype=tdt))


@pytest.mark.parametrize("K", [1152])
def test_w8a8_compressed_matches_jax(weights, K):
    """col_grid decodes compressed scales before kernel F, as the JAX
    package's dequantize_to_int8 does; then the W8A8 route."""
    ja, tw = weights[K]
    jq, jcol = JW.dequantize_to_int8(ja)
    tq, tcol = TW.dequantize_to_int8(tw)
    np.testing.assert_allclose(tcol.numpy(), np.asarray(jcol), rtol=2 ** -22)
    d = np.abs(np.asarray(jq, np.int32) - tq.numpy().astype(np.int32))
    assert d.max() <= 1 and d.mean() < 1e-3
    colmax, f = TW.col_grid(tw)
    np.testing.assert_array_equal(colmax.numpy(), tcol.numpy())
    np.testing.assert_array_equal(TW.dequant_int8(tw, f).numpy(), tq.numpy())
    x = np.random.default_rng(3).normal(size=(40, K)).astype(np.float32)
    want = np.asarray(JW.matmul_4bit_w8a8_prefill(jnp.asarray(x), ja, None, jnp.float32))
    got = T.matmul_4bit_w8a8_prefill(torch.from_numpy(x), tw, None, torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# ------------------------------------------------------------ whole model


@pytest.fixture(scope="module")
def model():
    kw = dict(compress_stats=True, hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128,
              max_seq_len=256)
    jc = JL.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tc = TL.LlamaConfig.tiny(dtype=torch.float32, **kw)
    jp = jax.jit(JL.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0))  # eager: ~4x the time
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def test_params_from_jax_carries_compressed_weights(model):
    jc, _, jp, tp = model
    n = 0
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for name in ("q_proj", "down_proj"):
            a, b = jl[name], tl[name]
            assert b.compressed and (b.shape, b.blocksize, b.quant_type) == (
                tuple(a.shape), a.blocksize, a.quant_type)
            for f in ("packed", "absmax", "absmax_scale", "absmax_offset"):
                x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
            n += 1
    assert n == 2 * jc.num_layers


def test_compressed_llama_logits_match_jax(model):
    jc, tc, jp, tp = model
    toks = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    want = np.asarray(JL.llama_forward(jp, jc, jnp.asarray(toks))[0])
    got = TL.llama_forward(tp, tc, torch.from_numpy(toks))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_compressed_qlora_step_grads_match_jax(model):
    jc, tc, jp, tp = model
    targets = ("q_proj", "down_proj")  # through attention and the MLP, both planes' halves of K
    jlo = JLo.init_lora(jc, jax.random.PRNGKey(1), rank=4, targets=targets)
    jlo = jax.tree.map(lambda x: x + 0.01 if x.ndim == 2 else x, jlo)  # B nonzero
    tlo = lora_from_jax(jax.tree.map(np.asarray, jlo), "cpu")
    toks = np.random.default_rng(0).integers(0, 256, (2, 17)).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(JLo.qlora_loss_fn(jp, jc)))(jlo, jnp.asarray(toks))
    tl = TLo.qlora_loss_fn(tp, tc)(tlo, torch.from_numpy(toks))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jg)]
    tleaves = [x.grad.numpy() for x in TLo.lora_leaves(tlo)]
    assert len(tleaves) == len(jleaves) == 2 * len(targets) * 3
    worst = max(_rel_l2(a, b) for a, b in zip(tleaves, jleaves))
    assert worst <= 1e-3, worst
