"""The port's ``nn`` modules, ``utils`` and ``utils.debug`` against the JAX
package on the CPU, and the wiring of ``chip_smoke.py``'s phase 8 (the
library at Llama-7B width and depth) at 2 layers and narrow widths.

Every port module is built by ``convert.module_from_jax`` from the
variables of its Flax counterpart (initialised here from a PRNG key), so
both hold the same bytes; inputs are numpy arrays from a seed.
Tolerances: f32 outputs and gradients within F32_TOL (sums in another
order; the JAX package's unfused LLM.int8 epilogue on the CPU rounds
unlike the port's fused route), bf16 within one bf16 ulp of the largest
output (compressed statistics too, whose decoded scales sit within 2 ulps
of the JAX package's), StableEmbedding within 1e-5 (flax's LayerNorm
takes the variance as mean(x^2) - mean(x)^2, PyTorch's by two passes; eps
1e-6 in both). Quantized bytes moved by replace_linear are bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_sycl_tpu.functional as JF
import bitsandbytes_sycl_tpu.utils as JU
from bitsandbytes_sycl_tpu import nn as jnn
from bitsandbytes_sycl_tpu_torch import functional as TF
from bitsandbytes_sycl_tpu_torch import nn as tnn
from bitsandbytes_sycl_tpu_torch import utils as TU
from bitsandbytes_sycl_tpu_torch.convert import module_from_jax
from bitsandbytes_sycl_tpu_torch.utils import debug

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


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    if tol == "bf16":
        assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max() + 1e-6
    else:
        np.testing.assert_allclose(got, want, **tol)


def _x(shape, seed=1, outlier_col=None):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if outlier_col is not None:
        x[..., outlier_col] *= 20.0
    return x


def _outlier_weight(vs):
    """An input dim whose weights spread 20x wider: an outlier dim."""
    w = np.array(vs["params"]["weight"])
    w[:, 5] *= 20.0
    return {**vs, "params": {**vs["params"], "weight": jnp.asarray(w)}}


F32 = dict(compute_dtype=torch.float32)
# (Flax module, port class, port options, x shape, tolerance, variables edit, grads)
CASES = {
    "Linear4bit-kernel-f32": (jnn.Linear4bit(features=128, compute_dtype=jnp.float32),
                              tnn.Linear4bit, F32, (2, 3, 256), F32_TOL, None, True),
    "Linear4bit-kernel-bf16-compressed": (jnn.Linear4bit(features=128, compress_statistics=True),
                                          tnn.Linear4bit, {}, (4, 256), "bf16", None, False),
    "Linear4bit-bnb-f32": (jnn.Linear4bit(features=128, use_kernel=False,
                                          compute_dtype=jnp.float32),
                           tnn.Linear4bit, F32, (4, 256), F32_TOL, None, True),
    "Linear4bit-in96": (jnn.Linear4bit(features=64, compute_dtype=jnp.float32),
                        tnn.Linear4bit, F32, (3, 96), F32_TOL, None, False),
    "LinearNF4": (jnn.LinearNF4(features=128, compute_dtype=jnp.float32), tnn.LinearNF4, F32,
                  (2, 256), F32_TOL, None, False),
    "LinearFP4-bf16": (jnn.LinearFP4(features=128), tnn.LinearFP4, {}, (2, 256), "bf16", None,
                       False),
    "Linear8bitLt-threshold0": (jnn.Linear8bitLt(features=128, threshold=0.0,
                                                 compute_dtype=jnp.float32),
                                tnn.Linear8bitLt, dict(threshold=0.0, **F32), (5, 256), F32_TOL,
                                None, True),
    "Linear8bitLt-outliers": (jnn.Linear8bitLt(features=128, outlier_idx=(3, 17),
                                               compute_dtype=jnp.float32),
                              tnn.Linear8bitLt, F32, (5, 256), F32_TOL, None, False),
    "Linear8bitLt-per-call": (jnn.Linear8bitLt(features=128, compute_dtype=jnp.float32),
                              tnn.Linear8bitLt, F32, (5, 256), F32_TOL, None, False),
    "Linear8bitLt-fp16-weights": (jnn.Linear8bitLt(features=64, has_fp16_weights=True,
                                                   compute_dtype=jnp.float32),
                                  tnn.Linear8bitLt, F32, (4, 128), F32_TOL, None, True),
    "Embedding": (jnn.Embedding(num_embeddings=50, features=16), tnn.Embedding, {}, None,
                  dict(rtol=0, atol=0), None, False),
    "StableEmbedding": (jnn.StableEmbedding(num_embeddings=50, features=16), tnn.StableEmbedding,
                        {}, None, dict(rtol=1e-5, atol=1e-5), None, False),
    "OutlierAwareLinear": (jnn.OutlierAwareLinear(features=64, compute_dtype=jnp.float32),
                           tnn.OutlierAwareLinear, F32, (4, 128), F32_TOL, _outlier_weight, False),
    "SwitchBackLinearBnb": (jnn.SwitchBackLinearBnb(features=64, compute_dtype=jnp.float32),
                            tnn.SwitchBackLinearBnb, F32, (4, 128), F32_TOL, None, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_matches_flax(case):
    jm, cls, cfg, shape, tol, edit, grads = CASES[case]
    if shape is None:  # embeddings take ids
        xj = jnp.asarray([[1, 2, 3], [49, 0, 7]], jnp.int32)
        xt = torch.tensor(np.asarray(xj)).long()
    else:
        x = _x(shape, outlier_col=7)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    vs = jm.init(jax.random.PRNGKey(0), xj)
    if edit is not None:
        vs = edit(vs)
    if "params" in vs and "bias" in vs["params"]:  # a bias that is not zero
        b = np.random.default_rng(2).normal(size=vs["params"]["bias"].shape)
        vs = {**vs, "params": {**vs["params"], "bias": jnp.asarray(b, vs["params"]["bias"].dtype)}}
    tm = module_from_jax(cls, jax.tree.map(np.asarray, vs), device="cpu", **cfg)
    want = jm.apply(vs, xj)
    got = tm(xt)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, tol)
    if case == "OutlierAwareLinear":
        assert bool(tm.outlier_mask()[5]) and int(tm.outlier_mask().sum()) == 1
    if not grads:
        return
    gy = np.random.default_rng(3).normal(size=want.shape).astype(np.float32)

    def loss(params, x):
        return jnp.vdot(jm.apply({**vs, "params": params}, x).astype(jnp.float32), gy)

    gp, gx = jax.grad(loss, argnums=(0, 1))(vs["params"], xj)
    xg = xt.clone().requires_grad_()
    tm(xg).backward(torch.from_numpy(gy).to(got.dtype))
    _close(xg.grad, gx, tol)
    _close(tm.bias.grad, gp["bias"], tol)
    if "weight" in gp:
        _close(tm.weight.grad, gp["weight"], tol)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_state_dict_and_to(use_kernel):
    gen = torch.Generator().manual_seed(0)
    a = tnn.Linear4bit(256, 128, device="cpu", use_kernel=use_kernel, compress_statistics=True,
                       compute_dtype=torch.float32, generator=gen)
    b = tnn.Linear4bit(256, 128, device="cpu", use_kernel=use_kernel, compress_statistics=True,
                       compute_dtype=torch.float32, generator=gen)
    x = torch.from_numpy(_x((3, 256)))
    sd = a.state_dict()
    assert "packed" in sd and "absmax" in sd and "bias" in sd
    assert ("absmax_scale" in sd) == use_kernel and ("state2_absmax" in sd) != use_kernel
    yb = b(x)  # caches b's repack (bnb mode)
    b.load_state_dict(sd)  # copies in place: the repack must follow
    torch.testing.assert_close(b(x), a(x), rtol=0, atol=0)
    assert not torch.equal(yb, b(x))
    c = a.to("cpu")
    assert c.packed.device.type == "cpu"
    l8 = tnn.Linear8bitLt(128, 64, outlier_idx=[1, 2], device="cpu", generator=gen)
    assert set(l8.state_dict()) == {"CB", "SCB", "outlier_idx", "outlier_keep", "outlier_subB",
                                    "bias"}


def test_constructors_need_cuda_unless_given_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: tnn.Linear4bit(256, 128, **kw),
                 lambda **kw: tnn.Linear8bitLt(128, 64, **kw),
                 lambda **kw: tnn.StableEmbedding(10, 8, **kw),
                 lambda **kw: tnn.OutlierAwareLinear(128, 64, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert next(make(device="cpu").buffers(), torch.zeros(1)).device.type == "cpu"


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layer": [{"weight": rng.normal(size=(64, 128)).astype(np.float32),
                       "bias": rng.normal(size=(64,)).astype(np.float32)},
                      {"kernel": rng.normal(size=(32, 64)).astype(np.float32)}],
            "norm": {"scale": rng.normal(size=(128,)).astype(np.float32)}}


def test_replace_linear_on_a_dict_bit_for_bit():
    tree = _tree()
    jt = JU.replace_linear(jax.tree.map(jnp.asarray, tree), compress_statistics=True)
    tt = TU.replace_linear(jax.tree.map(torch.from_numpy, tree), compress_statistics=True)
    for i in (0, 1):
        key = "weight" if i == 0 else "kernel"
        jq, tq = jt["layer"][i][key], tt["layer"][i][key]
        np.testing.assert_array_equal(np.asarray(jq["packed"]), tq["packed"].numpy())
        assert tq["quant_state"].nested and tq["quant_state"].shape == tuple(tree["layer"][i][key].shape)
    assert isinstance(tt["layer"][0]["bias"], torch.Tensor) and isinstance(tt["norm"]["scale"], torch.Tensor)
    only = TU.replace_linear(jax.tree.map(torch.from_numpy, tree),
                             predicate=lambda path, leaf: path[-1] == "kernel")
    assert isinstance(only["layer"][0]["weight"], torch.Tensor) and "packed" in only["layer"][1]["kernel"]


def test_replace_linear_on_a_module():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(256, 128), torch.nn.ReLU(),
                                torch.nn.Linear(128, 64, bias=False))
    w0 = model[0].weight.detach().clone()
    x = torch.from_numpy(_x((3, 256)))
    TU.replace_linear(model, quant_type="nf4", blocksize=64)
    assert type(model[0]) is tnn.LinearNF4 and type(model[2]) is tnn.LinearNF4
    q = tnn.quantize_linear_params({"weight": w0})["weight"]
    torch.testing.assert_close(model[0].packed, q["packed"], rtol=0, atol=0)
    pj, sj = JF.quantize_4bit(jnp.asarray(w0.numpy()), blocksize=64)
    np.testing.assert_array_equal(np.asarray(pj), model[0].packed.numpy())
    y = model(x)
    h = torch.relu(TF.matmul_4bit_ref(x, model[0].packed, model[0].quant_state, model[0].bias))
    torch.testing.assert_close(y, TF.matmul_4bit_ref(h, model[2].packed, model[2].quant_state),
                               **F32_TOL)
    keep = torch.nn.Sequential(torch.nn.Linear(128, 64))
    TU.replace_linear(keep, predicate=lambda name, m: False)
    assert type(keep[0]) is torch.nn.Linear


def test_pack_dict_outlier_tracer_and_debug_checks():
    d = {"quant_type": "nf4", "blocksize": 64, "shape": [3, 4]}
    t = TU.pack_dict_to_tensor(d)
    assert t.dtype == torch.uint8
    np.testing.assert_array_equal(t.numpy(), JU.pack_dict_to_tensor(d))
    assert TU.unpack_tensor_to_dict(t) == d == TU.unpack_tensor_to_dict(JU.pack_dict_to_tensor(d))
    w = _x((64, 128), seed=4)
    w[:, 9] *= 30.0
    tracer = TU.OutlierTracer.get_instance()
    wt = torch.from_numpy(w)
    mask = tracer.get_outliers(wt)
    np.testing.assert_array_equal(mask.numpy(), JU.OutlierTracer().get_outliers(jnp.asarray(w)))
    assert tracer.get_outliers(wt) is mask and bool(mask[9])
    wt[:, 9] = 0.0  # a write in place: computed again
    assert not bool(tracer.get_outliers(wt)[9])

    f = debug.checked(lambda a: torch.log(a) + 1.0)
    torch.testing.assert_close(f(torch.ones(3)), torch.ones(3))
    with pytest.raises(debug.FloatCheckError, match="log"):
        f(torch.tensor([1.0, -1.0]))
    with pytest.raises(debug.FloatCheckError, match=r"\['inf'\]\[0\]"):
        debug.nan_guard({"inf": [torch.tensor([float("inf")])]})
    packed, qs = TF.quantize_nf4(torch.from_numpy(w))
    debug.check_quant_state(packed, qs)
    qs.absmax[0] = -1.0
    with pytest.raises(debug.FloatCheckError, match="negative"):
        debug.check_quant_state(packed, qs)


def test_phase8_wiring_at_two_layers():
    """chip_smoke.py phase 8's helpers on the CPU at 2 layers and narrow
    widths: the HF-named tree, replace_linear and to_int8 over it (7 4-bit
    and 7 int8 modules a layer), the per-module forward and backward with
    its checks against the plain routes, and the launch-count table (no
    kernel launches on the CPU)."""
    import chip_smoke as cs
    from bitsandbytes_sycl_tpu_torch.models.llama import LlamaConfig
    from bitsandbytes_sycl_tpu_torch.ops import KERNELS

    cfg = LlamaConfig.tiny(num_layers=2)
    tree = cs.hf_llama_tree(torch, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, 2,
                            device="cpu")
    names = [n for n, m in tree.named_modules() if isinstance(m, torch.nn.Linear)]
    assert len(names) == 15 and "model.layers.1.mlp.down_proj" in names and "lm_head" in names
    TU.replace_linear(tree, "nf4", 64)
    assert cs.per_layer_counts(tree, tnn.LinearNF4, 2) == [7, 7]
    int8 = cs.to_int8(torch, cs.hf_llama_tree(torch, 256, 512, 256, 2, device="cpu"))
    assert cs.per_layer_counts(int8, tnn.Linear8bitLt, 2) == [7, 7]
    assert all(m.outliers["idx"].numel() == 32 for _, m in cs.modules_of(int8, tnn.Linear8bitLt))
    table = cs.library_launches(15, 15)
    assert table["nf4, 4 rows"]["mm4_fused"] == 15
    assert table["nf4, 2048 rows forward and backward"]["dequantize_transposed"] == 30
    assert table["int8, 4 rows"]["int8_matmul"] == 15
    assert table["int8 trainable, 128 rows forward and backward"]["int8_matmul"] == 7
    stats = cs.library_7b(torch, KERNELS, cfg, device="cpu", shapes=[(256, 512)])
    assert stats["nf4_nn"]["modules"] == 15 and len(stats["docstring"]) == 8
    assert all(k.launches == 0 for k in KERNELS)
    with pytest.raises(cs.SmokeFailure):
        cs.need_launches({"mm4_fused": 14}, {"mm4_fused": 15}, "wiring")
