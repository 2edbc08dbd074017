"""The port's 4-bit linears (kernels A and B, here their plain versions on
the CPU) against the JAX package's Pallas kernels in interpret mode, and
apply_linear's routing against the JAX package's. The long-prompt routes
(kernels E, F and G) have their own tests in test_torch_prefill_routes.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_sycl_tpu.models.llama as JL
import bitsandbytes_sycl_tpu.ops.matmul_w4a8 as JW
from bitsandbytes_sycl_tpu.ops import matmul_4bit_fused as j_fused
from bitsandbytes_sycl_tpu.ops import matmul_4bit_w4a8 as j_w4a8
from bitsandbytes_sycl_tpu.ops.common import quantize_4bit_native as j_quantize
from bitsandbytes_sycl_tpu_torch.models import llama as TL
from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit_fused as t_fused
from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit_w4a8 as t_w4a8
from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native as t_quantize

# f32 outputs: the port sums the same exact int32 block dots / f32 products
# in another order, so results agree to f32 rounding of the output scale
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 outputs: one bf16 ulp at the largest outputs (|y| < 4 here)
BF16_TOL = dict(rtol=1e-2, atol=2e-2)


def _pair(N, K, qt="nf4", bs=64, absmax="bfloat16", seed=0):
    W = (np.random.default_rng(seed).normal(size=(N, K)) * 0.02).astype(np.float32)
    a = j_quantize(jnp.asarray(W), blocksize=bs, quant_type=qt, absmax_dtype=jnp.dtype(absmax))
    b = t_quantize(torch.from_numpy(W), blocksize=bs, quant_type=qt, absmax_dtype=getattr(torch, absmax))
    return a, b


def _x(M, K, seed=1):
    return np.random.default_rng(seed).normal(size=(M, K)).astype(np.float32)


@pytest.mark.parametrize("absmax", ["float32", "bfloat16"])
@pytest.mark.parametrize("qt,K", [("nf4", 1024), ("nf4", 2048), ("fp4", 1024), ("af4", 1024)])
@pytest.mark.parametrize("M", [1, 5, 128])
def test_w4a8_matches_jax_kernel(M, qt, K, absmax):
    a, b = _pair(256, K, qt, absmax=absmax)
    x = _x(M, K)
    want = np.asarray(j_w4a8(jnp.asarray(x), a, out_dtype=jnp.float32))
    got = t_w4a8(torch.from_numpy(x), b, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_w4a8_bias_bf16_and_lead_dims():
    a, b = _pair(256, 1024)
    x = _x(6, 1024).reshape(2, 3, 1024)
    bias = np.arange(256, dtype=np.float32) * 0.01
    want = np.asarray(j_w4a8(jnp.asarray(x), a, bias=jnp.asarray(bias), out_dtype=jnp.bfloat16),
                      np.float32)
    got = t_w4a8(torch.from_numpy(x), b, bias=torch.from_numpy(bias), out_dtype=torch.bfloat16)
    assert got.shape == (2, 3, 256) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("qt", ["nf4", "fp4", "int4"])
@pytest.mark.parametrize("M", [1, 5, 128])
def test_fused_matches_jax_kernel(M, qt, cd):
    a, b = _pair(256, 1024, qt, absmax="float32" if qt == "int4" else "bfloat16")
    x = _x(M, 1024)
    want = np.asarray(j_fused(jnp.asarray(x), a, compute_dtype=jnp.dtype(cd)), np.float32)
    got = t_fused(torch.from_numpy(x), b, compute_dtype=getattr(torch, cd)).float().numpy()
    np.testing.assert_allclose(got, want, **(F32_TOL if cd == "float32" else BF16_TOL))


def test_whole_half_k_both_paths():
    """K whose half is not a multiple of 8 blocks takes the whole-half
    tile in the JAX kernels (llama down_proj class)."""
    K = 1152
    a, b = _pair(256, K, absmax="float32", seed=11)
    x = _x(8, K, seed=12)
    np.testing.assert_allclose(
        t_fused(torch.from_numpy(x), b, compute_dtype=torch.float32).numpy(),
        np.asarray(j_fused(jnp.asarray(x), a, compute_dtype=jnp.float32)), **F32_TOL)
    np.testing.assert_allclose(
        t_w4a8(torch.from_numpy(x), b, out_dtype=torch.float32).numpy(),
        np.asarray(j_w4a8(jnp.asarray(x), a, out_dtype=jnp.float32)), **F32_TOL)


def test_untileable_and_unported_routes():
    # N = 200 is untileable: both packages dequantize and matmul plainly,
    # and W4A8 hands such weights to the exact path
    a, b = _pair(200, 512)
    x = _x(4, 512)
    np.testing.assert_allclose(
        t_w4a8(torch.from_numpy(x), b, out_dtype=torch.float32).numpy(),
        np.asarray(j_w4a8(jnp.asarray(x), a, out_dtype=jnp.float32)), **F32_TOL)
    # large M decodes the weight once (kernel E) and runs one dense matmul,
    # from M = 2048, or from M = 256 for a whole-half K
    a, b = _pair(256, 1024)
    x = _x(2048, 1024)
    np.testing.assert_allclose(
        t_fused(torch.from_numpy(x), b, compute_dtype=torch.float32).numpy(),
        np.asarray(j_fused(jnp.asarray(x), a, compute_dtype=jnp.float32)), **F32_TOL)
    aw, bw = _pair(256, 1152)
    for M in (255, 256):
        x = _x(M, 1152)
        np.testing.assert_allclose(
            t_fused(torch.from_numpy(x), bw, compute_dtype=torch.float32).numpy(),
            np.asarray(j_fused(jnp.asarray(x), aw, compute_dtype=jnp.float32)), **F32_TOL)
    assert t_fused(torch.zeros((0, 1024)), b, compute_dtype=torch.float32).shape == (0, 256)


@pytest.mark.parametrize("bs", [64, 128, 256])
@pytest.mark.parametrize("qt,a8", [("nf4", True), ("int4", True), ("nf4", False)])
def test_apply_linear_routes_like_jax(monkeypatch, qt, a8, bs):
    """Every row-count threshold of apply_linear sends a weight down the
    same route as the JAX package; the first row count of the grouped and
    W8A8 routes gives the JAX package's output there."""
    seen = []
    jax_fn = {"grouped": JW.matmul_4bit_w4a8_grouped, "w8a8": JW.matmul_4bit_w8a8_prefill}
    for name, route in (("matmul_4bit_w4a8", "w4a8"), ("matmul_4bit_w4a8_grouped", "grouped"),
                        ("matmul_4bit_w8a8_prefill", "w8a8")):
        monkeypatch.setattr(JW, name, lambda *a, _r=route, **k: seen.append(_r))
    monkeypatch.setattr(JL, "matmul_4bit_fused", lambda *a, **k: seen.append("exact"))
    K = 2 * bs
    a, b = _pair(128, K, qt, bs=bs)
    jcfg = JL.LlamaConfig.tiny(a8_decode=a8, quant=qt, blocksize=bs)
    tcfg = TL.LlamaConfig.tiny(a8_decode=a8, quant=qt, blocksize=bs)
    for rows in (1, 64, 128, 129, 256, 257, 512, 4095, 4096):
        JL.apply_linear(jnp.zeros((rows, K), jnp.bfloat16), a, jcfg)
        route = TL.linear_route(rows, b, tcfg)
        assert route == seen[-1], (rows, route, seen[-1])
        if route in jax_fn:
            x = _x(rows, K, seed=rows)
            want = jax_fn.pop(route)(jnp.asarray(x, jnp.bfloat16), a, out_dtype=jnp.bfloat16)
            got = TL.apply_linear(torch.from_numpy(x).to(torch.bfloat16), b, tcfg)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)
    x = torch.zeros((4, 2, K), dtype=torch.bfloat16)  # rows count every lead dim
    assert TL.linear_route(int(np.prod(x.shape[:-1])), b, tcfg) == TL.linear_route(8, b, tcfg)
