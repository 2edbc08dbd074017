"""The port's LLM.int8 functions, kernel I (here its plain version on the
CPU), the int8 linears of the Llama model and the serving-time int8 repack
against the JAX package, whose fused kernel runs in interpret mode.

Tolerances: int8 codes, absmax statistics, outlier state and repacked
leaves are bit-identical; matmul outputs (f32) agree within F32_TOL: the
int32 sums are exact in both packages and the epilogues keep the same
order, but the fp sidecar is an f32 product summed in another order, and
the JAX model's default unfused route rounds its epilogue differently from
the fused route the port takes; bf16 outputs within one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_sycl_tpu.functional as JF
from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu.ops.matmul_int8 import int8_matmul_fused as j_fused
from bitsandbytes_sycl_tpu.utils import find_outlier_dims as j_outliers
from bitsandbytes_sycl_tpu_torch import functional as TF
from bitsandbytes_sycl_tpu_torch.convert import params_from_jax
from bitsandbytes_sycl_tpu_torch.models import llama as TL
from bitsandbytes_sycl_tpu_torch.ops.matmul_int8 import int8_matmul_fused as t_fused
from bitsandbytes_sycl_tpu_torch.utils import find_outlier_dims as t_outliers

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-6)
LOGIT_TOL = 5e-2
LOGIT_REL_L2 = 4e-2


def _weight(N, K, seed=0):
    return (np.random.default_rng(seed).normal(size=(N, K)) * 0.05).astype(np.float32)


def _acts(M, K, seed=1, outlier_col=7):
    A = np.random.default_rng(seed).normal(size=(M, K)).astype(np.float32)
    if outlier_col is not None:
        A[:, outlier_col] *= 20.0  # a systematic outlier dimension, |a| >> 6
    return A


def _int8_weight(N, K, seed=0):
    W = _weight(N, K, seed)
    CB, SCB = JF.int8_vectorwise_quant(jnp.asarray(W))
    return W, np.asarray(CB), np.asarray(SCB)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1])
def test_int8_vectorwise_quant_bit_identical(axis, dtype):
    A = _acts(64, 256, outlier_col=None)
    A[3] = 0.0
    A[:, 5] = 0.0
    ja = jnp.asarray(A, jnp.dtype(dtype))
    jc, js = JF.int8_vectorwise_quant(ja, axis=axis)
    tc, ts = TF.int8_vectorwise_quant(torch.from_numpy(np.asarray(ja, np.float32)).to(getattr(torch, dtype)),
                                      axis=axis)
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("threshold", [0.0, 6.0])
def test_get_colrow_absmax_matches(threshold):
    A = _acts(16, 256)
    want = JF.get_colrow_absmax(jnp.asarray(A), threshold)
    got = TF.get_colrow_absmax(torch.from_numpy(A), threshold)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("od", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("M", [1, 5, 128])
def test_mm8_plain_matches_jax_kernel(M, bias, od):
    _, CB, SCB = _int8_weight(256, 512)
    x = _acts(M, 512, outlier_col=None)
    x[0] = 0.0  # an all-zero row: inv = 127
    b = np.linspace(-1, 1, 256).astype(np.float32) if bias else None
    ra = np.abs(x).max(axis=1)
    want = j_fused(jnp.asarray(x), jnp.asarray(CB), jnp.asarray(SCB), jnp.asarray(ra),
                   bias=None if b is None else jnp.asarray(b), out_dtype=jnp.dtype(od))
    got = t_fused(torch.from_numpy(x), torch.from_numpy(CB), torch.from_numpy(SCB), torch.from_numpy(ra),
                  bias=None if b is None else torch.from_numpy(b), out_dtype=getattr(torch, od))
    assert got.dtype == getattr(torch, od) and got.shape == (M, 256)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(F32_TOL if od == "float32" else BF16_ULP))


def test_fused_declines_like_jax():
    _, CB, SCB = _int8_weight(256, 512)
    for M, N, K in ((256, 256, 512), (0, 256, 512), (4, 200, 512), (4, 256, 200)):
        x, cb, scb = np.ones((M, K), np.float32), np.ones((N, K), np.int8), np.ones((N,), np.float32)
        ra = np.ones((M,), np.float32)
        want = j_fused(jnp.asarray(x), jnp.asarray(cb), jnp.asarray(scb), jnp.asarray(ra))
        got = t_fused(*map(torch.from_numpy, (x, cb, scb, ra)))
        assert want is None and got is None


@pytest.mark.parametrize("M", [4, 128, 256])
@pytest.mark.parametrize("route", ["threshold0", "static", "dynamic"])
def test_llm_int8_matmul_matches_jax(route, M):
    W, CB, SCB = _int8_weight(256, 512, seed=2)
    A = _acts(M, 512, seed=3)
    bias = np.linspace(-0.5, 0.5, 256).astype(np.float32)
    kw = dict(threshold=0.0 if route == "threshold0" else 6.0)
    jkw, tkw = dict(kw), dict(kw)
    if route == "static":
        idx = np.asarray([7, 100, 300], np.int32)
        jkw["outliers"] = JF.llm_int8_prepare_outliers(jnp.asarray(CB), jnp.asarray(SCB), jnp.asarray(idx))
        tkw["outliers"] = TF.llm_int8_prepare_outliers(torch.from_numpy(CB), torch.from_numpy(SCB), idx)
        for k in ("idx", "keep", "subB"):
            np.testing.assert_array_equal(tkw["outliers"][k].numpy(), np.asarray(jkw["outliers"][k]))
    want = JF.llm_int8_matmul(jnp.asarray(A), jnp.asarray(CB), jnp.asarray(SCB), bias=jnp.asarray(bias),
                              use_fused=True, **jkw)
    got = TF.llm_int8_matmul(torch.from_numpy(A), torch.from_numpy(CB), torch.from_numpy(SCB),
                             bias=torch.from_numpy(bias), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # the outlier sidecar carries the outlier column: closer to the f32
    # product than without it
    ref = A @ (CB.astype(np.float32) * (SCB[:, None] / 127.0)).T + bias
    if route != "threshold0":
        plain = TF.llm_int8_matmul(torch.from_numpy(A), torch.from_numpy(CB), torch.from_numpy(SCB),
                                   threshold=0.0, bias=torch.from_numpy(bias)).numpy()
        assert np.abs(got.numpy() - ref).max() < 0.5 * np.abs(plain - ref).max()


def test_llm_int8_matmul_bf16_lead_dims():
    _, CB, SCB = _int8_weight(256, 512, seed=4)
    A = _acts(6, 512, seed=5).reshape(2, 3, 512)
    ja = jnp.asarray(A, jnp.bfloat16)
    ta = torch.from_numpy(np.asarray(ja, np.float32)).to(torch.bfloat16)
    for thr in (0.0, 6.0):
        want = JF.llm_int8_matmul(ja, jnp.asarray(CB), jnp.asarray(SCB), threshold=thr, use_fused=True)
        got = TF.llm_int8_matmul(ta, torch.from_numpy(CB), torch.from_numpy(SCB), threshold=thr)
        assert got.shape == (2, 3, 256) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_ULP)


def test_find_outlier_dims_index_sets():
    W = _weight(128, 256, seed=6)
    planted = [3, 50, 77, 200]
    W[:, planted] *= 10.0
    want = np.asarray(j_outliers(jnp.asarray(W), reduction_dim=0, topk=8))
    got = t_outliers(torch.from_numpy(W), reduction_dim=0, topk=8)
    assert got.dtype == torch.int32
    assert set(got.tolist()) == set(want.tolist()) and set(planted) <= set(got.tolist())
    np.testing.assert_array_equal(t_outliers(torch.from_numpy(W)).numpy(),
                                  np.asarray(j_outliers(jnp.asarray(W))))


def test_quantize_params_int8_matches_jax():
    cfg_kw = dict(quant="int8", num_layers=1)
    jc, tc = JL.LlamaConfig.tiny(**cfg_kw), TL.LlamaConfig.tiny(**cfg_kw)
    rng = np.random.default_rng(7)
    shapes = JL._fp_layer_shapes(jc)
    fp = {"embed": rng.normal(size=(256, 256)).astype(np.float32) * 0.02,
          "final_norm": np.ones((256,), np.float32),
          "lm_head": rng.normal(size=(256, 256)).astype(np.float32) * 0.02,
          "layers": [{n: (rng.normal(size=s) / np.sqrt(s[1])).astype(np.float32) for n, s in shapes.items()}]}
    want = JL.quantize_params(jax.tree.map(jnp.asarray, fp), jc)
    got = TL.quantize_params(jax.tree.map(torch.from_numpy, fp), tc)
    for name, w in [("lm_head", got["lm_head"])] + list(got["layers"][0].items()):
        if not isinstance(w, dict):
            continue
        jw = want["lm_head"] if name == "lm_head" else want["layers"][0][name]
        np.testing.assert_array_equal(w["CB"].numpy(), np.asarray(jw["CB"]))
        np.testing.assert_array_equal(w["SCB"].numpy(), np.asarray(jw["SCB"]))
        # the same outlier columns, as sets (top_k orders ties its own way)
        assert set(w["outliers"]["idx"].tolist()) == set(np.asarray(jw["outliers"]["idx"]).tolist())


@pytest.mark.parametrize("only", [None, ("gate_proj", "up_proj", "down_proj", "lm_head")])
def test_repack_params_int8_bit_identical(only):
    jc, tc = JL.LlamaConfig.tiny(), TL.LlamaConfig.tiny()
    jp = JL.init_params(jc, jax.random.PRNGKey(4))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    j8, jc8 = JL.repack_params_int8(jp, jc, only=None if only is None else set(only))
    t8, tc8 = TL.repack_params_int8(tp, tc, only=None if only is None else set(only))
    assert (tc8.quant, tc8.llm_int8_threshold) == (jc8.quant, jc8.llm_int8_threshold) == ("int8", 0.0)
    for name in ("lm_head", "q_proj", "down_proj"):
        jw = j8[name] if name == "lm_head" else j8["layers"][1][name]
        tw = t8[name] if name == "lm_head" else t8["layers"][1][name]
        if only is not None and name not in only:
            assert isinstance(tw, TL.QLinearWeight) and not isinstance(jw, dict)
            continue
        np.testing.assert_array_equal(tw["CB"].numpy(), np.asarray(jw["CB"]))
        np.testing.assert_array_equal(tw["SCB"].numpy(), np.asarray(jw["SCB"]))
    assert isinstance(tp["layers"][1]["q_proj"], TL.QLinearWeight)  # the input is not changed


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale, (np.abs(got - want).max(), scale)
    assert np.linalg.norm(got - want) <= LOGIT_REL_L2 * np.linalg.norm(want)


def test_int8_model_matches_jax():
    """The LLM.int8 Llama (threshold 6, the JAX package's outlier columns
    carried across by params_from_jax) without a cache, and one linear at
    decode and prefill rows through apply_linear."""
    shape = dict(hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
    jc, tc = JL.LlamaConfig.tiny(quant="int8", **shape), TL.LlamaConfig.tiny(quant="int8", **shape)
    jp = JL.init_params(jc, jax.random.PRNGKey(5))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    w = tp["layers"][0]["gate_proj"]
    assert w["CB"].dtype == torch.int8 and set(w["outliers"]) == {"idx", "keep", "subB"}
    toks = np.random.default_rng(8).integers(0, 256, (2, 32)).astype(np.int32)
    want, _ = JL.llama_forward(jp, jc, jnp.asarray(toks))
    got, _ = TL.llama_forward(tp, tc, torch.from_numpy(toks))
    _close_logits(got.numpy(), want)
    for rows in (4, 256):
        x = _acts(rows, 256, seed=rows)
        want = JL.apply_linear(jnp.asarray(x), jp["layers"][0]["gate_proj"], jc)
        got = TL.apply_linear(torch.from_numpy(x), w, tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
