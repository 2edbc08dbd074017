"""The port's long-prompt prefill routes against the JAX package on the CPU:
the dense dequantize (kernel E), the int8 regrid (kernel F), the grouped
W4A8 matmul (kernel G), the W8A8 and dequantize-once routes, and the Llama
forward and paged engine at the row counts that reach them, with chunked
prefill. The port runs its kernels' plain versions here, the JAX package
its Pallas kernels in interpret mode.

Tolerances:
- dequantize_transposed and dequantize_to_int8 are bit-identical, except
  where the JAX package decodes in XLA instead of its kernel (blocksize
  128 at f32 output, blocksize 256 at bf16): there int4 reads its table
  value, one f32 ulp from the kernels' arithmetic value (two ulps after
  the scale product), and a bf16 output
  rounds an f32 product once instead of a bf16 product, one bf16 ulp apart;
- the grouped and W8A8 routes sum exact int32 dots and keep the JAX
  epilogue's order: F32_TOL (measured: bit-identical);
- the dequantize-once route sums a dense f32 product in another order:
  F32_TOL, or a bf16 ulp of the output for bf16;
- logits of the tiny model within 5% of the largest and 4% relative L2,
  as in test_torch_llama_engine.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_sycl_tpu.ops.matmul_4bit as J4
import bitsandbytes_sycl_tpu.ops.matmul_w4a8 as JW
from bitsandbytes_sycl_tpu.engine import EngineConfig as JEngineConfig
from bitsandbytes_sycl_tpu.engine import InferenceEngine as JEngine
from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu.ops.common import quantize_4bit_native as j_quantize
from bitsandbytes_sycl_tpu_torch import ops as T
from bitsandbytes_sycl_tpu_torch.convert import params_from_jax
from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
from bitsandbytes_sycl_tpu_torch.models import llama as TL
from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native as t_quantize

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=2e-2)
LOGIT_TOL = 5e-2  # of the largest |logit|
LOGIT_REL_L2 = 4e-2
# 2 x 256 = 512 rows reach the grouped kernel (blocksize 64); the weights'
# half-K (256, 576) is not a multiple of 8 blocks, as llama-7B's down_proj
SHAPE = dict(hidden_size=512, intermediate_size=1152, num_heads=4, num_kv_heads=2,
             head_dim=128, max_seq_len=512)


def _pair(N, K, qt="nf4", bs=64, absmax="bfloat16", seed=0):
    W = (np.random.default_rng(seed).normal(size=(N, K)) * 0.02).astype(np.float32)
    a = j_quantize(jnp.asarray(W), blocksize=bs, quant_type=qt, absmax_dtype=jnp.dtype(absmax))
    b = t_quantize(torch.from_numpy(W), blocksize=bs, quant_type=qt, absmax_dtype=getattr(torch, absmax))
    return a, b


def _x(M, K, seed=1):
    return np.random.default_rng(seed).normal(size=(M, K)).astype(np.float32)


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale, (np.abs(got - want).max(), scale)
    assert np.linalg.norm(got - want) <= LOGIT_REL_L2 * np.linalg.norm(want)


# ------------------------------------------------------------ kernel E


CASES_E = [(qt, bs, K) for qt in ("nf4", "fp4", "int4") for bs, K in
           ((64, 1024), (64, 1152), (128, 1024), (128, 1280))] + [("af4", 64, 1024), ("af4", 64, 1152)]


@pytest.mark.parametrize("od", ["bfloat16", "float32"])
@pytest.mark.parametrize("qt,bs,K", CASES_E)
def test_dequantize_transposed_bit_identical(qt, bs, K, od):
    a, b = _pair(256, K, qt, bs, absmax="float32" if qt == "int4" else "bfloat16", seed=K + bs)
    want = np.asarray(J4.dequantize_transposed(a, jnp.dtype(od)), np.float32)
    got = T.dequantize_transposed(b, getattr(torch, od))
    assert got.shape == (K, 256) and got.dtype == getattr(torch, od)
    got = got.float().numpy()
    if qt == "int4" and od == "float32" and bs == 128:
        # the JAX package decodes this shape in XLA from int4's table value:
        # one ulp of the decoded value, then the scale product's rounding
        np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qt", ["nf4", "int4"])
def test_dequantize_transposed_xla_shapes_within_one_rounding(qt):
    """Blocksize 256 at bf16: the JAX package rounds an f32 product once,
    kernel E a bf16 product; they meet within one bf16 ulp (2^-7 of the
    value at most)."""
    a, b = _pair(256, 1024, qt, 256)
    want = np.asarray(J4.dequantize_transposed(a, jnp.bfloat16), np.float32)
    got = T.dequantize_transposed(b, torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


# ------------------------------------------------------------ kernel F


CASES_F = [(qt, bs, K) for qt in ("nf4", "fp4", "int4") for bs, K in
           ((64, 1024), (64, 1152), (128, 1280))] + [("af4", 64, 1152)]


@pytest.mark.parametrize("absmax", ["float32", "bfloat16"])
@pytest.mark.parametrize("qt,bs,K", CASES_F)
def test_dequantize_to_int8_bit_identical(qt, bs, K, absmax):
    a, b = _pair(384, K, qt, bs, absmax=absmax, seed=K)
    wq_j, cm_j = JW.dequantize_to_int8(a)
    wq_t, cm_t = T.dequantize_to_int8(b)
    assert wq_t.shape == (K, 384) and wq_t.dtype == torch.int8
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(cm_t.numpy(), np.asarray(cm_j))


def test_dequantize_to_int8_declines_like_jax():
    """(None, None) where the JAX kernel declines: an untileable N, blocksize
    256, and a K that padding to 8 blocks would more than double."""
    for N, K, bs in ((200, 512, 64), (256, 1024, 256), (256, 256, 64), (256, 1024, 64)):
        a, b = _pair(N, K, bs=bs)
        want = JW.dequantize_to_int8(a)[0] is None
        assert (T.dequantize_to_int8(b)[0] is None) == want
    assert want is False


# ------------------------------------------------------------ kernel G


@pytest.mark.parametrize("od", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [64, 128])
@pytest.mark.parametrize("M", [257, 512, 1000])
def test_grouped_matches_jax(M, bs, od):
    a, b = _pair(256, 1024, bs=bs, seed=M)
    x = _x(M, 1024, seed=M + 1)
    bias = np.random.default_rng(2).normal(size=(256,)).astype(np.float32)
    want = np.asarray(JW.matmul_4bit_w4a8_grouped(jnp.asarray(x), a, jnp.asarray(bias),
                                                  out_dtype=jnp.dtype(od)), np.float32)
    got = T.matmul_4bit_w4a8_grouped(torch.from_numpy(x), b, torch.from_numpy(bias),
                                     out_dtype=getattr(torch, od))
    assert got.dtype == getattr(torch, od)
    np.testing.assert_allclose(got.float().numpy(), want, **(F32_TOL if od == "float32" else BF16_TOL))


def test_grouped_whole_half_lead_dims_and_fallback():
    a, b = _pair(256, 1152, qt="int4", absmax="float32", seed=5)
    x = _x(300, 1152, seed=6).reshape(3, 100, 1152)
    want = np.asarray(JW.matmul_4bit_w4a8_grouped(jnp.asarray(x), a, out_dtype=jnp.float32))
    got = T.matmul_4bit_w4a8_grouped(torch.from_numpy(x), b, out_dtype=torch.float32, tm=512)
    assert got.shape == (3, 100, 256)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # N = 200 is untileable: both packages take matmul_4bit_fused
    a, b = _pair(200, 512)
    x = _x(300, 512)
    np.testing.assert_allclose(
        T.matmul_4bit_w4a8_grouped(torch.from_numpy(x), b, out_dtype=torch.float32).numpy(),
        np.asarray(JW.matmul_4bit_w4a8_grouped(jnp.asarray(x), a, out_dtype=jnp.float32)), **F32_TOL)


def test_grouped_ragged_plane_step_matches_jax(monkeypatch):
    """Blocksize 32 with half-K 544: the JAX kernel takes the whole half as
    one K step, kernel G steps 64 rows and masks each plane's last step.
    Both packages take the grouped route here, not the fallback."""
    from bitsandbytes_sycl_tpu_torch.ops import matmul_w4a8 as TW

    a, b = _pair(256, 1088, bs=32, seed=11)
    x = _x(300, 1088, seed=12)
    bias = np.random.default_rng(13).normal(size=(256,)).astype(np.float32)
    calls = []
    plain = TW._grouped_plain
    monkeypatch.setattr(TW, "_grouped_plain", lambda *args: (calls.append(1), plain(*args))[1])
    want = np.asarray(JW.matmul_4bit_w4a8_grouped(jnp.asarray(x), a, jnp.asarray(bias),
                                                  out_dtype=jnp.float32))
    got = T.matmul_4bit_w4a8_grouped(torch.from_numpy(x), b, torch.from_numpy(bias),
                                     out_dtype=torch.float32)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


# ------------------------------------------------------------ W8A8 and dequantize-once


@pytest.mark.parametrize("qt,K", [("nf4", 1152), ("int4", 1024)])
def test_w8a8_prefill_matches_jax(qt, K):
    a, b = _pair(256, K, qt, seed=7)
    x = _x(4096, K, seed=8)
    bias = np.linspace(-1, 1, 256, dtype=np.float32)
    want = np.asarray(JW.matmul_4bit_w8a8_prefill(jnp.asarray(x), a, jnp.asarray(bias),
                                                  out_dtype=jnp.float32))
    got = T.matmul_4bit_w8a8_prefill(torch.from_numpy(x), b, torch.from_numpy(bias),
                                     out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    # a declined shape (blocksize 256) takes matmul_4bit_fused in both
    a, b = _pair(256, 1024, qt, 256, seed=9)
    x = _x(64, 1024)
    np.testing.assert_allclose(
        T.matmul_4bit_w8a8_prefill(torch.from_numpy(x), b, out_dtype=torch.float32).numpy(),
        np.asarray(JW.matmul_4bit_w8a8_prefill(jnp.asarray(x), a, out_dtype=jnp.float32)), **F32_TOL)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K", [(2048, 1024), (256, 1152)])
def test_fused_dequantize_once_route_matches_jax(M, K, cd):
    """From 2048 rows, or 256 when half-K is not a multiple of 8 blocks,
    matmul_4bit_fused decodes the weight once (kernel E) and runs one dense
    matmul in both packages."""
    a, b = _pair(256, K, seed=M)
    x = _x(M, K, seed=K)
    bias = np.linspace(0, 1, 256, dtype=np.float32)
    want = np.asarray(J4.matmul_4bit_fused(jnp.asarray(x), a, jnp.asarray(bias),
                                           compute_dtype=jnp.dtype(cd)), np.float32)
    got = T.matmul_4bit_fused(torch.from_numpy(x), b, torch.from_numpy(bias),
                              compute_dtype=getattr(torch, cd)).float().numpy()
    np.testing.assert_allclose(got, want, **(F32_TOL if cd == "float32" else BF16_TOL))


@pytest.mark.parametrize("rows,route", [(256, "exact"), (512, "grouped"), (4096, "w8a8")])
def test_apply_linear_long_rows_match_jax(rows, route):
    """apply_linear at the row counts of long prompts, llama-7B's blocksize."""
    jc, tc = JL.LlamaConfig.tiny(), TL.LlamaConfig.tiny()
    a, b = _pair(384, 1152, seed=rows)
    assert TL.linear_route(rows, b, tc) == route
    x = _x(rows, 1152, seed=3)
    want = np.asarray(JL.apply_linear(jnp.asarray(x, jnp.bfloat16), a, jc), np.float32)
    got = TL.apply_linear(torch.from_numpy(x).to(torch.bfloat16), b, tc).float().numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL)


# ------------------------------------------------------------ model and engine


@pytest.fixture(scope="module")
def model():
    jc, tc = JL.LlamaConfig.tiny(**SHAPE), TL.LlamaConfig.tiny(**SHAPE)
    jp = JL.init_params(jc, jax.random.PRNGKey(3))
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


@pytest.mark.parametrize("B,T_", [(1, 256), (2, 256), (8, 512)])
def test_prefill_logits_at_long_rows_match_jax(model, B, T_):
    """Rows 256 (dequantize-once), 512 (grouped) and 4096 (W8A8)."""
    jc, tc, jp, tp = model
    toks = np.random.default_rng(B).integers(0, 256, (B, T_)).astype(np.int32)
    want, _ = JL.llama_forward(jp, jc, jnp.asarray(toks))
    got, _ = TL.llama_forward(tp, tc, torch.from_numpy(toks))
    _close_logits(got.numpy(), want)


def _jax_engine_logging(jc, jp, ecfg, log):
    """The JAX paged engine with its prefill, chunk-prefill and decode
    functions rebuilt from the same llama_forward, logging their logits."""
    eng = JEngine(jc, jp, ecfg)
    fwd = jax.jit(JL.llama_forward, static_argnums=1)

    def prefill(params, tokens, true_len, key, ids):
        K, T_ = tokens.shape
        pos = jnp.broadcast_to(jnp.arange(T_), (K, T_))
        logits, cacheK = fwd(params, jc, tokens, JL.init_kv_cache(jc, K), pos)
        last = jnp.take_along_axis(logits, (true_len - 1).reshape(K, 1, 1), axis=1)[:, 0]
        log.append(np.asarray(last))
        return jnp.argmax(last, -1).astype(jnp.int32), cacheK

    def chunk_prefill(params, tokens_c, off, cacheK, true_len, key, ids):
        K, C = tokens_c.shape
        pos = off + jnp.broadcast_to(jnp.arange(C), (K, C))
        logits, cacheK = fwd(params, jc, tokens_c, cacheK, pos)
        idx = jnp.clip(true_len - 1 - off, 0, C - 1)
        last = jnp.take_along_axis(logits, idx.reshape(K, 1, 1), axis=1)[:, 0]
        hit = (true_len - 1 >= off) & (true_len - 1 < off + C)
        if bool(np.asarray(hit).any()):
            log.append((np.asarray(hit), np.asarray(last)))
        return jnp.argmax(last, -1).astype(jnp.int32), hit, cacheK

    def decode_step(params, pool, page_table, write_page, write_off, tokens, positions, key, ids,
                    pages_hint):
        cache = dict(pool, page_table=page_table, write_page=write_page, write_off=write_off)
        logits, cache = fwd(params, dataclasses.replace(jc, pages_hint=pages_hint), tokens, cache,
                            positions)
        log.append(np.asarray(logits[:, 0]))
        return jnp.argmax(logits[:, 0], -1).astype(jnp.int32), {k: cache[k] for k in pool}

    eng._prefill = prefill
    eng._chunk_prefill = chunk_prefill
    eng._paged_decode = decode_step
    return eng


def _logging_engine(tc, tp, ecfg, log):
    eng = InferenceEngine(tc, tp, ecfg, device="cpu")
    sample = eng._sample
    eng._sample = lambda logits: (log.append(logits.numpy().copy()), sample(logits))[1]
    return eng


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).tolist() for n in lengths]


def _teacher_forced(je, te, steps):
    for _ in range(steps):
        te._last_tokens = je._last_tokens.copy()
        je.step()
        te.step()


def test_long_prompt_paged_engine_matches_jax(model):
    """Two prompts of 129-256 tokens: one 512-row prefill through the
    grouped route, then decode steps through the pool."""
    jc, tc, jp, tp = model
    jlog, tlog = [], []
    prompts = _prompts([150, 201], seed=4)
    je = _jax_engine_logging(jc, jp, JEngineConfig(max_batch=2, paged=True), jlog)
    te = _logging_engine(tc, tp, EngineConfig(max_batch=2, paged=True), tlog)
    je.add_requests(prompts)
    te.add_requests(prompts)
    assert je._alloc.tables == te._alloc.tables
    _teacher_forced(je, te, 2)
    assert len(tlog) == len(jlog) == 3
    for got, want in zip(tlog, jlog):
        _close_logits(got, want)
    assert [len(t) for t in te.slot_tokens] == [153, 204]


def test_chunked_prefill_matches_jax(model):
    """prefill_chunk=128 on prompts of 300 and 200 tokens (4 chunks of
    256 rows, the last prompt token in chunks 3 and 2) against the JAX
    engine's chunked prefill, then two decode steps from the pool."""
    jc, tc, jp, tp = model
    jlog, tlog = [], []
    prompts = _prompts([300, 200], seed=5)
    ecfg = dict(max_batch=2, paged=True, prefill_chunk=128)
    je = _jax_engine_logging(jc, jp, JEngineConfig(**ecfg), jlog)
    te = _logging_engine(tc, tp, EngineConfig(**ecfg), tlog)
    je.add_requests(prompts)
    te.add_requests(prompts)
    # the JAX engine logged (hit, last) for each chunk holding a last token
    want = np.zeros_like(jlog[0][1])
    for hit, last in jlog[:2]:
        want[hit] = last[hit]
    assert [h.tolist() for h, _ in jlog[:2]] == [[False, True], [True, False]]
    _close_logits(tlog[0], want)
    _teacher_forced(je, te, 2)
    assert len(tlog) == 3 and len(jlog) == 4
    for got, want in zip(tlog[1:], jlog[2:]):
        _close_logits(got, want)
    assert [len(t) for t in te.slot_tokens] == [303, 203]
