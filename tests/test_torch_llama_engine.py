"""The port's Llama forward and paged engine against the JAX package on a
tiny config whose head_dim = page = 128 keeps the kernels' shapes (their
plain versions run here), with the JAX package's own weights converted by
params_from_jax.

Logit tolerance: without a cache both packages give bit-identical logits
here. With the int8 cache the JAX package attends (on the CPU) over keys
and values dequantized to bf16, the port in f32 as the kernels do; the
attention outputs then round to bf16 differently in a few elements, and
W4A8 requantizes every activation row after that. Two layers deep, this
moves single logits by up to ~3% of the largest and the whole by ~3% in
relative L2 (measured: 3.2% and 3.1% with W4A8, 1.2% and 1.1% without).
So logits agree within 5% of the largest logit and 4% in relative L2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu.engine import EngineConfig as JEngineConfig
from bitsandbytes_sycl_tpu.engine import InferenceEngine as JEngine
from bitsandbytes_sycl_tpu.engine.paged import init_page_pool as j_pool
from bitsandbytes_sycl_tpu.engine.paged import paged_ingest as j_ingest
from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu_torch.convert import params_from_jax
from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
from bitsandbytes_sycl_tpu_torch.engine.paged import init_page_pool as t_pool
from bitsandbytes_sycl_tpu_torch.engine.paged import paged_ingest as t_ingest
from bitsandbytes_sycl_tpu_torch.models import llama as TL

LOGIT_TOL = 5e-2  # of the largest |logit|
LOGIT_REL_L2 = 4e-2
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5, 4, 3, 2, 1]]


def _cfgs(**kw):
    shape = dict(hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
    return JL.LlamaConfig.tiny(**shape, **kw), TL.LlamaConfig.tiny(**shape, **kw)


@pytest.fixture(scope="module")
def models():
    out = {}
    for a8 in (True, False):
        jc, tc = _cfgs(a8_decode=a8)
        jp = JL.init_params(jc, jax.random.PRNGKey(0))
        out[a8] = (jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu"))
    return out


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale, (np.abs(got - want).max(), scale)
    assert np.linalg.norm(got - want) <= LOGIT_REL_L2 * np.linalg.norm(want)


def test_config_fields_match():
    jf = [f.name for f in dataclasses.fields(JL.LlamaConfig)]
    tf = [f.name for f in dataclasses.fields(TL.LlamaConfig)]
    assert jf == tf
    for ctor in ("tiny", "llama7b", "serving7b"):
        j, t = getattr(JL.LlamaConfig, ctor)(), getattr(TL.LlamaConfig, ctor)()
        assert all(getattr(j, n) == getattr(t, n) for n in jf if n != "dtype")
    assert TL.LlamaConfig.llama7b().dtype == torch.bfloat16
    assert TL._fp_layer_shapes(TL.LlamaConfig.llama7b()) == JL._fp_layer_shapes(JL.LlamaConfig.llama7b())


@pytest.mark.parametrize("a8", [True, False])
def test_prefill_logits_match_jax(models, a8):
    jc, tc, jp, tp = models[a8]
    toks = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    want, jcache = JL.llama_forward(jp, jc, jnp.asarray(toks), JL.init_kv_cache(jc, 2))
    got, tcache = TL.llama_forward(tp, tc, torch.from_numpy(toks), TL.init_kv_cache(tc, 2, "cpu"))
    _close_logits(got.numpy(), want)
    # layer 0's cache depends on no attention: codes within one step
    for k in ("k", "v"):
        d = np.abs(np.asarray(jcache[k][0], np.int32) - tcache[k][0].numpy().astype(np.int32))
        assert d.max() <= 1
    # no cache: the same attention code in both packages
    want, _ = JL.llama_forward(jp, jc, jnp.asarray(toks))
    got, _ = TL.llama_forward(tp, tc, torch.from_numpy(toks))
    _close_logits(got.numpy(), want)


def test_kv_quantize_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 3, 4, 128)).astype(np.float32)
    x[0, 1, 2] = 0.0
    jq, js = JL._kv_quantize(jnp.asarray(x))
    tq, ts = TL._kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


def test_paged_ingest_bytes_identical():
    """The same contiguous scratch cache paginates into identical pools."""
    jc, tc = _cfgs()
    rng = np.random.default_rng(6)
    L, K, H, D, S = jc.num_layers, 3, jc.num_kv_heads, jc.hd, jc.max_seq_len
    scratch = {
        "k": rng.integers(-127, 128, (L, K, H, D, S)).astype(np.int8),
        "v": rng.integers(-127, 128, (L, K, H, S, D)).astype(np.int8),
        "k_scale": rng.uniform(0, 1, (L, K, H, S)).astype(np.float32),
        "v_scale": rng.uniform(0, 1, (L, K, H, S)).astype(np.float32),
    }
    page_ids = np.asarray([[3, 1], [2, 0], [5, 6]], np.int32)
    used, valid = np.asarray([2, 1, 2], np.int32), np.asarray([True, True, False])
    jp = j_ingest(j_pool(jc, 7, 128), {k: jnp.asarray(v) for k, v in scratch.items()},
                  jnp.asarray(page_ids), jnp.asarray(used), jnp.asarray(valid))
    tp = t_ingest(t_pool(tc, 7, 128, "cpu"), {k: torch.from_numpy(v) for k, v in scratch.items()},
                  page_ids, used, valid)
    for k in jp:
        for page in range(7):
            np.testing.assert_array_equal(np.asarray(jp[k][:, page]), tp[k][:, page].numpy())


def _jax_engine_with_logits(jc, jp, ecfg, log):
    """The JAX paged engine with its prefill and decode functions rebuilt
    from the same llama_forward so that they also report their logits."""
    eng = JEngine(jc, jp, ecfg)

    @jax.jit
    def prefill(params, tokens, true_len, key, ids):
        K, T = tokens.shape
        pos = jnp.broadcast_to(jnp.arange(T), (K, T))
        logits, cacheK = JL.llama_forward(params, jc, tokens, JL.init_kv_cache(jc, K), pos)
        last = jnp.take_along_axis(logits, (true_len - 1).reshape(K, 1, 1), axis=1)[:, 0]
        return jnp.argmax(last, -1).astype(jnp.int32), cacheK, last

    def decode_step(params, pool, page_table, write_page, write_off, tokens, positions, key, ids,
                    pages_hint):
        cache = dict(pool, page_table=page_table, write_page=write_page, write_off=write_off)
        cfg = dataclasses.replace(jc, pages_hint=pages_hint)
        logits, cache = jax.jit(JL.llama_forward, static_argnums=1)(params, cfg, tokens, cache,
                                                                     positions)
        log.append(np.asarray(logits[:, 0]))
        return jnp.argmax(logits[:, 0], -1).astype(jnp.int32), {k: cache[k] for k in pool}

    def prefill_logged(*args):
        tok, cacheK, last = prefill(*args)
        log.append(np.asarray(last))
        return tok, cacheK

    eng._prefill = prefill_logged
    eng._paged_decode = decode_step
    return eng


@pytest.mark.parametrize("a8", [True, False])
def test_paged_engine_matches_jax(models, a8):
    jc, tc, jp, tp = models[a8]
    jlog, tlog = [], []
    je = _jax_engine_with_logits(jc, jp, JEngineConfig(max_batch=2, paged=True), jlog)
    te = InferenceEngine(tc, tp, EngineConfig(max_batch=2, paged=True), device="cpu")
    sample = te._sample
    te._sample = lambda logits: (tlog.append(logits.numpy().copy()), sample(logits))[1]
    je.add_requests(PROMPTS)
    te.add_requests(PROMPTS)
    assert je._alloc.tables == te._alloc.tables  # same page ids
    for _ in range(3):
        # teacher-forced: both engines see the same tokens
        te._last_tokens = je._last_tokens.copy()
        je.step()
        te.step()
    for call in range(4):
        _close_logits(tlog[call], jlog[call])
    assert je._alloc.tables == te._alloc.tables
    for slot, p in enumerate(PROMPTS):
        n = len(p) + 3
        pages = je._alloc.tables[slot]
        for key in ("k", "v", "k_scale", "v_scale"):
            a = np.concatenate([np.asarray(je.cache[key][:, pg]) for pg in pages], axis=2)
            b = np.concatenate([te.cache[key][:, pg].numpy() for pg in pages], axis=2)
            a, b = a[:, :, :n], b[:, :, :n]
            if key in ("k", "v"):
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert d[0].max() <= 1  # layer 0: no attention upstream
                assert d.mean() < 0.5 and d.max() <= 8, (d.mean(), d.max())
            else:  # absmax of bf16 rows: layer 0 within a bf16 ulp, all within 5%
                np.testing.assert_allclose(b[0], a[0], rtol=2 ** -7)
                np.testing.assert_allclose(b, a, rtol=LOGIT_TOL)
    # retiring everything returns every page but the trash page
    for b in range(2):
        te.active[b] = False
        te._alloc.release_slot(b)
    assert te._alloc.free_pages() == te._alloc.num_pages - 1


@pytest.mark.parametrize("a8", [True, False])
def test_greedy_tokens_match_jax_where_the_gap_is_clear(models, a8):
    """Free-running greedy decode: each row's tokens equal the JAX engine's
    until a step where JAX's top-2 logit gap is within the tolerance."""
    jc, tc, jp, tp = models[a8]
    jlog = []
    je = _jax_engine_with_logits(jc, jp, JEngineConfig(max_batch=2, paged=True), jlog)
    te = InferenceEngine(tc, tp, EngineConfig(max_batch=2, paged=True), device="cpu")
    steps = 6
    je.add_requests(PROMPTS, max_new_tokens=steps)
    te.add_requests(PROMPTS, max_new_tokens=steps)
    for _ in range(steps - 1):
        je.step()
        te.step()
    compared = 0
    for row, p in enumerate(PROMPTS):
        jt, tt = je.slot_tokens[row][len(p):], te.slot_tokens[row][len(p):]
        assert len(jt) == len(tt) == steps
        for i in range(steps):
            logits = jlog[i][row]
            top2 = np.sort(logits)[-2:]
            if jt[i] != tt[i]:
                assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(logits).max(), (row, i)
                break
            compared += 1
    assert compared >= steps  # at least one row agrees all the way here


def test_engine_generate_and_unported_options(models):
    jc, tc, jp, tp = models[True]
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
    eng = InferenceEngine(tc, tp, EngineConfig(max_batch=2, paged=True, num_pages=5), device="cpu")
    outs = eng.generate(prompts, max_new_tokens=4)  # slots refill; pages are reused
    assert [len(o) for o in outs] == [4, 4, 4, 4]
    assert eng._alloc.free_pages() == 4
    t_eng = InferenceEngine(tc, tp, EngineConfig(max_batch=2, paged=True, temperature=0.8, top_k=5),
                            device="cpu")
    assert all(0 <= t < 256 for o in t_eng.generate(prompts[:2], max_new_tokens=3) for t in o)
    # the bf16 cache has no kernel yet, in either mode (the paged pool
    # never takes it)
    with pytest.raises(NotImplementedError):
        InferenceEngine(dataclasses.replace(tc, kv_quant=False), tp, EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="kv_quant"):
        InferenceEngine(dataclasses.replace(tc, kv_quant=False), tp, EngineConfig(paged=True),
                        device="cpu")
    # chunked prefill (chunks of 8 tokens at absolute offsets) gives the
    # JAX engine's chunked prefill logits for each prompt's next token
    jlog, tlog = [], []
    je = _jax_engine_with_logits(jc, jp, JEngineConfig(max_batch=2, paged=True, prefill_chunk=8),
                                 jlog)
    chunk_prefill = je._chunk_prefill

    def chunk_logged(params, tokens_c, off, cacheK, true_len, key, ids):
        K, C = tokens_c.shape
        pos = off + jnp.broadcast_to(jnp.arange(C), (K, C))
        logits, _ = JL.llama_forward(params, jc, tokens_c, cacheK, pos)
        idx = np.clip(np.asarray(true_len) - 1 - int(off), 0, C - 1)
        jlog.append(np.asarray(logits)[np.arange(K), idx])
        return chunk_prefill(params, tokens_c, off, cacheK, true_len, key, ids)

    je._chunk_prefill = chunk_logged
    c_eng = InferenceEngine(tc, tp, EngineConfig(max_batch=2, paged=True, prefill_chunk=8),
                            device="cpu")
    sample = c_eng._sample
    c_eng._sample = lambda logits: (tlog.append(logits.numpy().copy()), sample(logits))[1]
    long_prompts = [list(range(1, 21)), list(range(30, 41))]  # last tokens in chunks 3 and 2
    je.add_requests(long_prompts)
    c_eng.add_requests(long_prompts)
    want = np.stack([jlog[2][0], jlog[1][1]])
    _close_logits(tlog[0], want)
    assert c_eng.slot_tokens[0][-1] == je.slot_tokens[0][-1]
    with pytest.raises(NotImplementedError):
        eng.register_prefix([1, 2, 3])
    with pytest.raises(NotImplementedError):
        eng.snapshot()
    with pytest.raises(ValueError, match="page_size"):
        InferenceEngine(dataclasses.replace(tc, max_seq_len=200), tp,
                        EngineConfig(paged=True), device="cpu")
