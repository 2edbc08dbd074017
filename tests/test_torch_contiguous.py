"""The port's contiguous int8-KV decode (kernel H, here its plain version on
the CPU) and the engine's default contiguous mode against the JAX package,
whose Pallas kernels run in interpret mode (``_use_fused_decode_attn``
patched to True, as on a TPU).

Tolerances:
- kernel H: f32 outputs of a one-shot softmax over the same f32 scores in
  both packages, TOL = 2e-5;
- engines: logits within 5% of the largest and 4% relative L2, as in
  test_torch_llama_engine.py (last-bit differences, a KV code one step
  apart or a bf16 rounding, are amplified by this random tiny model, most
  by the per-row requantization of every activation in W4A8 and LLM.int8);
  free-running greedy tokens equal until a step where the JAX engine's
  top-2 logit gap is within that 5%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu.engine import EngineConfig as JEngineConfig
from bitsandbytes_sycl_tpu.engine import InferenceEngine as JEngine
from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu.ops.attention import decode_attention_int8 as j_decode1
from bitsandbytes_sycl_tpu.ops.attention import decode_attention_int8_stacked as j_decode
from bitsandbytes_sycl_tpu_torch.convert import params_from_jax
from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
from bitsandbytes_sycl_tpu_torch.models import llama as TL
from bitsandbytes_sycl_tpu_torch.ops.attention import decode_attention_int8 as t_decode1
from bitsandbytes_sycl_tpu_torch.ops.attention import decode_attention_int8_stacked as t_decode

TOL = dict(rtol=2e-5, atol=2e-5)
SLOPES = np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32)
LOGIT_TOL = 5e-2  # of the largest |logit|
LOGIT_REL_L2 = 4e-2
SHAPE = dict(hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5, 4, 3, 2, 1]]


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.asarray(a)) for a in arrays]


def _cache(rng, Lyr, B, Hkv, S, D):
    kq = rng.integers(-127, 128, (Lyr, B, Hkv, D, S)).astype(np.int8)
    vq = rng.integers(-127, 128, (Lyr, B, Hkv, S, D)).astype(np.int8)
    # k scales in [1, 3) give O(1) scores (q ~ N(0, 1), codes uniform in +-127)
    ks = rng.uniform(1.0, 3.0, (Lyr, B, Hkv, S)).astype(np.float32)
    vs = rng.uniform(0.5, 2.0, (Lyr, B, Hkv, S)).astype(np.float32)
    return kq, ks, vq, vs


def _new_kv(rng, B, Hkv, D):
    return (rng.integers(-127, 128, (B, Hkv, D)).astype(np.int8),
            rng.uniform(1.0, 3.0, (B, Hkv)).astype(np.float32),
            rng.integers(-127, 128, (B, Hkv, D)).astype(np.int8),
            rng.uniform(0.5, 2.0, (B, Hkv)).astype(np.float32))


# ------------------------------------------------------------ kernel H


@pytest.mark.parametrize("opt", [
    dict(), dict(window=100), dict(softcap=5.0), dict(alibi=True), dict(sm_scale=0.05),
])
@pytest.mark.parametrize("new", [False, True])
@pytest.mark.parametrize("gqa", [1, 2])
def test_decode_matches_jax_kernel(gqa, new, opt):
    opt = dict(opt)
    rng = np.random.default_rng(30 + gqa)
    Lyr, B, Hkv, D, S = 2, 3, 2, 128, 256
    q = rng.normal(size=(B, 1, Hkv * gqa, D)).astype(np.float32)
    lengths = np.asarray([256, 0, 130], np.int32)  # a full cache, len == 0, a ragged row
    alibi = SLOPES[: Hkv * gqa] if opt.pop("alibi", False) else None
    (jq, *jc, jl), (tq, *tc, tl) = _both(q, *_cache(rng, Lyr, B, Hkv, S, D), lengths)
    jn, tn = _both(*_new_kv(rng, B, Hkv, D)) if new else (None, None)
    for li in range(Lyr):  # layer select
        want = j_decode(jq, *jc, li, jl, new_kv=jn,
                        alibi_slopes=None if alibi is None else jnp.asarray(alibi), **opt)
        got = t_decode(tq, *tc, li, tl, new_kv=tn,
                       alibi_slopes=None if alibi is None else torch.from_numpy(alibi), **opt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        if not new:
            assert not got[1].any()  # len == 0 without new_kv: zeros


def test_decode_single_layer_bf16_and_declines():
    rng = np.random.default_rng(33)
    kq, ks, vq, vs = (a[0] for a in _cache(rng, 1, 2, 1, 128, 128))
    q = rng.normal(size=(2, 1, 2, 128)).astype(np.float32)
    lengths = np.asarray([128, 17], np.int32)
    want = j_decode1(jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, (kq, ks, vq, vs, lengths)))
    got = t_decode1(torch.from_numpy(q).to(torch.bfloat16), *map(torch.from_numpy, (kq, ks, vq, vs, lengths)))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, 2, 128)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)
    # the shapes the JAX kernel declines (JAX then attends without it) raise
    lens = jnp.asarray(lengths)
    for qs, cs in (((2, 2, 2, 128), (128, 128)), ((2, 1, 2, 64), (64, 128)), ((2, 1, 2, 128), (128, 96))):
        D, S = cs
        c = [a[0] for a in _cache(rng, 1, 2, 1, S, D)]
        assert j_decode1(jnp.zeros(qs), *map(jnp.asarray, c), lens) is None
        with pytest.raises(ValueError, match="does not take"):
            t_decode1(torch.zeros(qs), *map(torch.from_numpy, c), torch.from_numpy(lengths))


def test_decode_new_kv_equals_write_then_read():
    """Folding this step's token in last equals writing it at position
    len first and attending one token longer: the model writes early."""
    rng = np.random.default_rng(34)
    Lyr, B, Hkv, D, S = 2, 3, 2, 128, 256
    kq, ks, vq, vs = _cache(rng, Lyr, B, Hkv, S, D)
    q = torch.from_numpy(rng.normal(size=(B, 1, 4, D)).astype(np.float32))
    lengths = np.asarray([255, 200, 0], np.int32)
    kn, ksn, vn, vsn = _new_kv(rng, B, Hkv, D)
    li = 1
    got = t_decode(q, *map(torch.from_numpy, (kq, ks, vq, vs)), li, torch.from_numpy(lengths),
                   new_kv=tuple(map(torch.from_numpy, (kn, ksn, vn, vsn))))
    for b in range(B):
        pos = int(lengths[b])
        kq[li, b, :, :, pos], vq[li, b, :, pos] = kn[b], vn[b]
        ks[li, b, :, pos], vs[li, b, :, pos] = ksn[b], vsn[b]
    want = t_decode(q, *map(torch.from_numpy, (kq, ks, vq, vs)), li, torch.from_numpy(lengths + 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ------------------------------------------------------------ engines

MODELS = {
    "nf4": (dict(), dict()),
    "int8": (dict(quant="int8"), dict()),  # LLM.int8, threshold 6, static outliers
    "w8a8_prefill": (dict(), dict(w8a8_prefill=True)),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for quant in ("nf4", "int8"):
        jc, tc = JL.LlamaConfig.tiny(quant=quant, **SHAPE), TL.LlamaConfig.tiny(quant=quant, **SHAPE)
        jp = JL.init_params(jc, jax.random.PRNGKey(3))
        out[quant] = (jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu"))
    return out


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale, (np.abs(got - want).max(), scale)
    assert np.linalg.norm(got - want) <= LOGIT_REL_L2 * np.linalg.norm(want)


def _jax_engine_with_logits(jc, jp, ecfg, log):
    """The JAX contiguous engine with its prefill and decode functions
    rebuilt from the same llama_forward so that they also report their
    logits (prefill under the int8 repack's config with w8a8_prefill)."""
    eng = JEngine(jc, jp, ecfg)
    pf_cfg = dataclasses.replace(jc, quant="int8", llm_int8_threshold=0.0) if ecfg.w8a8_prefill else jc

    @jax.jit
    def prefill(params, tokens, true_len, key, ids):
        K, T = tokens.shape
        pos = jnp.broadcast_to(jnp.arange(T), (K, T))
        logits, cacheK = JL.llama_forward(params, pf_cfg, tokens, JL.init_kv_cache(jc, K), pos)
        last = jnp.take_along_axis(logits, (true_len - 1).reshape(K, 1, 1), axis=1)[:, 0]
        return jnp.argmax(last, -1).astype(jnp.int32), cacheK, last

    @jax.jit
    def decode(params, cache, tokens, positions, key, ids):
        logits, cache = JL.llama_forward(params, jc, tokens, cache, positions)
        return jnp.argmax(logits[:, 0], -1).astype(jnp.int32), cache, logits[:, 0]

    def prefill_logged(*args):
        tok, cacheK, last = prefill(*args)
        log.append(np.asarray(last))
        return tok, cacheK

    def decode_logged(*args):
        tok, cache, logits = decode(*args)
        log.append(np.asarray(logits))
        return tok, cache

    eng._prefill = prefill_logged
    eng._decode = decode_logged
    return eng


def _engines(monkeypatch, models, name, steps=None):
    monkeypatch.setattr(JL, "_use_fused_decode_attn", lambda cfg: True)
    mkw, ekw = MODELS[name]
    jc, tc, jp, tp = models[mkw.get("quant", "nf4")]
    kw = dict(max_batch=2, **ekw) if steps is None else dict(max_batch=2, max_new_tokens=steps, **ekw)
    jlog = []
    je = _jax_engine_with_logits(jc, jp, JEngineConfig(**kw), jlog)
    te = InferenceEngine(tc, tp, EngineConfig(**kw), device="cpu")
    return je, te, jlog


@pytest.mark.parametrize("name", list(MODELS))
def test_contiguous_engine_matches_jax(monkeypatch, models, name):
    je, te, jlog = _engines(monkeypatch, models, name)
    tlog = []
    sample = te._sample
    te._sample = lambda logits: (tlog.append(logits.numpy().copy()), sample(logits))[1]
    assert te._alloc is None and te.cache["k"].shape[1] == 2  # contiguous (L, B, ...) cache
    je.add_requests(PROMPTS)
    te.add_requests(PROMPTS)
    for _ in range(3):
        # teacher-forced: both engines see the same tokens
        te._last_tokens = je._last_tokens.copy()
        je.step()
        te.step()
    for call in range(4):
        _close_logits(tlog[call], jlog[call])
    for slot, p in enumerate(PROMPTS):
        n = len(p) + 3
        for key in ("k", "v"):
            a, b = np.asarray(je.cache[key][:, slot]), te.cache[key][:, slot].numpy()
            a, b = (a[..., :n], b[..., :n]) if key == "k" else (a[:, :, :n], b[:, :, :n])
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d[0].max() <= 1  # layer 0: no attention upstream
            assert d.mean() < 0.5 and d.max() <= 8, (d.mean(), d.max())


@pytest.mark.parametrize("name", list(MODELS))
def test_contiguous_greedy_tokens_match_jax_where_the_gap_is_clear(monkeypatch, models, name):
    steps = 5
    je, te, jlog = _engines(monkeypatch, models, name, steps)
    je.add_requests(PROMPTS)
    te.add_requests(PROMPTS)
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


def test_contiguous_matches_paged_on_repacked_int8(models):
    """The repacked int8 model served contiguously and paged gives the same
    greedy tokens (kernels H and D over the same KV)."""
    _, tc, _, tp = models["nf4"]
    p8, cfg8 = TL.repack_params_int8(tp, tc)
    prompts = [[1, 2, 3], [5, 6, 7, 8], [11, 12]]
    ref = InferenceEngine(cfg8, p8, EngineConfig(max_batch=2, max_new_tokens=6),
                          device="cpu").generate(prompts)
    out = InferenceEngine(cfg8, p8, EngineConfig(max_batch=2, max_new_tokens=6, paged=True),
                          device="cpu").generate(prompts)
    assert all(len(o) == 6 for o in ref)
    assert out == ref, (out, ref)


@pytest.mark.parametrize("paged", [False, True])
def test_w8a8_prefill_first_token_is_the_repacked_models(models, paged):
    """w8a8_prefill prefills on the int8 repack and decodes on the 4-bit
    weights: the first token is the fully repacked engine's, chunked
    prefill gives the same tokens as whole-prompt prefill, and the engine
    keeps no int8 copy."""
    _, tc, _, tp = models["nf4"]
    prompts = [list(range(1, 20)), [4, 5, 6, 7, 8]]
    kw = dict(max_batch=2, max_new_tokens=4, paged=paged)
    eng = InferenceEngine(tc, tp, EngineConfig(w8a8_prefill=True, **kw), device="cpu")
    out = eng.generate(prompts)
    assert all(isinstance(w, TL.QLinearWeight) for w in eng.params["layers"][0].values()
               if not isinstance(w, torch.Tensor))
    chunked = InferenceEngine(tc, tp, EngineConfig(w8a8_prefill=True, prefill_chunk=8, **kw),
                              device="cpu").generate(prompts)
    assert chunked == out
    p8, cfg8 = TL.repack_params_int8(tp, tc)
    full = InferenceEngine(cfg8, p8, EngineConfig(**kw), device="cpu").generate(prompts)
    assert [o[0] for o in out] == [o[0] for o in full]


def test_unported_options_still_raise(models, tmp_path):
    """A mesh is served: a one-rank mesh gives the single device's tokens
    (TP = 1: the retile and the all-reduce are the identity; TP = 2 is
    test_torch_parallel_models.py's), and anything but a DeviceMesh raises
    a TypeError, as the JAX engine raises on anything but a Mesh. Other
    families' forwards (forward_fn and init_cache_fn, their parity tests
    in test_torch_family_engine.py), the bf16 cache, prefixes and snapshots
    are served (test_torch_bf16_cache.py, test_torch_engine_serving.py)."""
    import torch_parallel_cases as C
    from bitsandbytes_sycl_tpu_torch.parallel import shard_llama_params

    _, tc, _, tp = models["nf4"]
    eng = InferenceEngine(tc, tp, EngineConfig(max_batch=2), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        InferenceEngine(tc, tp, EngineConfig(), device="cpu", mesh=object())
    ecfg1 = EngineConfig(max_batch=2, max_new_tokens=3)
    with C.one_rank_mesh(tmp_path, {"model": 1}) as mesh:
        on_mesh = InferenceEngine(tc, shard_llama_params(tp, tc, mesh), ecfg1, device="cpu",
                                  mesh=mesh).generate(PROMPTS)
    assert on_mesh == InferenceEngine(tc, tp, ecfg1, device="cpu").generate(PROMPTS)
    # an explicit forward_fn and init_cache_fn serve as the defaults do
    ecfg = EngineConfig(max_batch=2, max_new_tokens=3)
    by_fn = InferenceEngine(tc, tp, ecfg, device="cpu", forward_fn=TL.llama_forward,
                            init_cache_fn=TL.init_kv_cache).generate(PROMPTS)
    assert by_fn == InferenceEngine(tc, tp, ecfg, device="cpu").generate(PROMPTS)
    bf16 = InferenceEngine(dataclasses.replace(tc, kv_quant=False), tp,
                           EngineConfig(max_batch=2, max_new_tokens=2), device="cpu")
    assert bf16.cache["k"].dtype == tc.dtype and set(bf16.cache) == {"k", "v"}
    assert [len(o) for o in bf16.generate([[1, 2, 3]])] == [2]
    with pytest.raises(ValueError, match="kv_quant"):
        InferenceEngine(dataclasses.replace(tc, kv_quant=False), tp, EngineConfig(paged=True),
                        device="cpu")
    pid = eng.register_prefix([1, 2])
    assert eng.add_requests([[3, 4]], prefix=pid) == [0]
    assert eng.slot_tokens[0][:4] == [1, 2, 3, 4] and eng.seq_lens[0] == 4
    assert eng.snapshot()["seq_lens"][0] == 4
