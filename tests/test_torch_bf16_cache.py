"""The bf16 KV cache (``kv_quant=False``) and the dequantize-then-attend
route of the int8 cache, in the port's model and engine, against the JAX
package's model on the CPU (its XLA route, which every cached forward of
the JAX package takes there).

Tolerances:
- the bf16 cache: the f32 config's prefill logits within 1e-3 of the
  largest and in relative L2 (the same _attention over the same values;
  only summation orders differ); the rest within the engine tests' 5% / 4%,
  since W4A8's per-row int8 requantization of an activation amplifies a
  last-bit difference of the cache or of a bf16 rounding to a code step
  (measured 1.5% in the f32 config's second decode step, 2.8% in the bf16
  config's prefill);
- the dequantize route: logits within 5% of the largest and 4% relative L2,
  as test_torch_llama_engine.py (the prefill before it runs kernel C's plain
  version, which attends over f32-dequantized K/V where JAX uses bf16);
- engine tokens: equal until a step where the port's top-2 logit gap is
  within 5% of its largest logit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu_torch.convert import params_from_jax
from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
from bitsandbytes_sycl_tpu_torch.models import llama as TL
from bitsandbytes_sycl_tpu_torch.ops.attention import (
    decode_attention_int8_stacked,
    prefill_attention_int8_stacked,
)

TIGHT = (1e-3, 1e-3)
LOOSE = (5e-2, 4e-2)  # of the largest |logit|, relative L2


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side runs on one thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(jkw, tkw):
    jc, tc = JL.LlamaConfig.tiny(**jkw), TL.LlamaConfig.tiny(**tkw)
    jp = JL.init_params(jc, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    jfwd = jax.jit(lambda t, c, p: JL.llama_forward(jp, jc, t, c, p))
    return jc, tc, jp, tp, jfwd


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol[0] * scale, (np.abs(got - want).max(), scale)
    assert np.linalg.norm(got - want) <= tol[1] * np.linalg.norm(want)


CONFIGS = {
    # f32 without a window; bf16 with a sliding window of 6 (binding from
    # the first decode step of a 9-token prompt)
    "f32": (dict(dtype=jnp.float32, kv_quant=False, max_seq_len=64),
            dict(dtype=torch.float32, kv_quant=False, max_seq_len=64)),
    "bf16_window": (dict(kv_quant=False, max_seq_len=64, sliding_window=6),
                    dict(kv_quant=False, max_seq_len=64, sliding_window=6)),
}


@pytest.fixture(scope="module")
def models():
    """Each config's models and jitted JAX forward, built once (each shape
    compiles once)."""
    return {name: _models(*kw) for name, kw in CONFIGS.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_cache_forward_matches_jax(models, name):
    jc, tc, jp, tp, jfwd = models[name]
    toks = np.random.default_rng(0).integers(0, 256, (2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
    jl, jcache = jfwd(jnp.asarray(toks), JL.init_kv_cache(jc, 2), jnp.asarray(pos))
    tcache = TL.init_kv_cache(tc, 2, "cpu")
    assert set(tcache) == {"k", "v"} and tcache["k"].shape == (2, 2, 2, 64, 64)
    assert tcache["k"].dtype == tc.dtype
    before = TL.write_and_attend.bf16_calls
    tl, tcache = TL.llama_forward(tp, tc, torch.from_numpy(toks), tcache)
    assert TL.write_and_attend.bf16_calls - before == tc.num_layers
    _close(tl.numpy(), jl, TIGHT if name == "f32" else LOOSE)
    for step in range(4):  # decode steps, the JAX model's greedy tokens into both
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        p = np.full((2, 1), 9 + step, np.int32)
        jl, jcache = jfwd(jnp.asarray(tok), jcache, jnp.asarray(p))
        tl, tcache = TL.llama_forward(tp, tc, torch.from_numpy(tok), tcache,
                                      torch.from_numpy(p).long())
        _close(tl.numpy(), jl, LOOSE)
    for key in ("k", "v"):  # the caches hold the same keys and values
        _close(tcache[key].float().numpy(), np.asarray(jcache[key], np.float32), LOOSE)


def test_bf16_cache_engine_tokens_match_jax_greedy(models):
    """The contiguous engine over the bf16 cache gives the JAX model's
    greedy tokens; the paged pool still refuses it."""
    jc, tc, jp, tp, jfwd = models["bf16_window"]
    prompts = [[3, 17, 42, 7], [9, 8, 7, 6, 5, 4]]
    eng = InferenceEngine(tc, tp, EngineConfig(max_batch=2, max_new_tokens=6,
                                               prefill_buckets=(9,)), device="cpu")
    log = []
    sample = eng._sample
    eng._sample = lambda logits: (log.append(logits.numpy().copy()), sample(logits))[1]
    got = eng.generate(prompts)
    toks = np.zeros((2, 9), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    lens = np.asarray([len(p) for p in prompts])
    jl, jcache = jfwd(jnp.asarray(toks), JL.init_kv_cache(jc, 2),
                      jnp.asarray(np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)))
    nxt = np.asarray(jnp.argmax(jl[np.arange(2), lens - 1], -1))
    want = [[int(t)] for t in nxt]
    for step in range(5):
        jl, jcache = jfwd(jnp.asarray(nxt[:, None].astype(np.int32)), jcache,
                          jnp.asarray((lens + step)[:, None].astype(np.int32)))
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1))
        for i in range(2):
            want[i].append(int(nxt[i]))
    compared = 0
    for r in range(2):
        for i, (a, b) in enumerate(zip(want[r], got[r])):
            if a != b:
                top2 = np.sort(log[i][r])[-2:]
                assert top2[1] - top2[0] <= LOOSE[0] * np.abs(log[i][r]).max(), (r, i)
                break
            compared += 1
    assert compared >= 6
    with pytest.raises(ValueError, match="kv_quant"):
        InferenceEngine(tc, tp, EngineConfig(paged=True), device="cpu")


def test_dequant_route_matches_jax_where_the_kernels_decline():
    """Over a written int8 cache, forwards of T = 2 and T = 5 rows (the
    speculative draft's ingest and verify) take the dequantize-then-attend
    route, counted once a layer, and match the JAX model at the same shapes;
    the prefill (T = 16) and a decode step (T = 1) stay on kernels C and H
    (their plain versions here), and the op wrappers still refuse T = 2 and
    5."""
    shape = dict(hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
    jc, tc, jp, tp, jfwd = _models(shape, shape)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    jl, jcache = jfwd(jnp.asarray(toks), JL.init_kv_cache(jc, 2),
                      jnp.asarray(np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)))
    tcache = TL.init_kv_cache(tc, 2, "cpu")
    calls = TL.write_and_attend.dequant_calls
    tl, tcache = TL.llama_forward(tp, tc, torch.from_numpy(toks), tcache)
    _close(tl.numpy(), jl, LOOSE)
    assert TL.write_and_attend.dequant_calls == calls
    start = 16
    for T in (2, 5):  # ragged rows: row 1 one position ahead
        chunk = rng.integers(0, 256, (2, T)).astype(np.int32)
        pos = (np.asarray([[start], [start + 1]]) + np.arange(T)[None]).astype(np.int32)
        jl, jcache = jfwd(jnp.asarray(chunk), jcache, jnp.asarray(pos))
        tl, tcache = TL.llama_forward(tp, tc, torch.from_numpy(chunk), tcache,
                                      torch.from_numpy(pos).long())
        _close(tl.numpy(), jl, LOOSE)
        start += T
    assert TL.write_and_attend.dequant_calls - calls == 2 * tc.num_layers
    tok = torch.tensor([[3], [4]])
    TL.llama_forward(tp, tc, tok, tcache, torch.tensor([[start], [start + 1]]))
    assert TL.write_and_attend.dequant_calls - calls == 2 * tc.num_layers  # T = 1: kernel H
    q = torch.zeros((2, 5, 2, 128))
    lens = torch.zeros(2, dtype=torch.long)
    leaves = (tcache["k"], tcache["k_scale"], tcache["v"], tcache["v_scale"], 0)
    with pytest.raises(ValueError, match="does not take"):
        prefill_attention_int8_stacked(q, *leaves, lens)
    with pytest.raises(ValueError, match="does not take"):
        prefill_attention_int8_stacked(q[:, :2], *leaves, lens)
    with pytest.raises(ValueError, match="does not take"):
        decode_attention_int8_stacked(q[:, :2], *leaves, lens)
    assert [TL.kernel_attends(tcache, tc, T, 2) for T in (1, 2, 5, 8)] == [True, False, False, True]
    bf16 = dataclasses.replace(tc, kv_quant=False)
    assert not TL.kernel_attends(TL.init_kv_cache(bf16, 1, "cpu"), bf16, 16, 2)
