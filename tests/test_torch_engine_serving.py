"""The port's serving engine beyond plain generation against the JAX
package: multi-LoRA serving, the prefix cache (whole and chunked suffixes,
contiguous and paged), snapshots (in memory and through torch.save) and the
standalone PagedKVPool.

The model is the tiny config with head_dim = 128 of
test_torch_llama_engine.py, so the port's attention runs its kernels' plain
versions; the JAX engine (one per module, contiguous, serving the same
stacked adapters) attends through its XLA route on the CPU, as its own
tests run it. Tolerances are those of test_torch_llama_engine.py: first
tokens' logits within 5% of the largest logit and 4% relative L2 (the port
attends over f32-dequantized K/V, the JAX CPU path over bf16, and W4A8
requantizes every activation row after that); greedy tokens equal until a
step where the port's top-2 logit gap is within 5% of its largest logit,
where the two may part. Within the port, snapshots and zero adapters are
held bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu.engine import EngineConfig as JEngineConfig
from bitsandbytes_sycl_tpu.engine import InferenceEngine as JEngine
from bitsandbytes_sycl_tpu.engine import PagedKVPool as JPool
from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu_torch.convert import lora_from_jax, params_from_jax
from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine, PagedKVPool
from bitsandbytes_sycl_tpu_torch.models import llama as TL

LOGIT_TOL = 5e-2  # of the largest |logit|
LOGIT_REL_L2 = 4e-2
SHAPE = dict(hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
ECFG = dict(max_batch=2, max_new_tokens=5, prefill_buckets=(16,))
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5, 4, 3, 2, 1]]
PREFIX = [7, 8, 9, 10, 11]
SUFFIXES = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [4, 5, 6, 1, 2]]
TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side runs on one thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacked_adapters(cfg, n=3, rank=4, seed=5):
    """A stack_lora tree in numpy: adapter 0 as init_lora leaves it (B =
    0), the others with seeded B."""
    rng = np.random.default_rng(seed)
    shapes = JL._fp_layer_shapes(cfg)
    out = []
    for _ in range(cfg.num_layers):
        layer = {}
        for t in TARGETS:
            N, K = shapes[t]
            B = rng.normal(size=(n, N, rank)).astype(np.float32) * 0.05
            B[0] = 0.0
            layer[t] = {"A": (rng.normal(size=(n, rank, K)) / np.sqrt(rank)).astype(np.float32),
                        "B": B, "scale": np.full((n,), 16.0 / rank, np.float32)}
        out.append(layer)
    return out


@pytest.fixture(scope="module")
def setup():
    jc, tc = JL.LlamaConfig.tiny(**SHAPE), TL.LlamaConfig.tiny(**SHAPE)
    jp = JL.init_params(jc, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    lora_np = _stacked_adapters(jc)
    jlora = jax.tree.map(jnp.asarray, lora_np)
    je = JEngine(jc, jp, JEngineConfig(**ECFG), lora=jlora)

    @jax.jit
    def prefill(params, tokens, true_len, key, ids):
        """The JAX engine's greedy prefill_fn, also returning the logits
        after each prompt's last token."""
        K, T = tokens.shape
        pos = jnp.broadcast_to(jnp.arange(T), (K, T))
        logits, cacheK = JL.llama_forward(params, jc, tokens, JL.init_kv_cache(jc, K), pos,
                                          lora=jlora, lora_ids=ids)
        last = jnp.take_along_axis(logits, (true_len - 1).reshape(K, 1, 1), axis=1)[:, 0]
        return jnp.argmax(last, -1).astype(jnp.int32), cacheK, last

    def first_logits(tokens, lens, ids):
        """The JAX model's next-token logits after each whole prompt."""
        return prefill(jp, tokens, lens, None, ids)[2]

    je._prefill = lambda *args: prefill(*args)[:2]
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, lora_np=lora_np, je=je, first=first_logits, memo={})


def _padded(prompts, T=16):
    toks = np.zeros((len(prompts), T), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    return toks, np.asarray([len(p) for p in prompts], np.int32)


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_TOL * scale, (np.abs(got - want).max(), scale)
    assert np.linalg.norm(got - want) <= LOGIT_REL_L2 * np.linalg.norm(want)


def _recording(eng):
    """Wrap the engine's sampler to keep every call's logits."""
    log = []
    sample = eng._sample
    eng._sample = lambda logits: (log.append(logits.numpy().copy()), sample(logits))[1]
    return log


def _gap_rule(want, got, log):
    """Requests' tokens equal until a step where the port's top-2 logit
    gap (log[i][request]: the prefill's, then one decode step's per token)
    is within LOGIT_TOL of its largest logit. Returns the tokens compared."""
    compared = 0
    for r, (a, b) in enumerate(zip(want, got)):
        assert len(a) == len(b)
        for i, (ta, tb) in enumerate(zip(a, b)):
            if ta != tb:
                lg = log[i][r]
                top2 = np.sort(lg)[-2:]
                assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(lg).max(), (r, i)
                break
            compared += 1
    return compared


def _engine(setup, lora=True, **kw):
    ecfg = EngineConfig(**{**ECFG, **kw})
    return InferenceEngine(setup["tc"], setup["tp"], ecfg, device="cpu",
                           lora=lora_from_jax(setup["lora_np"], device="cpu") if lora else None)


def _jax_once(setup, key, fn):
    memo = setup["memo"]
    if key not in memo:
        memo[key] = fn(setup["je"])
    return memo[key]


# ------------------------------------------------------------ multi-LoRA


@pytest.mark.parametrize("paged", [False, True])
def test_multi_lora_matches_jax(setup, paged):
    want = _jax_once(setup, "lora", lambda je: je.generate(PROMPTS, adapter_ids=[1, 2]))
    te = _engine(setup, paged=paged)
    log = _recording(te)
    got = te.generate(PROMPTS, adapter_ids=[1, 2])
    toks, lens = _padded(PROMPTS)
    _close_logits(log[0], setup["first"](jnp.asarray(toks), jnp.asarray(lens), jnp.asarray([1, 2])))
    assert _gap_rule(want, got, log) >= 5
    assert (te.slot_adapter[:2] == [1, 2]).all()
    # a zero adapter (B = 0) leaves the base model's logits and tokens bit for bit
    base = _engine(setup, lora=False, paged=paged)
    base_log = _recording(base)
    zero = _engine(setup, paged=paged)
    zero_log = _recording(zero)
    assert zero.generate(PROMPTS, adapter_ids=[0, 0]) == base.generate(PROMPTS)
    assert all(np.array_equal(a, b) for a, b in zip(zero_log, base_log))
    assert got != base.generate(PROMPTS)  # the adapters act


def test_multi_lora_validations(setup, tmp_path):
    tc, tp = setup["tc"], setup["tp"]
    single = lora_from_jax([{t: {k: v[0] for k, v in ab.items()} for t, ab in layer.items()}
                            for layer in setup["lora_np"]], device="cpu")
    with pytest.raises(ValueError, match="stacked"):  # a 2-D adapter would ignore adapter_ids
        InferenceEngine(tc, tp, EngineConfig(**ECFG), device="cpu", lora=single)
    # a forward_fn is served with adapters: the stacked-form check still
    # refuses a 2-D adapter, and a forward without the adapter kwargs is
    # refused; a mesh must be a DeviceMesh (the adapters then shard with
    # the base weights: test_torch_parallel_models.py)
    with pytest.raises(ValueError, match="stacked"):
        InferenceEngine(tc, tp, EngineConfig(**ECFG), device="cpu", lora=single,
                        forward_fn=TL.llama_forward)
    with pytest.raises(NotImplementedError, match="lora/lora_ids"):
        InferenceEngine(tc, tp, EngineConfig(**ECFG), device="cpu", lora=single,
                        forward_fn=lambda p, c, t, cache, pos: TL.llama_forward(p, c, t, cache, pos))
    stacked = lora_from_jax(setup["lora_np"], device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        InferenceEngine(tc, tp, EngineConfig(**ECFG), device="cpu", mesh=object(), lora=stacked)
    # a one-rank mesh serves the adapters as the single device does
    import torch_parallel_cases as C
    from bitsandbytes_sycl_tpu_torch.parallel import shard_llama_params

    with C.one_rank_mesh(tmp_path, {"model": 1}) as mesh:
        on_mesh = InferenceEngine(tc, shard_llama_params(tp, tc, mesh), EngineConfig(**ECFG),
                                  device="cpu", mesh=mesh, lora=stacked).generate(
                                      PROMPTS, adapter_ids=[0, 1])
    assert on_mesh == _engine(setup).generate(PROMPTS, adapter_ids=[0, 1])
    eng = _engine(setup)
    with pytest.raises(ValueError, match="out of range"):
        eng.add_request([1, 2, 3], adapter_id=5)
    with pytest.raises(NotImplementedError, match="lora"):
        eng.generate_speculative([[1, 2, 3]], 3, tp, tc)
    pid = eng.register_prefix([7, 8, 9], adapter_id=0)
    with pytest.raises(ValueError, match="adapter 0"):
        eng.add_requests([[1, 2]], adapter_ids=[1], prefix=pid)
    eng.unregister_prefix(pid)
    assert pid not in eng._prefixes
    # omitted adapter_ids mean adapter 0, which a prefix of adapter 1 refuses
    pid1 = eng.register_prefix([7, 8, 9], adapter_id=1)
    with pytest.raises(ValueError, match="adapter 1"):
        eng.add_requests([[1, 2]], prefix=pid1)
    # a snapshot from before multi-LoRA restores with every slot on adapter 0
    s = eng.add_request([1, 2, 3], adapter_id=1)
    snap = eng.snapshot()
    assert snap["slot_adapter"][s] == 1
    eng.restore({k: v for k, v in snap.items() if k != "slot_adapter"})
    assert (eng.slot_adapter == 0).all()


# ------------------------------------------------------------ prefix cache


def _jax_prefix(je, chunk):
    je.ecfg = dataclasses.replace(je.ecfg, prefill_chunk=chunk)
    pid = je.register_prefix(PREFIX)
    slots = je.add_requests(SUFFIXES, prefix=pid)
    while je.active.any():
        je.step()
    je.unregister_prefix(pid)
    je.ecfg = dataclasses.replace(je.ecfg, prefill_chunk=0)
    return [je.slot_tokens[s][len(PREFIX) + len(sfx):] for s, sfx in zip(slots, SUFFIXES)]


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("paged", [False, True])
def test_prefix_cache_matches_jax(setup, paged, chunk):
    want = _jax_once(setup, ("prefix", chunk), lambda je: _jax_prefix(je, chunk))
    te = _engine(setup, paged=paged, prefill_chunk=chunk)
    pid = te.register_prefix(PREFIX)
    stored = {k: v.clone() for k, v in te._prefixes[pid]["cache"].items()}
    log = _recording(te)
    slots = te.add_requests(SUFFIXES, prefix=pid)
    assert te.seq_lens[slots].tolist() == [len(PREFIX) + len(s) for s in SUFFIXES]
    if not paged:  # each slot's first positions hold the stored prefix's KV
        n = len(PREFIX)
        for s in slots:
            assert torch.equal(te.cache["k"][:, s, ..., :n], stored["k"][:, 0, ..., :n])
            assert torch.equal(te.cache["v"][:, s, :, :n], stored["v"][:, 0, :, :n])
    while te.active.any():
        te.step()
    got = [te.slot_tokens[s][len(PREFIX) + len(sfx):] for s, sfx in zip(slots, SUFFIXES)]
    toks, lens = _padded([PREFIX + s for s in SUFFIXES])
    _close_logits(log[0][:2], setup["first"](jnp.asarray(toks), jnp.asarray(lens),
                                             jnp.asarray([0, 0])))
    assert _gap_rule(want, got, log) >= 5
    # a second batch over the same prefix gives the same tokens; the stored
    # prefix is never written
    slots = te.add_requests(SUFFIXES, prefix=pid)
    while te.active.any():
        te.step()
    assert [te.slot_tokens[s][len(PREFIX) + len(sfx):] for s, sfx in zip(slots, SUFFIXES)] == got
    assert all(torch.equal(te._prefixes[pid]["cache"][k], stored[k]) for k in stored)
    te.unregister_prefix(pid)
    assert not te._prefixes
    with pytest.raises(KeyError):
        te.add_requests(SUFFIXES, prefix=pid)


# --------------------------------------------------------------- snapshots


def _steps(eng, n):
    return [dict(eng.step()) for _ in range(n)]


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_snapshot_resumes_bit_for_bit(setup, tmp_path, paged, sampled):
    kw = dict(max_new_tokens=12, paged=paged)
    if sampled:
        kw.update(temperature=0.8, top_k=5)
    e1 = _engine(setup, lora=False, **kw)
    rng = np.random.default_rng(3)
    e1.add_request(rng.integers(0, 256, 9).tolist())
    e1.add_request(rng.integers(0, 256, 14).tolist())
    _steps(e1, 4)
    snap = e1.snapshot()
    torch.save(e1.durable_snapshot(), tmp_path / "engine.pt")
    ref = _steps(e1, 5)
    e2 = _engine(setup, lora=False, **kw)
    e2.restore(snap)
    assert _steps(e2, 5) == ref
    e2.restore(snap)  # the snapshot is not written by the resumed engine
    assert _steps(e2, 5) == ref
    e3 = _engine(setup, lora=False, **kw)
    e3.restore_durable(torch.load(tmp_path / "engine.pt"))
    assert _steps(e3, 5) == ref
    if paged:  # the free list is rebuilt from the page tables, page 0 reserved
        held = {p for t in e3._alloc.tables.values() for p in t}
        assert sorted(e3._alloc._free + sorted(held)) == list(range(1, e3._alloc.num_pages))


def test_durable_snapshot_budget_override_and_refusals(setup):
    eng = _engine(setup, lora=False, max_batch=1, max_new_tokens=2)
    eng.add_request([1, 2, 3], max_new_tokens=40)
    _steps(eng, 30)
    snap = eng.durable_snapshot()  # sized from the slot, not the config's budget
    eng2 = _engine(setup, lora=False, max_batch=1, max_new_tokens=2)
    eng2.restore_durable(snap)
    assert eng2.slot_tokens[0] == eng.slot_tokens[0]
    paged = _engine(setup, lora=False, max_batch=1, paged=True)
    with pytest.raises(ValueError, match="page tables"):
        paged.restore(eng.snapshot())


# ------------------------------------------------------------ PagedKVPool


def test_paged_kv_pool_alloc_free_reuse():
    cfg = TL.LlamaConfig.tiny(num_layers=1, max_seq_len=512)
    pool = PagedKVPool(cfg, num_pages=6, page_size=128, device="cpu")
    assert pool.free_pages() == 6
    assert len(pool.alloc_slot(0, 300)) == 3 and pool.free_pages() == 3
    pool.extend_slot(0, 400)
    assert len(pool.tables[0]) == 4 and pool.free_pages() == 2
    with pytest.raises(RuntimeError):
        pool.alloc_slot(1, 128 * 3)
    pool.release_slot(0)
    assert pool.free_pages() == 6
    pool.alloc_slot(1, 512)
    assert pool.free_pages() == 2
    with pytest.raises(ValueError):
        pool.alloc_slot(2, 4096 * 2)
    with pytest.raises(NotImplementedError, match="kv_bits=4"):
        PagedKVPool(dataclasses.replace(cfg, kv_bits=4), num_pages=2, device="cpu")


def test_paged_kv_pool_matches_jax():
    """Ingest a contiguous cache, write one decode step, attend: the pool
    bytes equal the JAX pool's, the attention is kernel D's plain version
    against the JAX kernel (interpret mode) within test_torch_attention.py's
    tolerance."""
    shape = dict(num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128, hidden_size=256,
                 max_seq_len=512)
    jc, tc = JL.LlamaConfig.tiny(**shape), TL.LlamaConfig.tiny(**shape)
    B, S, H, D = 2, 512, 2, 128
    T0 = [200, 256]
    rng = np.random.default_rng(33)
    kq, ks = JL._kv_quantize(jnp.asarray(rng.normal(size=(B, S, H, D)), jnp.float32))
    vq, vs = JL._kv_quantize(jnp.asarray(rng.normal(size=(B, S, H, D)), jnp.float32))
    li = 1
    cache = {k: np.zeros(s, d) for k, s, d in (
        ("k", (2, B, H, D, S), np.int8), ("v", (2, B, H, S, D), np.int8),
        ("k_scale", (2, B, H, S), np.float32), ("v_scale", (2, B, H, S), np.float32))}
    cache["k"][li] = np.asarray(kq).transpose(0, 2, 3, 1)
    cache["v"][li] = np.asarray(vq).transpose(0, 2, 1, 3)
    cache["k_scale"][li] = np.asarray(ks).transpose(0, 2, 1)
    cache["v_scale"][li] = np.asarray(vs).transpose(0, 2, 1)
    knew = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    vnew = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    q = rng.normal(size=(B, 1, 4, D)).astype(np.float32)
    slots = [7, 9]
    outs, pools = [], []
    for P, L, cv, arr in ((JPool, JL, jnp.asarray, np.asarray),
                          (PagedKVPool, TL, torch.from_numpy, lambda t: t.numpy())):
        cfg = jc if P is JPool else tc
        pool = P(cfg, num_pages=12, page_size=128) if P is JPool else \
            P(cfg, num_pages=12, page_size=128, device="cpu")
        c = {k: cv(v) for k, v in cache.items()}
        for i, s in enumerate(slots):
            pool.ingest_contiguous(s, c, i, T0[i])
            pool.extend_slot(s, T0[i] + 1)
        kqn, ksn = L._kv_quantize(cv(knew))
        vqn, vsn = L._kv_quantize(cv(vnew))
        pool.write_decode_step(li, kqn.transpose(0, 2, 3, 1) if P is JPool else kqn.permute(0, 2, 3, 1),
                               ksn.transpose(0, 2, 1) if P is JPool else ksn.permute(0, 2, 1),
                               vqn.transpose(0, 2, 1, 3) if P is JPool else vqn.permute(0, 2, 1, 3),
                               vsn.transpose(0, 2, 1) if P is JPool else vsn.permute(0, 2, 1),
                               slots, np.asarray(T0))
        outs.append(arr(pool.attend(li, cv(q), slots, np.asarray(T0) + 1)))
        pools.append([pool.tables] + [arr(getattr(pool, k)) for k in ("k", "v", "k_scale",
                                                                        "v_scale")])
    assert pools[0][0] == pools[1][0]  # the same page ids, in the same order
    for a, b in zip(pools[0][1:], pools[1][1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-5, atol=2e-5)

