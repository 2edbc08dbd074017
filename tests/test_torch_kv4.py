"""The port's int4 KV pages (``kv_bits=4``) against the JAX package on the
CPU: the nibble codec, the page packing and scale order, kernel D's kv4
branch (its plain version here, the JAX kernel in interpret mode), the
decode step's in-place pool writes, and the kv4 paged engine.

Tolerances:
- codec, packing, scale order, ingest and the decode step's pool bytes:
  bit for bit. The write test feeds both packages the same float k and v,
  which both quantize to the same codes; every page but page 0 is
  compared after every step. Page 0 is the trash page that retired rows
  write to: the JAX package rebuilds an odd-offset byte from its staged
  copy of the step before's nibble, the port reads the byte in the pool,
  and several rows' writes to page 0 land in no defined order;
- attention: f32 outputs of the same f32 scores, TOL = 2e-5 (as kernel H's
  test in test_torch_contiguous.py);
- engines: whole models do not give identical activations in the two
  packages (a bf16 product summed in another order, sin and cos), so
  their pools hold codes one step apart in a few places: every page but
  page 0 holds nibble codes within one step and scales within 5% of
  JAX's after every step (measured on this tiny model: at most 1 step, in
  under 3% of the bytes). A kv4 code one step apart moves its K or V
  element by absmax / 7, where an int8 code moves it by absmax / 127, so
  the logits of the int8 engines' tests (5% of the largest, 4% relative
  L2, test_torch_llama_engine.py) become 10% and 8% here (measured: up to
  5.9% and 5.0%, under W8A8 prefill with chunks); greedy tokens are equal
  wherever the JAX engine's top-2 logit gap exceeds 5% of its largest
  logit, the int8 engines' rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_sycl_tpu.engine.paged as JP
from bitsandbytes_sycl_tpu.engine import EngineConfig as JEngineConfig
from bitsandbytes_sycl_tpu.engine import InferenceEngine as JEngine
from bitsandbytes_sycl_tpu.models import llama as JL
from bitsandbytes_sycl_tpu.ops import paged_attention as JA
from bitsandbytes_sycl_tpu_torch.convert import params_from_jax
from bitsandbytes_sycl_tpu_torch.engine import EngineConfig, InferenceEngine
from bitsandbytes_sycl_tpu_torch.engine import paged as TP
from bitsandbytes_sycl_tpu_torch.models import llama as TL
from bitsandbytes_sycl_tpu_torch.ops import paged_attention as TA

TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = 5e-2  # of the largest |logit|: the int8 engines' gap rule
# kv4 engines' logits (see the module note): twice the int8 engines' limits
KV4_LOGIT_TOL = 1e-1  # of the largest |logit|
KV4_LOGIT_REL_L2 = 8e-2
SHAPE = dict(hidden_size=256, num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256,
             kv_bits=4)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5, 4, 3, 2, 1]]


def _nib_codes(packed):
    """(..., P/2, D) kv4 bytes -> (..., P, D) signed codes, by arithmetic
    independent of both packages' unpackers."""
    b = np.asarray(packed).astype(np.int32)
    hi, lo = b >> 4, b & 15
    dec = lambda n: np.where(n & 8, -(n & 7), n & 7)  # noqa: E731
    return np.stack([dec(hi), dec(lo)], axis=-2).reshape(*b.shape[:-2], -1, b.shape[-1])


# ------------------------------------------------------------ codec and layout


@pytest.mark.parametrize("levels", [127.0, 7.0])
def test_kv_quantize_matches_jax_on_both_grids(levels):
    """The decode step's token quantization, on the int8 and the kv4
    grid, bit for bit over a million values (the scale levels / absmax is
    a correctly rounded division, as JAX's: a Python scalar over a tensor
    rounded it twice in 25% of the rows, and moved 6 int8 codes in 4M)."""
    x = np.random.default_rng(int(levels)).normal(size=(16, 64, 8, 128)).astype(np.float32)
    x[0, 1, 2] = 0.0
    jq, js = JL._kv_quantize(jnp.asarray(x), levels)
    tq, ts = TL._kv_quantize(torch.from_numpy(x), levels)
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


def test_nibble_codec_matches_jax():
    c8 = np.arange(-127, 128, dtype=np.int8)
    np.testing.assert_array_equal(np.asarray(JA.requant_nib4(jnp.asarray(c8))),
                                  TA.requant_nib4(torch.from_numpy(c8)).numpy())
    c4 = np.arange(-7, 8, dtype=np.int8)
    nib = TA.nib_sign_mag(torch.from_numpy(c4)).numpy()
    np.testing.assert_array_equal(np.asarray(JA.nib_sign_mag(jnp.asarray(c4))), nib)
    np.testing.assert_array_equal(nib, np.abs(c4) + 8 * (c4 < 0))
    # round half to even on the +-7 grid: 127 (k + 1/2) / 7 is never an integer
    assert TA.requant_nib4(torch.tensor([9, 10, -63, -64, 127], dtype=torch.int8)).tolist() == \
        [0 + 0, 1, 8 + 3, 8 + 4, 7]


def test_pack_unpack_and_scale_order_match_jax():
    rng = np.random.default_rng(0)
    c8 = rng.integers(-127, 128, (2, 1, 3, 128, 128)).astype(np.int8)  # (L, 1, H, P, D)
    s = rng.uniform(0, 2, (2, 1, 3, 128)).astype(np.float32)
    jpk = np.asarray(JP._pack4(jnp.asarray(c8), tok_axis=3))
    tpk = TP._pack4(torch.from_numpy(c8), 3).numpy()
    np.testing.assert_array_equal(jpk, tpk)
    np.testing.assert_array_equal(np.asarray(JP._scale_cols(jnp.asarray(s), 3)),
                                  TP._scale_cols(torch.from_numpy(s), 3).numpy())
    codes = TA.kv4_unpack(torch.from_numpy(tpk)).numpy()
    np.testing.assert_array_equal(codes, np.asarray(JL._kv4_unpack(jnp.asarray(jpk))))
    np.testing.assert_array_equal(codes, _nib_codes(tpk))
    cols = TP._scale_cols(torch.from_numpy(s), 3)
    np.testing.assert_array_equal(TA.kv4_scales_logical(cols).numpy(), s)
    np.testing.assert_array_equal(np.asarray(JL._kv4_scales_logical(jnp.asarray(cols.numpy()))), s)


# ------------------------------------------------------------ kernel D, kv4


def _kv4_pool(rng, L, NP, H, P, D):
    c = rng.integers(-7, 8, (2, L, NP, H, P, D))
    nib = (np.abs(c) + 8 * (c < 0)).astype(np.uint8)
    packed = (nib[..., 0::2, :] << 4) | nib[..., 1::2, :]
    # k scales in [4, 12) give O(1) scores over +-7 codes with q ~ N(0, 1)
    ks = rng.uniform(4.0, 12.0, (L, NP, H, P)).astype(np.float32)
    vs = rng.uniform(0.5, 2.0, (L, NP, H, P)).astype(np.float32)
    return packed[0], ks, packed[1], vs


# (Hq, Hkv, new_kv, window, softcap)
ATTN_CASES = [(2, 2, False, None, None), (4, 2, True, None, None), (4, 1, True, 100, None),
              (2, 1, True, 60, 30.0)]


@pytest.mark.parametrize("Hq,Hkv,new,window,softcap", ATTN_CASES)
def test_paged_kv4_matches_jax_kernel(Hq, Hkv, new, window, softcap):
    rng = np.random.default_rng(Hq * 10 + Hkv + (7 if new else 0))
    L, NP, P, D, B, MAXP, li = 2, 6, 128, 128, 3, 2, 1
    kp, ks, vp, vs = _kv4_pool(rng, L, NP, Hkv, P, D)
    table = np.asarray([[3, 1], [2, 5], [4, 4]], np.int32)
    lengths = np.asarray([200, 77, 0 if new else 1], np.int32)  # ragged, odd and even
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    nkv = None
    if new:
        nkv = (rng.integers(-7, 8, (B, Hkv, D)).astype(np.int8),
               rng.uniform(4.0, 12.0, (B, Hkv)).astype(np.float32),
               rng.integers(-7, 8, (B, Hkv, D)).astype(np.int8),
               rng.uniform(0.5, 2.0, (B, Hkv)).astype(np.float32))
    want = JA.paged_decode_attention_int8_stacked(
        jnp.asarray(q), *map(jnp.asarray, (kp, ks, vp, vs)), li, jnp.asarray(table),
        jnp.asarray(lengths), new_kv=None if nkv is None else tuple(map(jnp.asarray, nkv)),
        window=window, softcap=softcap)
    got = TA.paged_decode_attention_int8_stacked(
        torch.from_numpy(q), *map(torch.from_numpy, (kp, ks, vp, vs)), li,
        torch.from_numpy(table), torch.from_numpy(lengths),
        new_kv=None if nkv is None else tuple(map(torch.from_numpy, nkv)),
        window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the scores see the nibbles and scales: a pool with its nibbles
    # swapped, or its scales in token order, attends differently
    swapped = ((torch.from_numpy(kp) & 0xF) << 4) | (torch.from_numpy(kp) >> 4)
    bad = TA.paged_decode_attention_int8_stacked(
        torch.from_numpy(q), swapped, torch.from_numpy(ks), torch.from_numpy(vp),
        torch.from_numpy(vs), li, torch.from_numpy(table), torch.from_numpy(lengths),
        new_kv=None if nkv is None else tuple(map(torch.from_numpy, nkv)),
        window=window, softcap=softcap)
    assert np.abs(bad.numpy() - got.numpy()).max() > 1e-2


# ------------------------------------------------------------ decode writes


def test_decode_writes_pool_bytes_equal_jax():
    """Ingest a prefill scratch, then three decode steps: per layer the same
    float k and v go through the JAX package's staged write and flush and
    through the port's in-place write; the rows take even and odd offsets
    and cross a page boundary, and one row is retired (page 0, offset 0).
    Pools equal on every page but page 0 after the ingest and every step;
    the attention outputs agree."""
    jc = JL.LlamaConfig.tiny(**SHAPE, num_layers=1)
    tc = TL.LlamaConfig.tiny(**SHAPE, num_layers=1)
    rng = np.random.default_rng(3)
    L, H, D, S, P, NP, B = jc.num_layers, jc.num_kv_heads, jc.hd, jc.max_seq_len, 128, 7, 3
    je = JEngine(jc, JL.init_params(jc, jax.random.PRNGKey(0)),
                 JEngineConfig(max_batch=B, paged=True, num_pages=NP))
    scratch = {
        "k": rng.integers(-127, 128, (L, B, H, D, S)).astype(np.int8),
        "v": rng.integers(-127, 128, (L, B, H, S, D)).astype(np.int8),
        "k_scale": rng.uniform(0, 1, (L, B, H, S)).astype(np.float32),
        "v_scale": rng.uniform(0, 1, (L, B, H, S)).astype(np.float32),
    }
    lens = np.asarray([127, 130, 5], np.int32)  # the first row crosses into its second page
    page_ids = np.asarray([[3, 6], [2, 5], [1, 1]], np.int32)
    used = np.asarray([2, 2, 1], np.int32)
    valid = np.ones((B,), bool)
    jpool = je._paged_insert(je.cache, {k: jnp.asarray(v) for k, v in scratch.items()},
                             jnp.asarray(page_ids), jnp.asarray(used), jnp.asarray(valid),
                             jnp.arange(B, dtype=jnp.int32), jnp.asarray(lens))
    tpool = TP.paged_ingest(TP.init_page_pool(tc, NP, P, "cpu"),
                            {k: torch.from_numpy(v) for k, v in scratch.items()},
                            page_ids, used, valid)

    def same_pools():
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(np.asarray(jpool[key])[:, 1:], tpool[key][:, 1:].numpy())

    same_pools()
    pos = lens.copy()
    for step in range(3):
        live = np.asarray([True, True, step < 2])  # the last row retires after two steps
        wp = np.asarray([page_ids[b][p // P] if live[b] else 0 for b, p in enumerate(pos)],
                        np.int32)
        wo = np.where(live, pos % P, 0).astype(np.int32)
        table = page_ids
        q = rng.normal(size=(B, 1, 2, D)).astype(np.float32)
        k = rng.normal(size=(L, B, 1, H, D)).astype(np.float32)
        v = rng.normal(size=(L, B, 1, H, D)).astype(np.float32)
        positions = pos.reshape(B, 1)
        jcache = JL.init_pend(dict(jpool, page_table=jnp.asarray(table), write_page=jnp.asarray(wp),
                                   write_off=jnp.asarray(wo)))
        tcache = dict(tpool, page_table=torch.from_numpy(table), write_page=torch.from_numpy(wp),
                      write_off=torch.from_numpy(wo))
        for li in range(L):
            ja, jcache = JL._paged_write_and_attend(jcache, li, jnp.asarray(q), jnp.asarray(k[li]),
                                                    jnp.asarray(v[li]), jnp.asarray(positions), jc)
            ta, tcache = TL._paged_write_and_attend(tcache, li, torch.from_numpy(q),
                                                    torch.from_numpy(k[li]),
                                                    torch.from_numpy(v[li]),
                                                    torch.from_numpy(positions), tc)
            np.testing.assert_allclose(ta.float().numpy()[live], np.asarray(ja, np.float32)[live],
                                       **TOL)
        jcache = JL.flush_paged_writes(jcache)
        jpool = {k: jcache[k] for k in jpool}
        same_pools()
        pos = pos + live


# ------------------------------------------------------------ engines


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= KV4_LOGIT_TOL * scale, (np.abs(got - want).max(), scale)
    assert np.linalg.norm(got - want) <= KV4_LOGIT_REL_L2 * np.linalg.norm(want)


_J_FORWARD = jax.jit(JL.llama_forward, static_argnums=1)


def _jax_decode_logged(eng, log):
    """The JAX paged engine with its decode step rebuilt from the same
    llama_forward, so that it also reports its logits."""
    def decode_step(params, pool, page_table, write_page, write_off, tokens, positions, key,
                    ids, pages_hint):
        cache = dict(pool, page_table=page_table, write_page=write_page, write_off=write_off)
        cfg = dataclasses.replace(eng.mcfg, pages_hint=pages_hint)
        logits, cache = _J_FORWARD(params, cfg, tokens, cache, positions)
        log.append(np.asarray(logits[:, 0]))
        return jnp.argmax(logits[:, 0], -1).astype(jnp.int32), {k: cache[k] for k in pool}

    eng._paged_decode = decode_step
    return eng


# (model options, engine options): the memory-lean NF4 setting (compressed
# statistics, kv4 pages) served with chunked prefill on the transient int8
# repack (8-token chunks: the 9-token prompt takes two)
ENGINES = {
    "compressed-chunked-w8a8": (dict(compress_stats=True), dict(prefill_chunk=8, w8a8_prefill=True)),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_kv4_engine_matches_jax(monkeypatch, name):
    """The kv4 paged engine against the JAX kv4 paged engine (the prompts
    of the JAX package's kv4 engine test), both fed the JAX engine's
    tokens: the pool is uint8 with P/2 byte rows; every decode step's
    logits and greedy tokens as the module note says; after the prefill
    and every step, every page but page 0 holds codes within one step of
    JAX's."""
    monkeypatch.setattr(JL, "_use_fused_decode_attn", lambda cfg: True)
    mkw, ekw = ENGINES[name]
    jc, tc = JL.LlamaConfig.tiny(**SHAPE, **mkw), TL.LlamaConfig.tiny(**SHAPE, **mkw)
    jp = jax.jit(JL.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0))  # eager: ~4x the time
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    steps = 3
    jlog, tlog = [], []
    je = _jax_decode_logged(JEngine(jc, jp, JEngineConfig(max_batch=2, paged=True, **ekw)), jlog)
    te = InferenceEngine(tc, tp, EngineConfig(max_batch=2, paged=True, **ekw), device="cpu")
    sample = te._sample
    te._sample = lambda logits: (tlog.append(logits.numpy().copy()), sample(logits))[1]
    assert te.cache["v"].dtype == torch.uint8 and te.cache["v"].shape[3] == 64
    # the contiguous cache stays int8 at kv_bits=4, as the JAX package's
    contiguous = InferenceEngine(tc, tp, EngineConfig(max_batch=2), device="cpu").cache
    assert contiguous["k"].dtype == torch.int8
    assert JEngine(jc, jp, JEngineConfig(max_batch=2)).cache["k"].dtype == jnp.int8
    prompts = PROMPTS
    je.add_requests(prompts, max_new_tokens=steps + 1)
    te.add_requests(prompts, max_new_tokens=steps + 1)

    def pools_close():
        for key in ("k", "v"):
            a, b = _nib_codes(np.asarray(je.cache[key])[:, 1:]), _nib_codes(te.cache[key][:, 1:])
            d = np.abs(a - b)
            assert d.max() <= 1 and (d > 0).mean() < 0.03, (key, d.max(), (d > 0).mean())
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(te.cache[key][:, 1:].numpy(),
                                       np.asarray(je.cache[key])[:, 1:], rtol=5e-2)

    pools_close()
    for _ in range(steps):
        te._last_tokens = je._last_tokens.copy()  # both engines see the same tokens
        je.step()
        te.step()
        pools_close()
    assert len(jlog) == steps and len(tlog) == steps + 1  # the port's first is the prefill's
    equal = 0
    for i in range(steps):
        _close_logits(tlog[i + 1], jlog[i])
        for row, p in enumerate(prompts):
            a, b = je.slot_tokens[row][len(p) + 1 + i], te.slot_tokens[row][len(p) + 1 + i]
            logits = jlog[i][row]
            top2 = np.sort(logits)[-2:]
            if a != b:
                assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(logits).max(), (row, i)
            equal += a == b
    assert equal >= steps
