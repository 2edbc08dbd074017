"""The port's int8-KV attention (kernels C and D, here their plain versions
on the CPU) against the JAX package's Pallas kernels in interpret mode, at
D = P = 128."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu.ops.attention import prefill_attention_int8_stacked as j_prefill
from bitsandbytes_sycl_tpu.ops.paged_attention import paged_decode_attention_int8_stacked as j_paged
from bitsandbytes_sycl_tpu_torch.ops.attention import prefill_attention_int8_stacked as t_prefill
from bitsandbytes_sycl_tpu_torch.ops.paged_attention import (
    paged_decode_attention_int8_stacked as t_paged,
)

# f32 outputs of two online/one-shot softmaxes over the same f32 scores:
# agreement to f32 rounding of sums over <= 512 keys
TOL = dict(rtol=2e-5, atol=2e-5)
SLOPES = np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.asarray(a)) for a in arrays]


def _cache(rng, Lyr, B, Hkv, S, D):
    kq = rng.integers(-127, 128, (Lyr, B, Hkv, D, S)).astype(np.int8)
    vq = rng.integers(-127, 128, (Lyr, B, Hkv, S, D)).astype(np.int8)
    # k scales make the scores O(1): q ~ N(0, 1) and codes uniform in
    # +-127 give q.k_i8 a spread of ~73 sqrt(D), times ks / (127 sqrt(D))
    ks = rng.uniform(1.0, 3.0, (Lyr, B, Hkv, S)).astype(np.float32)
    vs = rng.uniform(0.5, 2.0, (Lyr, B, Hkv, S)).astype(np.float32)
    return kq, ks, vq, vs


@pytest.mark.parametrize("opt", [
    dict(), dict(window=40), dict(softcap=5.0), dict(alibi=True), dict(sm_scale=0.05),
])
@pytest.mark.parametrize("gqa", [1, 2])
def test_prefill_matches_jax_kernel(gqa, opt):
    opt = dict(opt)
    rng = np.random.default_rng(10 + gqa)
    Lyr, B, T, S, Hkv, D = 2, 2, 32, 256, 2, 128
    q = rng.normal(size=(B, T, Hkv * gqa, D)).astype(np.float32)
    starts = np.asarray([0, 100], np.int32)
    alibi = SLOPES[: Hkv * gqa] if opt.pop("alibi", False) else None
    (jq, jk, jks, jv, jvs, jst), (tq, tk, tks, tv, tvs, tst) = _both(
        q, *_cache(rng, Lyr, B, Hkv, S, D), starts)
    for li in range(Lyr):  # layer select
        want = j_prefill(jq, jk, jks, jv, jvs, li, jst,
                         alibi_slopes=None if alibi is None else jnp.asarray(alibi), **opt)
        got = t_prefill(tq, tk, tks, tv, tvs, li, tst,
                        alibi_slopes=None if alibi is None else torch.from_numpy(alibi), **opt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_bf16_query_and_declines():
    rng = np.random.default_rng(3)
    kq, ks, vq, vs = _cache(rng, 1, 1, 1, 128, 128)
    q = rng.normal(size=(1, 16, 1, 128)).astype(np.float32)
    want = j_prefill(jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, (kq, ks, vq, vs)), 0,
                     jnp.zeros((1,), jnp.int32))
    got = t_prefill(torch.from_numpy(q).to(torch.bfloat16), *map(torch.from_numpy, (kq, ks, vq, vs)),
                    0, torch.zeros((1,), dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)
    # the shapes the JAX kernel declines (JAX then attends without it) raise
    kq64, ks64, vq64, vs64 = _cache(rng, 1, 1, 1, 128, 64)
    with pytest.raises(ValueError, match="D=64"):
        t_prefill(torch.zeros((1, 16, 1, 64)), *map(torch.from_numpy, (kq64, ks64, vq64, vs64)),
                  0, torch.zeros((1,), dtype=torch.int32))
    assert j_prefill(jnp.zeros((1, 4, 1, 128)), *map(jnp.asarray, (kq, ks, vq, vs)),
                     0, jnp.zeros((1,), jnp.int32)) is None  # T < 8
    with pytest.raises(ValueError, match="T=4"):
        t_prefill(torch.zeros((1, 4, 1, 128)), *map(torch.from_numpy, (kq, ks, vq, vs)),
                  0, torch.zeros((1,), dtype=torch.int32))


def _pool(rng, Lyr, NP, Hkv, P, D):
    kp = rng.integers(-127, 128, (Lyr, NP, Hkv, P, D)).astype(np.int8)
    vp = rng.integers(-127, 128, (Lyr, NP, Hkv, P, D)).astype(np.int8)
    ks = rng.uniform(1.0, 3.0, (Lyr, NP, Hkv, P)).astype(np.float32)  # O(1) scores, as above
    vs = rng.uniform(0.5, 2.0, (Lyr, NP, Hkv, P)).astype(np.float32)
    return kp, ks, vp, vs


@pytest.mark.parametrize("opt", [
    dict(), dict(window=100), dict(softcap=5.0), dict(alibi=True), dict(pages_hint=4),
])
@pytest.mark.parametrize("new", [False, True])
@pytest.mark.parametrize("gqa", [1, 2])
def test_paged_matches_jax_kernel(gqa, new, opt):
    opt = dict(opt)
    rng = np.random.default_rng(20 + gqa)
    Lyr, B, Hkv, D, P, MAXP = 2, 3, 2, 128, 128, 4
    NP = B * MAXP + 1
    pool = _pool(rng, Lyr, NP, Hkv, P, D)
    q = rng.normal(size=(B, 1, Hkv * gqa, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, NP)).reshape(B, MAXP).astype(np.int32)
    lengths = np.asarray([511, 0, 130], np.int32)  # a full table, len == 0, a page boundary
    new_kv = (rng.integers(-127, 128, (B, Hkv, D)).astype(np.int8),
              rng.uniform(1.0, 3.0, (B, Hkv)).astype(np.float32),
              rng.integers(-127, 128, (B, Hkv, D)).astype(np.int8),
              rng.uniform(0.5, 2.0, (B, Hkv)).astype(np.float32))
    alibi = SLOPES[: Hkv * gqa] if opt.pop("alibi", False) else None
    (jq, *jpool, jt, jl), (tq, *tpool, tt, tl) = _both(q, *pool, table, lengths)
    jn, tn = _both(*new_kv) if new else (None, None)
    for li in range(Lyr):
        want = j_paged(jq, *jpool, li, jt, jl, new_kv=jn,
                       alibi_slopes=None if alibi is None else jnp.asarray(alibi), **opt)
        got = t_paged(tq, *tpool, li, tt, tl, new_kv=tn,
                      alibi_slopes=None if alibi is None else torch.from_numpy(alibi), **opt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        if not new:
            assert not got[1].any()  # len == 0 without new_kv: zeros


def test_paged_new_kv_equals_write_then_read():
    """Folding this step's token in last equals writing it into its page
    first and attending one token longer: the engine writes early."""
    rng = np.random.default_rng(19)
    Lyr, B, Hkv, D, P, MAXP = 2, 3, 2, 128, 128, 4
    NP = B * MAXP + 1
    kp, ks, vp, vs = _pool(rng, Lyr, NP, Hkv, P, D)
    q = torch.from_numpy(rng.normal(size=(B, 1, 4, D)).astype(np.float32))
    table = np.arange(1, NP).reshape(B, MAXP).astype(np.int32)
    lengths = np.asarray([511, 200, 0], np.int32)
    kn = rng.integers(-127, 128, (B, Hkv, D)).astype(np.int8)
    vn = rng.integers(-127, 128, (B, Hkv, D)).astype(np.int8)
    ksn = rng.uniform(1.0, 3.0, (B, Hkv)).astype(np.float32)
    vsn = rng.uniform(0.5, 2.0, (B, Hkv)).astype(np.float32)
    li = 1
    got = t_paged(q, *map(torch.from_numpy, (kp, ks, vp, vs)), li, torch.from_numpy(table),
                  torch.from_numpy(lengths), new_kv=tuple(map(torch.from_numpy, (kn, ksn, vn, vsn))))
    for b in range(B):
        pos = int(lengths[b])
        pg, off = table[b, pos // P], pos % P
        kp[li, pg, :, off], vp[li, pg, :, off] = kn[b], vn[b]
        ks[li, pg, :, off], vs[li, pg, :, off] = ksn[b], vsn[b]
    want = t_paged(q, *map(torch.from_numpy, (kp, ks, vp, vs)), li, torch.from_numpy(table),
                   torch.from_numpy(lengths + 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_paged_declines_and_unported_kv4():
    rng = np.random.default_rng(4)
    kp, ks, vp, vs = _pool(rng, 1, 3, 1, 128, 64)
    args = [torch.from_numpy(a) for a in (kp, ks, vp, vs)]
    table, lens = torch.ones((1, 2), dtype=torch.int32), torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="D=64"):
        t_paged(torch.zeros((1, 1, 1, 64)), *args, 0, table, lens)
    # kv4 pages (P/2 byte rows) are ported (tests/test_torch_kv4.py); a pool
    # whose byte rows are neither P nor P/2 is declined
    kp4 = torch.zeros((1, 3, 1, 64, 128), dtype=torch.uint8)
    out = t_paged(torch.zeros((1, 1, 1, 128)), kp4, torch.zeros((1, 3, 1, 128)), kp4,
                  torch.zeros((1, 3, 1, 128)), 0, table, lens)
    assert out.shape == (1, 1, 1, 128) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="pages"):
        t_paged(torch.zeros((1, 1, 1, 128)), kp4[:, :, :, :32], torch.zeros((1, 3, 1, 128)),
                kp4[:, :, :, :32], torch.zeros((1, 3, 1, 128)), 0, table, lens)
