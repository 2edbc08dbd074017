"""The attention shapes of the port's kernels C, D and H on the CPU.

- The wrappers' shape guards (``prefill_kernel_takes``,
  ``decode_kernel_takes``, ``paged_kernel_takes``) accept every shape that
  the JAX package's predicates (``prefill_attention_ok``,
  ``decode_attention_ok``, ``paged_attention_ok``) accept, over a grid of
  group sizes 1-16, head dims 64-1024 and S, P in {128, 256}, with no
  difference kept. A guard that refused a shape the predicate takes would
  raise where the JAX package attends on its kernel.
- Kernels H and D's plain versions (what their CUDA bodies are held to on
  the card) at group sizes 3 and 7 and head_dim 384 (and H at 640), H's and
  C's at head_dim 256 with a group of 2, softcap and a window, against the
  JAX kernels in interpret mode, f32 outputs within 2e-5 (the same f32
  scores, one-shot softmax in both).
- The single-layer ``prefill_attention_int8`` (kernel C on a one-layer
  view) against the JAX entry with ALiBi, and None where the JAX entry
  declines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu.ops.attention import decode_attention_int8_stacked as j_decode
from bitsandbytes_sycl_tpu.ops.attention import prefill_attention_int8 as j_prefill1
from bitsandbytes_sycl_tpu.ops.attention import prefill_attention_int8_stacked as j_prefill
from bitsandbytes_sycl_tpu.ops.paged_attention import paged_decode_attention_int8_stacked as j_paged
from bitsandbytes_sycl_tpu_torch.ops import attention as TA
from bitsandbytes_sycl_tpu_torch.ops import paged_attention as TP

TOL = dict(rtol=2e-5, atol=2e-5)
REPS = range(1, 17)
DIMS = range(64, 1025, 64)
SIZES = (128, 256)
HKV = 2


def test_guards_accept_what_the_jax_predicates_accept():
    kept, checked = set(), 0
    for rep in REPS:
        Hq = rep * HKV
        for D in DIMS:
            for S in SIZES:
                for T in (8, S):
                    if TA.prefill_attention_ok(T, S, D, Hq, HKV):
                        checked += 1
                        if not TA.prefill_kernel_takes(T, S, D, Hq, HKV):
                            kept.add(("C", D))
                if TA.decode_attention_ok(1, S, D, Hq, HKV):
                    checked += 1
                    if not TA.decode_kernel_takes(S, D, rep):
                        kept.add(("H", D))
                for rows in (S, S // 2):  # int8 and kv4 pages of P = S tokens
                    if TP.paged_attention_ok(1, D, Hq, HKV, S, rows):
                        checked += 1
                        assert TP.paged_kernel_takes(D, rep, S), (rep, D, S)
    assert checked > 1000
    assert kept == set()


@pytest.mark.parametrize("rep", REPS)
def test_plans_cover_every_group_size(rep):
    """Each body's head groups cover rep with the group sizes its C entry
    is built for; the plans keep rep 1, 2, 4 and 8 on the bodies they had
    and give every other rep the split bodies."""
    for body, sizes in (("split", (1, 2, 4)), ("simt", (1, 2, 4, 8))):
        g, n = TA.decode_groups(rep, body)
        assert g in sizes and g * n >= rep > g * (n - 1)
    for D, largest in ((128, 4), (256, 2), (384, 8)):
        body = TP.paged_plan(2, HKV, 4, 128, D, rep, 132).body
        g, n = TP.paged_groups(rep, D, body)
        assert g <= (largest if body == "split" else 8) and g * n >= rep > g * (n - 1)
        assert body == ("split" if D in (128, 256) and (rep * D <= 512 or rep not in (1, 2, 4, 8))
                        else "simt")
    plan = TA.decode_plan(2, HKV, 256, 128, rep, torch.bfloat16, 132)
    assert plan.body == ("simt" if rep == 8 else "split") and plan.nsplit >= 1
    # from head_dim 256 H's split body (in clusters past 256) takes every
    # group size, rep 8 too
    for D in (256, 384, 512, 640, 1024):
        plan = TA.decode_plan(2, HKV, 256, D, rep, torch.bfloat16, 132)
        assert plan.body == "split" and plan.nsplit >= 1
    # C's tensor-core body (a cluster of CTAs past 512) serves every group
    # size at every head dim
    for D in (128, 256, 384, 512, 640, 1024):
        assert TA.prefill_plan(D, 256, torch.bfloat16) == "tc"


def _kv(rng, *lead, S, D):
    return (rng.integers(-127, 128, (*lead, D, S)).astype(np.int8),
            rng.uniform(1.0, 3.0, (*lead, S)).astype(np.float32),  # O(1) scores
            rng.integers(-127, 128, (*lead, S, D)).astype(np.int8),
            rng.uniform(0.5, 2.0, (*lead, S)).astype(np.float32))


def _new_kv(rng, B, D):
    return (rng.integers(-127, 128, (B, HKV, D)).astype(np.int8),
            rng.uniform(1.0, 3.0, (B, HKV)).astype(np.float32),
            rng.integers(-127, 128, (B, HKV, D)).astype(np.int8),
            rng.uniform(0.5, 2.0, (B, HKV)).astype(np.float32))


def _pair(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.asarray(a)) for a in arrays]


# Gemma-2's options at head_dim 256 (softcap and a window that binds)
OPTIONS = {(2, 256): dict(softcap=50.0, window=100)}


@pytest.mark.parametrize("rep,D", [(3, 384), (7, 128), (3, 640), (2, 256)])
def test_decode_plain_matches_jax_kernel(rep, D):
    """Kernel H's plain version at B = 2, S = 128 (a full row and a ragged
    one), the step's token folded in, ALiBi slopes per q head; at head_dim
    256 with a group of 2 (Gemma-2-9B's), softcap and a window too."""
    rng = np.random.default_rng(40 + rep)
    B, S = 2, 128
    opt = OPTIONS.get((rep, D), {})
    q = rng.normal(size=(B, 1, HKV * rep, D)).astype(np.float32)
    slopes = rng.uniform(0.01, 0.5, (HKV * rep,)).astype(np.float32)
    lengths = np.asarray([S - 1, 70], np.int32)
    (jq, *jc, jl, js), (tq, *tc, tl, ts) = _pair([q, *_kv(rng, 2, B, HKV, S=S, D=D), lengths,
                                                  slopes])
    jn, tn = _pair(_new_kv(rng, B, D))
    want = j_decode(jq, *jc, 1, jl, new_kv=jn, alibi_slopes=js, **opt)
    got = TA.decode_attention_int8_stacked(tq, *tc, 1, tl, new_kv=tn, alibi_slopes=ts, **opt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rep,D", [(2, 256)])
def test_prefill_plain_matches_jax_kernel(rep, D):
    """Kernel C's plain version at B = 2, T = 16 from positions 0 and 90 of
    a 128-position cache, with ALiBi, softcap and a window that binds,
    against the JAX kernel in interpret mode (Gemma-2-9B's group of 2 at
    head_dim 256)."""
    rng = np.random.default_rng(70 + rep)
    B, T, S = 2, 16, 128
    opt = OPTIONS[(rep, D)]
    q = rng.normal(size=(B, T, HKV * rep, D)).astype(np.float32)
    starts = np.asarray([0, 90], np.int32)
    slopes = rng.uniform(0.01, 0.5, (HKV * rep,)).astype(np.float32)
    (jq, *jc, jst, js), (tq, *tc, tst, ts) = _pair([q, *_kv(rng, 2, B, HKV, S=S, D=D), starts,
                                                    slopes])
    want = j_prefill(jq, *jc, 1, jst, alibi_slopes=js, **opt)
    got = TA.prefill_attention_int8_stacked(tq, *tc, 1, tst, alibi_slopes=ts, **opt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rep,D", [(3, 384), (7, 128)])
def test_paged_plain_matches_jax_kernel(rep, D):
    """Kernel D's plain version at B = 2 over 128-token pages in a shuffled
    table, the step's token folded in, a window and ALiBi."""
    rng = np.random.default_rng(50 + rep)
    B, P, MAXP, NP = 2, 128, 2, 6
    q = rng.normal(size=(B, 1, HKV * rep, D)).astype(np.float32)
    kp = rng.integers(-127, 128, (2, NP, HKV, P, D)).astype(np.int8)
    vp = rng.integers(-127, 128, (2, NP, HKV, P, D)).astype(np.int8)
    ks = rng.uniform(1.0, 3.0, (2, NP, HKV, P)).astype(np.float32)
    vs = rng.uniform(0.5, 2.0, (2, NP, HKV, P)).astype(np.float32)
    table = rng.permutation(np.arange(1, NP))[: B * MAXP].reshape(B, MAXP).astype(np.int32)
    lengths = np.asarray([200, 90], np.int32)
    slopes = rng.uniform(0.01, 0.5, (HKV * rep,)).astype(np.float32)
    (jq, *jc, jt, jl, js), (tq, *tc, tt, tl, ts) = _pair(
        [q, kp, ks, vp, vs, table, lengths, slopes])
    jn, tn = _pair(_new_kv(rng, B, D))
    want = j_paged(jq, *jc, 0, jt, jl, new_kv=jn, window=150, alibi_slopes=js)
    got = TP.paged_decode_attention_int8_stacked(tq, *tc, 0, tt, tl, new_kv=tn, window=150,
                                                 alibi_slopes=ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_single_layer_prefill_matches_jax_with_alibi():
    rng = np.random.default_rng(60)
    B, T, S, D, rep = 2, 16, 128, 128, 2
    q = rng.normal(size=(B, T, HKV * rep, D)).astype(np.float32)
    starts = np.asarray([0, 40], np.int32)
    slopes = rng.uniform(0.01, 0.5, (HKV * rep,)).astype(np.float32)
    (jq, *jc, jst, js), (tq, *tc, tst, ts) = _pair([q, *_kv(rng, B, HKV, S=S, D=D), starts, slopes])
    want = j_prefill1(jq, *jc, jst, alibi_slopes=js)
    got = TA.prefill_attention_int8(tq, *tc, tst, alibi_slopes=ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # where the JAX entry declines (fewer than 8 query rows) both return None
    assert j_prefill1(jq[:, :4], *jc, jst) is None
    assert TA.prefill_attention_int8(tq[:, :4], *tc, tst) is None
