"""Launch plans of kernels B (``mm4_plan``), G (``grouped_plan``), C
(``prefill_plan``), D (``paged_plan``), H (``decode_plan``), A
(``gemv_plan``), F (``dequant8_plan``) and I (``int8_plan``): plain Python
that picks a body, a tile and a split from the call's dtype and shape. For
B and G each case checks that the grid covers every output tile once, that
the K splits partition the quantization blocks in order within a plane,
and that the body is the one the shape and dtype call for; for C the body;
for D and H the body and that the splits partition a row's used pages or
tiles; for A the body, its row tile and that the splits partition the
64-row stages; for F that the persistent CTAs take every tile once and the
tiles write every output byte once; for I the wgmma width, that the
splits partition the 128-byte K steps, and the stage bytes and ring the
kernel takes."""

import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu_torch.ops.attention import DECODE_TILE, decode_plan, prefill_plan
from bitsandbytes_sycl_tpu_torch.ops.common import H100_SMS
from bitsandbytes_sycl_tpu_torch.ops.matmul_4bit import mm4_plan
from bitsandbytes_sycl_tpu_torch.ops.matmul_int8 import (INT8_SMEM, INT8_WIDTHS, int8_plan,
                                                         int8_split_plan)
from bitsandbytes_sycl_tpu_torch.ops.matmul_w4a8 import (DEQ8_COLS, DEQ8_ROWS, GEMV_FUSED_MAX_M,
                                                         Dequant8Plan, deq8_smem, dequant8_plan,
                                                         gemv_plan, grouped_plan)
from bitsandbytes_sycl_tpu_torch.ops.paged_attention import paged_plan

SHAPES_7B = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]

CASES = (
    # kernel B: the 7B shapes at the row counts of decode (a8_decode=False),
    # the 256-row prefill and the 1024-row exact path; edge shapes
    [("B", M, N, K, 64, torch.bfloat16) for N, K in SHAPES_7B for M in (1, 4, 256, 1024)]
    + [("B", M, 384, 1152, 64, torch.bfloat16) for M in (65, 129, 200, 1000)]
    + [("B", 129, 512, 1024, bs, torch.bfloat16) for bs in (8, 32, 128, 256)]
    + [("B", 256, 4096, 4096, 64, torch.float32), ("B", 67, 384, 1152, 64, torch.float32),
       ("B", 300, 256, 1040, 8, torch.bfloat16)]
    # kernel B on compressed scales ("Bc"): the rows of the lean decode and
    # prefill, and the QLoRA step's 2048
    + [("Bc", M, N, K, 64, torch.bfloat16) for N, K in SHAPES_7B for M in (4, 256, 1024, 2048)]
    + [("Bc", 256, 4096, 4096, 64, torch.float32), ("Bc", 129, 512, 1024, 128, torch.bfloat16)]
    # kernel G: the 7B shapes at the grouped route's row counts; edge shapes
    + [("G", M, N, K, bs, torch.bfloat16) for N, K in SHAPES_7B for M in (300, 512, 2048)
       for bs in (64, 128)]
    + [("G", M, 384, 1152, 64, torch.bfloat16) for M in (1, 67, 600)]
    + [("G", 300, 256, 1024, 16, torch.bfloat16), ("G", 257, 256, 1024, 32, torch.bfloat16),
       ("G", 300, 256, 1088, 32, torch.bfloat16), ("G", 300, 256, 1040, 8, torch.bfloat16)]
)


def _ids(case):
    k, M, N, K, bs, dt = case
    return f"{k}-M{M}-N{N}-K{K}-bs{bs}-{str(dt).split('.')[-1]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_launch_plan(case):
    kernel, M, N, K, bs, dt = case
    half = K // 2
    if kernel in ("B", "Bc"):
        plan = mm4_plan(M, N, K, bs, dt, H100_SMS, kernel == "Bc")
        fast = dt == torch.bfloat16 and half % 32 == 0 and bs % 8 == 0 and (
            bs % 32 == 0 or 32 % bs == 0)
        assert plan.body == ("tc" if fast else "simt")
        if plan.body == "tc":
            # compressed scales: the 128 x 256 tile has no room for the decode table
            tiles = ((64, 128), (128, 128), (256, 128)) + (() if kernel == "Bc" else ((128, 256),))
            assert (plan.bm, plan.bn) in tiles
            rows = 32  # packed rows per K step
        else:
            assert (plan.bm, plan.bn) == (4, 128)
    else:
        plan = grouped_plan(M, N, K, bs, H100_SMS)
        fast = half % 64 == 0 and bs % 16 == 0 and (bs % 64 == 0 or 64 % bs == 0)
        assert plan.body == ("wgmma" if fast else "mma_sync")
        assert (plan.bm, plan.bn) == ((256, 128) if fast else (128, 128))
        assert fast or plan.ksplit == 1
        rows = 64
    # every output tile exactly once: the grid (N / bn, ceil(M / bm)) tiles
    # rows and columns without overlap or gap
    assert N % plan.bn == 0
    m_tiles = -(-M // plan.bm)
    covered = sorted(r for y in range(m_tiles) for r in range(y * plan.bm, min(M, (y + 1) * plan.bm)))
    assert covered == list(range(M))
    # the K splits: contiguous ranges of packed rows, in order, none empty,
    # covering the half-plane (each split takes the same rows of both
    # planes, so none straddles a plane), with boundaries on quantization
    # blocks
    if plan.body == "simt":  # 8 warps x per quantization blocks a split
        bounds = [min(s * 8 * plan.per * bs, half) for s in range(plan.ksplit + 1)]
    else:
        steps = -(-half // rows)
        bounds = [min(s * plan.per, steps) * rows for s in range(plan.ksplit + 1)]
        bounds = [min(b, half) for b in bounds]
    assert plan.ksplit >= 1 and plan.per >= 1
    assert bounds[0] == 0 and bounds[-1] == half
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    assert all(b % bs == 0 for b in bounds[:-1])
    # the SMs are filled: at 256 (B) or 512 (G) rows at N = 4096 the
    # launch has at least one wave of 128 CTAs; 132 would start a second,
    # mostly empty wave, which measured slower on the H100
    if (kernel, M, N) in (("B", 256, 4096), ("G", 512, 4096)) and fast:
        ctas = (N // plan.bn) * m_tiles * plan.ksplit
        assert ctas >= 128 and ctas <= 2 * H100_SMS


# kernel C: (D, S, q dtype) -> body. The tensor-core body takes bf16 q at
# D = 128 over a whole number of 64-key tiles, whatever the batch and the
# prompt length; f32 q, D = 256 and other S keep the SIMT body.
PREFILL_CASES = [
    ((128, 2048, torch.bfloat16), "tc"),
    ((128, 4096, torch.bfloat16), "tc"),
    ((128, 256, torch.bfloat16), "tc"),
    ((128, 64, torch.bfloat16), "tc"),
    ((128, 2048, torch.float32), "simt"),
    ((256, 256, torch.bfloat16), "simt"),
    ((256, 2048, torch.float32), "simt"),
    ((128, 2000, torch.bfloat16), "simt"),
]


@pytest.mark.parametrize("case,body", PREFILL_CASES, ids=lambda c: str(c))
def test_prefill_plan(case, body):
    D, S, dt = case
    assert prefill_plan(D, S, dt) == body


# kernel D: (B, Hkv, MAXP, P, D, rep) -> body. The split body takes D = 128
# or 256, rep 1, 2, 4 with rep * D <= 512 and whole 128-token pages whose K
# and V fit one 64 KB ring slot (P * D <= 32768).
PAGED_CASES = (
    [((B, 32, 16, 128, 128, 1), "split") for B in (1, 2, 4, 8, 16, 32, 64)]  # 7B, 2048 tokens
    + [((4, 32, 32, 128, 128, 1), "split"), ((4, 8, 16, 128, 128, 4), "split"),
       ((2, 2, 4, 128, 128, 2), "split"), ((2, 2, 4, 128, 256, 2), "split"),
       ((4, 32, 1, 128, 128, 1), "split"), ((4, 32, 16, 256, 128, 1), "split")]
    + [((4, 8, 16, 128, 128, 8), "simt"), ((2, 2, 4, 128, 256, 4), "simt"),
       ((2, 2, 4, 64, 128, 1), "simt"), ((2, 2, 4, 128, 512, 1), "simt"),
       ((2, 2, 4, 256, 256, 1), "simt")]
)


@pytest.mark.parametrize("hint", [None, 1, 3, 8, 40], ids=lambda h: f"hint{h}")
@pytest.mark.parametrize("case,body", PAGED_CASES, ids=lambda c: str(c))
def test_paged_plan(case, body, hint):
    B, Hkv, MAXP, P, D, rep = case
    plan = paged_plan(B, Hkv, MAXP, P, D, rep, H100_SMS, pages_hint=hint)
    assert plan.body == body
    if body == "simt":
        assert plan.nsplit == 1
        return
    # no more splits than the host-known page bound: the table width, or
    # the engine's page horizon where it is given (clamped to [1, MAXP])
    pages = MAXP if hint is None else min(hint, MAXP)
    assert 1 <= plan.nsplit <= pages
    # rows split only to fill the SMs: about one CTA per SM, never fewer
    # than one per row and kv head
    ctas = B * Hkv * plan.nsplit
    assert ctas <= max(H100_SMS, B * Hkv)
    assert ctas > H100_SMS - B * Hkv or plan.nsplit == pages
    if (Hkv, MAXP, hint) == (32, 16, None):  # 7B: B = 1 and 2 split S, B >= 4 fills the SMs
        assert (plan.nsplit > 1) == (B < 4)
    # the kernel's shares of a row's used pages u (at most MAXP, whatever
    # the hint): contiguous, in order, together every used page once
    for u in range(1, MAXP + 1):
        bounds = [z * u // plan.nsplit for z in range(plan.nsplit + 1)]
        assert bounds[0] == 0 and bounds[-1] == u
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))


# kernel H: (B, Hkv, S, D, rep, q dtype) -> body. The split body takes f32
# or bf16 q at D = 128, rep 1, 2 or 4 and S % 16 == 0 (its TMA row stride);
# rep 8, D = 256 and other S keep the SIMT body.
DECODE_CASES = (
    [((B, 32, 2048, 128, 1, torch.bfloat16), "split") for B in (1, 2, 4, 8, 16, 32)]  # 7B
    + [((4, 8, 2048, 128, 4, torch.bfloat16), "split"), ((4, 16, 2048, 128, 2, torch.bfloat16), "split"),
       ((2, 2, 384, 128, 1, torch.float32), "split"), ((2, 2, 400, 128, 4, torch.float32), "split"),
       ((1, 1, 16, 128, 1, torch.bfloat16), "split"), ((3, 4, 4096, 128, 2, torch.bfloat16), "split")]
    + [((4, 8, 2048, 128, 8, torch.bfloat16), "simt"), ((2, 2, 384, 256, 1, torch.float32), "simt"),
       ((2, 2, 384, 256, 2, torch.bfloat16), "simt"), ((2, 2, 388, 128, 1, torch.bfloat16), "simt"),
       ((2, 2, 392, 128, 2, torch.float32), "simt"), ((4, 32, 2048, 128, 1, torch.float16), "simt")]
)


@pytest.mark.parametrize("case,body", DECODE_CASES, ids=lambda c: str(c))
def test_decode_plan(case, body):
    B, Hkv, S, D, rep, dt = case
    plan = decode_plan(B, Hkv, S, D, rep, dt, H100_SMS)
    assert plan.body == body
    if body == "simt":
        assert plan.nsplit == 1
        return
    # never more splits than the cache has tiles; rows split only to fill
    # the SMs: about one CTA per SM, never fewer than one per row and kv head
    tiles = -(-S // DECODE_TILE)
    assert 1 <= plan.nsplit <= tiles
    ctas = B * Hkv * plan.nsplit
    assert ctas <= max(H100_SMS, B * Hkv)
    assert ctas > H100_SMS - B * Hkv or plan.nsplit == tiles
    if (Hkv, S, rep) == (32, 2048, 1):  # 7B: B = 1 and 2 split, B >= 4 fills the SMs
        assert (plan.nsplit > 1) == (B < 4)
    # the plan reads no lengths: the kernel's shares of any row's tiles
    # [t, t + n) (n at most the cache's tiles) are contiguous, in order and
    # cover every tile once, empty shares allowed
    for n in range(0, tiles + 1):
        bounds = [z * n // plan.nsplit for z in range(plan.nsplit + 1)]
        assert bounds[0] == 0 and bounds[-1] == n
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))


def test_decode_plan_takes_no_lengths():
    """decode_plan's inputs are host-known sizes: the same call gives the
    same plan whatever the rows' lengths are, so a decode step never waits
    for the card to read them."""
    import inspect

    assert list(inspect.signature(decode_plan).parameters) == [
        "B", "Hkv", "S", "D", "rep", "q_dtype", "sms"]


# kernel A: (M, N, K, bs) -> body. The fused body takes M <= 8 rows at
# blocksize 32 or 64 with N and K multiples of 128; other rows (up to 128)
# and blocksizes keep the SIMT body.
GEMV_CASES = (
    [((M, N, K, 64), "fused") for N, K in SHAPES_7B for M in (1, 2, 3, 4, 5, 8)]
    + [((M, N, K, 64), "simt") for N, K in SHAPES_7B for M in (9, 16, 64, 128)]
    + [((1, 384, 1152, 64), "fused"), ((8, 256, 1152, 32), "fused"), ((4, 256, 2048, 32), "fused"),
       ((4, 256, 1024, 128), "simt"), ((4, 256, 1024, 16), "simt"), ((3, 384, 512, 256), "simt")]
)


@pytest.mark.parametrize("case,body", GEMV_CASES, ids=lambda c: str(c))
def test_gemv_plan(case, body):
    M, N, K, bs = case
    plan = gemv_plan(M, N, K, bs, H100_SMS)
    assert plan.body == body
    assert plan.ksplit >= 1 and plan.per >= 1
    if body == "simt":
        assert plan.bm == 4
        # 8 warps x per quantization blocks a split, in order, covering a plane
        nbh = K // (2 * bs)
        bounds = [min(s * 8 * plan.per, nbh) for s in range(plan.ksplit + 1)]
        assert bounds[-1] == nbh and all(a < b for a, b in zip(bounds, bounds[1:]))
        return
    assert M <= GEMV_FUSED_MAX_M and plan.bm in (1, 2, 4, 8) and plan.bm >= M > plan.bm // 2
    # the K splits: whole 64-row stages, in order, none empty, covering the
    # half-plane once; no more splits than stages; quantized x within 32 KB
    steps = K // 2 // 64
    bounds = [min(s * plan.per, steps) for s in range(plan.ksplit + 1)]
    assert bounds[0] == 0 and bounds[-1] == steps
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    assert plan.ksplit <= steps
    assert plan.bm * 2 * plan.per * 64 <= 32768
    # at the 7B shapes the grid holds about one CTA per SM
    if (N, K) in SHAPES_7B:
        ctas = N // 128 * plan.ksplit
        assert H100_SMS // 2 <= ctas <= 2 * H100_SMS


# kernel F: (N, K, bs) -> the tiled body where bs % 16 == 0 and N % 16 ==
# 0, else the stride body. The tiled body's persistent CTAs walk the tiles
# (CTA b: tiles b, b + grid, ...; tile t at packed rows from
# (t // ceil(N / 128)) * DEQ8_ROWS, columns from (t % ceil(N / 128)) * 128).
DEQ8_CASES = (
    [(N, K, bs) for N, K in SHAPES_7B for bs in (64, 128)]
    + [(384, 1152, 64), (256, 1024, 16), (512, 1536, 48), (4096, 4160, 32), (512, 1024, 96),
       (256, 1024, 8), (260, 1024, 64), (384, 1040, 4), (384, 1152, 8), (400, 1152, 64),
       (144, 1024, 64), (272, 2080, 16), (4112, 4096, 128), (128, 256, 128)]
)


@pytest.mark.parametrize("case", DEQ8_CASES, ids=lambda c: "N{}-K{}-bs{}".format(*c))
def test_dequant8_plan(case):
    N, K, bs = case
    half = K // 2
    plan = dequant8_plan(N, K, bs, H100_SMS)
    if bs % 16 or N % 16:
        assert plan == Dequant8Plan("stride", 0)
        return
    assert plan.body == "tiled"
    assert deq8_smem(bs) <= 227 * 1024 - 1024
    ntn, ntj = -(-N // DEQ8_COLS), -(-half // DEQ8_ROWS)
    tiles = ntn * ntj
    assert 1 <= plan.grid <= tiles
    if (N, K) in SHAPES_7B:  # every SM holds as many CTAs as fit its shared memory
        assert plan.grid >= H100_SMS
    # each tile once, over all CTAs
    seen = np.zeros(tiles, np.int64)
    for b in range(plan.grid):
        seen[b::plan.grid] += 1
    assert (seen == 1).all()
    # the tiles' packed boxes, clipped to the weight, partition (K/2, N):
    # distinct lattice origins and clipped areas that sum to the whole
    t = np.arange(tiles)
    j0, n0 = t // ntn * DEQ8_ROWS, t % ntn * DEQ8_COLS
    assert len(set(zip(j0.tolist(), n0.tolist()))) == tiles
    area = (np.minimum(j0 + DEQ8_ROWS, half) - j0) * (np.minimum(n0 + DEQ8_COLS, N) - n0)
    assert (area > 0).all() and int(area.sum()) == half * N
    # every output byte (n, k) once across both planes: a tile writes rows
    # n0.. of the hi half at k = j0.. and of the lo half at K/2 + j0..
    out = np.zeros((N, K), np.int8) if N * K <= 1 << 24 else None
    if out is not None:
        for jj, nn in zip(j0.tolist(), n0.tolist()):
            for base in (0, half):
                out[nn:nn + DEQ8_COLS, base + jj:base + min(jj + DEQ8_ROWS, half)] += 1
        assert (out == 1).all()


def _check_int8_stages(plan, N, K):
    """The stage bytes and ring the kernel takes: 256 or 128 bytes a stage
    at width 8 and 64 above, dividing K and a split's bytes; the whole
    ring budget exactly where the grid has one CTA per SM; and the 3-12
    slots of the ring (a slot: 128 weight rows, the raw x rows at 2 or 4
    bytes an element and their codes, 1 KB aligned) within the kernel's
    shared memory."""
    assert plan.kb in ((256, 128) if plan.width == 8 else (64,))
    assert K % plan.kb == 0 and plan.per * 128 % plan.kb == 0
    alone = -(-N // 128) * plan.ksplit <= H100_SMS
    assert (plan.ring == INT8_SMEM - 1024) == alone
    assert plan.kb != 256 or alone
    for esz in (2, 4):
        slot = -(-(128 * plan.kb + plan.width * plan.kb * esz + plan.width * plan.kb) // 1024) * 1024
        slots = min(12, max(3, plan.ring // slot))
        assert 1024 + slots * slot <= INT8_SMEM


# kernel I: (M, N, K) -> wgmma width, K splits, stage bytes and ring. The
# width is the least that wgmma takes for s8 at or above M; the splits
# partition the 128-byte K steps in order, none empty; the 7B shapes fill
# the SMs.
INT8_CASES = (
    [(M, N, K) for N, K in SHAPES_7B for M in (1, 4, 8, 32, 128)]
    + [(M, 192, 384) for M in (1, 17, 67, 100, 128)]
    + [(2, 4096, 128), (128, 64, 128), (9, 128, 256), (64, 8192, 28672)]
)


@pytest.mark.parametrize("case", INT8_CASES, ids=lambda c: "M{}-N{}-K{}".format(*c))
def test_int8_plan(case):
    M, N, K = case
    plan = int8_plan(M, N, K, H100_SMS)
    assert plan.width in INT8_WIDTHS and plan.width >= M
    assert all(w < M for w in INT8_WIDTHS if w < plan.width)
    steps = K // 128
    bounds = [min(s * plan.per, steps) for s in range(plan.ksplit + 1)]
    assert bounds[0] == 0 and bounds[-1] == steps
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    assert 1 <= plan.ksplit <= steps
    _check_int8_stages(plan, N, K)
    if (N, K) in SHAPES_7B:
        ctas = -(-N // 128) * plan.ksplit
        assert H100_SMS // 2 <= ctas <= 2 * H100_SMS


# kernel I at a forced split count (the probe's and the race check's
# plans): whole splits of ceil(steps / ks) steps, and stages the kernel takes
INT8_SPLIT_CASES = (
    [(M, N, K, ks) for M in (4, 128) for N, K in ((4096, 4096), (32000, 4096))
     for ks in (1, 3, 4, 16)]
    + [(40, 4096, 11008, 2), (8, 11008, 4096, 6), (1, 192, 384, 3)]
)


@pytest.mark.parametrize("case", INT8_SPLIT_CASES, ids=lambda c: "M{}-N{}-K{}-ks{}".format(*c))
def test_int8_split_plan(case):
    M, N, K, ks = case
    plan = int8_split_plan(M, N, K, ks, H100_SMS)
    steps = K // 128
    assert plan.per == -(-steps // ks) and plan.ksplit == -(-steps // plan.per) <= ks
    assert (plan.ksplit - 1) * plan.per < steps <= plan.ksplit * plan.per
    assert plan.width == int8_plan(M, N, K, H100_SMS).width
    _check_int8_stages(plan, N, K)
