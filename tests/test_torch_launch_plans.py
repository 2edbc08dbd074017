"""Launch plans of kernels B (``mm4_plan``) and G (``grouped_plan``): plain
Python that picks a body, a tile and a split of K from the call's dtype and
shape. Each case checks that the grid covers every output tile once, that
the K splits partition the quantization blocks in order within a plane, and
that the body is the one the shape and dtype call for."""

import pytest
import torch

from bitsandbytes_sycl_tpu_torch.ops.common import H100_SMS
from bitsandbytes_sycl_tpu_torch.ops.matmul_4bit import mm4_plan
from bitsandbytes_sycl_tpu_torch.ops.matmul_w4a8 import grouped_plan

SHAPES_7B = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]

CASES = (
    # kernel B: the 7B shapes at the row counts of decode (a8_decode=False),
    # the 256-row prefill and the 1024-row exact path; edge shapes
    [("B", M, N, K, 64, torch.bfloat16) for N, K in SHAPES_7B for M in (1, 4, 256, 1024)]
    + [("B", M, 384, 1152, 64, torch.bfloat16) for M in (65, 129, 200, 1000)]
    + [("B", 129, 512, 1024, bs, torch.bfloat16) for bs in (8, 32, 128, 256)]
    + [("B", 256, 4096, 4096, 64, torch.float32), ("B", 67, 384, 1152, 64, torch.float32),
       ("B", 300, 256, 1040, 8, torch.bfloat16)]
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
    if kernel == "B":
        plan = mm4_plan(M, N, K, bs, dt, H100_SMS)
        fast = dt == torch.bfloat16 and half % 32 == 0 and bs % 8 == 0 and (
            bs % 32 == 0 or 32 % bs == 0)
        assert plan.body == ("tc" if fast else "simt")
        if plan.body == "tc":
            assert (plan.bm, plan.bn) in ((64, 128), (128, 128), (128, 256), (256, 128))
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
