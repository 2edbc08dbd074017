"""The algebra of kernel A's tensor-core body on the CPU (``_tc_plain``):
64-column tiles and passes of at most 128 rows, 32-row k-steps summed into
exact int32 per plane, a block's sums folded into an f32 sum after bs / 32
k-steps with the scale row of the stage the block ends in (hi plane, then
lo, as fmaf does), the count of k-steps restarting with each K split, the
splits' f32 partials summed in split order, then the row scale and the
bias. Held against the one-shot plain version ``_w4a8_plain`` at M = 9,
33, 128 and 200 and blocksizes 32-256, 96 and 160 (a block spanning
stages unevenly; ragged last stages at 32 and 96), with the plan gemv_plan
picks and with the most splits it allows, and at blocksizes 96, 128 and
256 against the JAX package's kernel in interpret mode. Sums of the same
exact block dots in another order: within F32_TOL / BF16_TOL of
test_torch_matmul."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_sycl_tpu.ops import matmul_4bit_w4a8 as j_w4a8
from bitsandbytes_sycl_tpu.ops.common import quantize_4bit_native as j_quantize
from bitsandbytes_sycl_tpu_torch.ops import matmul_4bit_w4a8 as t_w4a8
from bitsandbytes_sycl_tpu_torch.ops.common import H100_SMS, LaunchPlan
from bitsandbytes_sycl_tpu_torch.ops.common import quantize_4bit_native as t_quantize
from bitsandbytes_sycl_tpu_torch.ops.matmul_w4a8 import (_int8_code_table, _quant_rows,
                                                         _w4a8_plain, gemv_plan)

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=2e-2)
STAGE = 64  # packed rows a stage


@pytest.fixture(autouse=True)
def _one_thread():
    """The model runs thousands of small ops: one thread each, so that test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fmaf(a, b, c):
    """f32 fma: the product of an exact integer below 2^24 and an f32 is
    exact in float64, so one rounding of the float64 sum stands in for it."""
    return (a.double() * b.double() + c.double()).float()


def _tc_plain(x2, w, bias, out_dtype, plan: LaunchPlan):
    """Kernel A's tensor-core body restated in PyTorch under ``plan``:
    each output tile (pass of plan.bm rows, plan.bn columns) written once;
    split z takes the stages [z per, (z + 1) per) of 64 packed rows (two
    32-row k-steps, one in a ragged last stage), each k-step's exact dot
    adds to the split's int32 sums, and every bs / 32 k-steps of the split
    the sums fold into its f32 sum as fmaf(hi, absmax_hi / 127, .), then
    fmaf(lo, absmax_lo / 127, .), with the scale row of the current stage
    (of its k-step at blocksize 32) and restart from 0; the partials add in
    split order, then * (row_absmax / 127) + bias."""
    M, K = x2.shape
    N = w.shape[0]
    bs, half = w.blocksize, K // 2
    steps = -(-half // STAGE)
    ksb = bs // 32  # k-steps a block spans
    xq, ra = _quant_rows(x2)
    table = torch.tensor(_int8_code_table(w.code), dtype=torch.float64)
    packed = w.packed.long()
    planes = (table[packed >> 4], table[packed & 0xF])  # (K/2, N) int8 codes of each plane
    s = (w.scales_f32() * np.float32(1.0 / 127.0)).float()  # (2, nbh, N)
    out = torch.full((M, N), float("nan"))
    written = torch.zeros((M, N), dtype=torch.int64)
    passes = -(-M // plan.bm)
    for p in range(passes):
        rows = slice(p * plan.bm, min(M, (p + 1) * plan.bm))
        for ct in range(N // plan.bn):
            cols = slice(ct * plan.bn, (ct + 1) * plan.bn)
            total = None
            for z in range(plan.ksplit):
                acc = torch.zeros((rows.stop - rows.start, plan.bn))
                isum = [torch.zeros_like(acc, dtype=torch.float64) for _ in range(2)]
                kcount = 0
                for st in range(z * plan.per, min((z + 1) * plan.per, steps)):
                    j = st * STAGE
                    for ks in range(min(2, (half - j) // 32)):
                        k0 = j + 32 * ks
                        for pl in range(2):
                            xk = xq[rows, pl * half + k0: pl * half + k0 + 32].double()
                            isum[pl] += xk @ planes[pl][k0:k0 + 32, cols]  # exact below 2^24
                        kcount += 1
                        if kcount == ksb:
                            blk = j // bs + (ks if bs < STAGE else 0)
                            for pl in range(2):
                                acc = _fmaf(isum[pl], s[pl, blk, cols][None, :], acc)
                                isum[pl].zero_()
                            kcount = 0
                total = acc if total is None else total + acc
            rs = ra[rows] / torch.tensor(127.0)
            o = total * rs[:, None]
            if bias is not None:
                o = o + bias.float()[cols]
            out[rows, cols] = o
            written[rows, cols] += 1
    assert bool((written == 1).all())
    return out.to(out_dtype)


def _weights(N, K, bs, absmax=torch.bfloat16, seed=0):
    W = (np.random.default_rng(seed).normal(size=(N, K)) * 0.02).astype(np.float32)
    return W, t_quantize(torch.from_numpy(W), blocksize=bs, quant_type="nf4", absmax_dtype=absmax)


def _x(M, K, seed=1):
    return np.random.default_rng(seed).normal(size=(M, K)).astype(np.float32)


def _tol(dt):
    return F32_TOL if dt == torch.float32 else BF16_TOL


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,K", [(32, 1024), (32, 1088), (64, 1024), (128, 1024), (256, 1024),
                                  (96, 1536), (96, 960), (160, 1920)])
@pytest.mark.parametrize("M", [9, 33, 128, 200])
def test_tc_algebra_matches_plain(M, bs, K, dt):
    N = 256
    _, w = _weights(N, K, bs)
    x = torch.from_numpy(_x(M, K))
    bias = torch.linspace(-0.5, 0.5, N) if M % 2 else None
    plan = gemv_plan(M, N, K, bs, H100_SMS)
    assert plan.body == "tc"
    want = _w4a8_plain(x, w, bias, dt).float().numpy()
    np.testing.assert_allclose(_tc_plain(x, w, bias, dt, plan).float().numpy(), want, **_tol(dt))
    # the most splits a plan may take (one a stage; past 64 rows one per
    # run of stages that ends on a block boundary): the most partials the
    # merge can meet
    per = math.lcm(bs, STAGE) // STAGE
    steps = -(-(K // 2) // STAGE)
    split = LaunchPlan("tc", plan.bm, per, -(-steps // per), plan.bn)
    np.testing.assert_allclose(_tc_plain(x, w, bias, dt, split).float().numpy(), want, **_tol(dt))


@pytest.mark.parametrize("bs,M,K", [(128, 33, 1024), (256, 200, 1024), (96, 65, 1536)])
def test_tc_algebra_matches_jax_kernel(bs, M, K):
    N = 256
    W, w = _weights(N, K, bs, seed=3)
    a = j_quantize(jnp.asarray(W), blocksize=bs, quant_type="nf4", absmax_dtype=jnp.bfloat16)
    x = _x(M, K, seed=4)
    want = np.asarray(j_w4a8(jnp.asarray(x), a, out_dtype=jnp.float32))
    xt = torch.from_numpy(x)
    plan = gemv_plan(M, N, K, bs, H100_SMS)
    assert plan.body == "tc" and -(-M // plan.bm) == -(-M // 128)
    np.testing.assert_allclose(_tc_plain(xt, w, None, torch.float32, plan).numpy(), want, **F32_TOL)
    np.testing.assert_allclose(t_w4a8(xt, w, out_dtype=torch.float32).numpy(), want, **F32_TOL)
