"""W4A8 matmul: 4-bit weights times int8 activations (kernel A, ``w4a8_gemv``).

Numerics of the JAX package's ``ops/matmul_w4a8.py``: activations are
quantized to int8 per row (``round(x * 127 * safe_inv(row_absmax))``, half
to even, clipped to +-127), the 4-bit codes decode to the int8 table
``round(code * 127)``, each quantization block's dot is an exact int32 sum,
scaled by ``absmax / 127`` and summed in f32 across blocks, and the row
scale ``row_absmax / 127`` and the bias apply last.

Past the GEMV's rows the weight moves onto one int8 grid per output
column, ``f = absmax * 127 * safe_inv(colmax)`` with ``colmax`` the
column's largest block scale, so one int32 sum runs over all of K:

- the grouped route (kernel G, ``w4a8_grouped``) regrids the int8 codes
  in the kernel, ``clip(round(i8code * (f * (1/127))), +-127)``;
- the W8A8 route decodes the weight once to int8 codes (kernel F,
  ``dequant_int8``), ``clip(round(dec(nibble) * f), +-127)`` with the bf16
  table value (int4: the f32 arithmetic value), then runs one
  int8 x int8 -> int32 product.

Both scale the sum by ``colmax / 127`` and the row scale, in the JAX
package's order.

Kernel F has two bodies (``dequant8_plan``): a tiled body (blocksize a
multiple of 16, N of 16) that streams tiles of the packed weight by TMA,
decodes through per-column code tables in shared memory and stores the
transposed codes by TMA; and a grid-stride body for the other shapes.

Kernel A has two bodies (``gemv_plan``): a fused body for decode rows
(M <= 8, blocksize 32 or 64), one launch that quantizes the activations,
streams the weights and merges its K splits itself; and a SIMT body for
up to 128 rows, three launches (row quantization, the GEMV, the ordered
sum of its K splits).

The three routes are differentiable in x and the bias with the exact-
dequant backward (``matmul_4bit.ExactDequantGrad``): the activation
quantization is a forward-only trade, straight through in the backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from ..functional import _div127
from .common import (LaunchPlan, QLinearWeight, _ksplit, check_cuda_tensors, pick_tile,
                     safe_inv, scratch_buffer, sm_count, split_k, ticket_buffer)

__all__ = [
    "matmul_4bit_w4a8", "matmul_4bit_w4a8_grouped", "matmul_4bit_w8a8_prefill",
    "dequantize_to_int8", "w4a8_gemv", "w4a8_grouped", "dequant_int8",
    "grouped_min_m", "W8A8_PREFILL_MIN_M", "grouped_plan", "col_grid", "gemv_plan",
    "dequant8_plan", "Dequant8Plan",
]

# routing thresholds of the JAX package (models/llama.apply_linear reads them)
W8A8_PREFILL_MIN_M = 4096


def grouped_min_m(blocksize: int) -> int:
    """Row count above which apply_linear sends a weight to the grouped
    W4A8 route."""
    return 128 if blocksize == 128 else 256


def _int8_code_table(code) -> tuple:
    return tuple(int(round(float(v) * 127.0)) for v in code)


_c_tables = {}


def _c_code_table(w: QLinearWeight):
    """The 16 int8 codes of w's codebook as a ctypes array, made once per
    codebook."""
    key = (w.quant_type, w.blocksize)
    table = _c_tables.get(key)
    if table is None:
        table = _c_tables[key] = (ctypes.c_int8 * 16)(*_int8_code_table(w.code))
    return table


def _quant_rows(x2: torch.Tensor):
    """(xq (M, K) int8 codes as f32, row_absmax (M,)): the JAX package's
    per-row activation quantization, in f32."""
    x2 = x2.float()
    ra = x2.abs().amax(dim=1)
    xq = torch.clamp(torch.round(x2 * (127.0 * safe_inv(ra)).reshape(-1, 1)), -127.0, 127.0)
    return xq, ra


def _w4a8_plain(x2: torch.Tensor, w: QLinearWeight, bias, out_dtype) -> torch.Tensor:
    """Plain PyTorch version of kernel A; the integer block dots run in
    float64, which holds them exactly."""
    M, K = x2.shape
    N = w.shape[0]
    bs = w.blocksize
    nbh = K // (2 * bs)
    xq, ra = _quant_rows(x2)
    table = torch.tensor(_int8_code_table(w.code), dtype=torch.float64, device=x2.device)
    wq = torch.cat([table[(w.packed >> 4).long()], table[(w.packed & 0xF).long()]], dim=0)
    # (2*nbh, bs, N) blocks, plane-major; x blocks to match
    d = torch.einsum(
        "mgb,gbn->gmn",
        xq.double().reshape(M, 2 * nbh, bs),
        wq.reshape(2 * nbh, bs, N),
    ).float()  # exact int sums, (2*nbh, M, N)
    s = (w.scales_f32() * (1.0 / 127.0)).reshape(2 * nbh, 1, N)
    out = (d * s).sum(dim=0)
    out = out * (ra.reshape(M, 1) / 127.0)
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


GEMV_FUSED_MAX_M = 8   # rows of the fused body
_GEMV_STAGE_ROWS = 64  # packed rows per stage of the fused body
_GEMV_X_BYTES = 32768  # quantized activations a fused CTA keeps in shared memory
# Fused CTAs per SM the plan aims at (fitted on the H100: PERF.md,
# chip_smoke.py --probe decode): more splits add merge and row-absmax work
# that the 8 warps of one CTA per SM no longer need to hide latency
_GEMV_CTAS_PER_SM = 1


@functools.lru_cache(maxsize=None)
def gemv_plan(M: int, N: int, K: int, bs: int, sms: int) -> LaunchPlan:
    """Kernel A's launch. The fused body ("fused") takes M <= 8 rows (bm,
    its row tile: 1, 2, 4 or 8), blocksize 32 or 64, N % 128 == 0 and
    K % 128 == 0: the grid is (N / 128, ksplit), split s taking the stages
    [s * per, (s + 1) * per) of 64 packed rows, with about
    _GEMV_CTAS_PER_SM CTAs per SM, no more splits than stages, and at most
    _GEMV_X_BYTES of quantized activations per CTA. The SIMT body ("simt")
    takes the rest: rows in tiles of 4, ``per`` quantization blocks per
    warp, ``ksplit`` K splits."""
    half = K // 2
    if 0 < M <= GEMV_FUSED_MAX_M and bs in (32, 64) and N % 128 == 0 \
            and half % _GEMV_STAGE_ROWS == 0:
        bm = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
        steps, tiles = half // _GEMV_STAGE_ROWS, N // 128
        ks = max(1, min(steps, int(_GEMV_CTAS_PER_SM * sms / tiles + 0.5)))
        per = min(-(-steps // ks), _GEMV_X_BYTES // (bm * 2 * _GEMV_STAGE_ROWS))
        return LaunchPlan("fused", bm, per, -(-steps // per))
    g, ks = _ksplit(K // (2 * bs), N // 128, -(-M // 4))
    return LaunchPlan("simt", 4, g, ks)


def w4a8_gemv(x2: torch.Tensor, w: QLinearWeight, bias: Optional[torch.Tensor],
              out_dtype) -> torch.Tensor:
    """Kernel A on CUDA tensors; the plain version on CPU tensors.
    x2 (M, K) f32/bf16 -> (M, N) in out_dtype (f32 or bf16)."""
    if not check_cuda_tensors("w4a8_gemv", x2, w.packed, w.absmax, bias):
        return _w4a8_plain(x2, w, bias, out_dtype)
    M, K = x2.shape
    N = w.shape[0]
    bs = w.blocksize
    if x2.dtype not in (torch.float32, torch.bfloat16) or not x2.is_contiguous():
        raise ValueError(f"w4a8_gemv: x must be contiguous f32/bf16, got {x2.dtype}")
    if w.absmax.dtype not in (torch.float32, torch.bfloat16) or w.compressed:
        raise ValueError("w4a8_gemv: raw f32/bf16 scales only")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w4a8_gemv: out_dtype must be f32 or bf16, got {out_dtype}")
    if N % 128 or K % (2 * bs) or bs % 4 or w.shape[1] != K or M == 0:
        raise ValueError(f"w4a8_gemv: untileable shape M={M} N={N} K={K} bs={bs}")
    if not (w.packed.is_contiguous() and w.absmax.is_contiguous()):
        raise ValueError("w4a8_gemv: weight tensors must be contiguous")
    return _gemv_launch(x2, w, bias, out_dtype, gemv_plan(M, N, K, bs, sm_count(x2.device)))


def _gemv_launch(x2, w: QLinearWeight, bias, out_dtype, plan: LaunchPlan) -> torch.Tensor:
    """Launch kernel A's body ``plan.body`` on checked CUDA tensors. The
    fused body allocates only ``out``: split partials and tickets are kept
    per device."""
    M, K = x2.shape
    N = w.shape[0]
    dev = x2.device
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    b = None if bias is None else bias.float().contiguous()
    flags = (int(x2.dtype == torch.bfloat16), int(w.absmax.dtype == torch.bfloat16),
             int(out_dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    ptrs = (x2.data_ptr(), w.packed.data_ptr(), w.absmax.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr())
    table = ctypes.addressof(_c_code_table(w))
    if plan.body == "fused":
        if ptrs[0] % 16:
            x2 = x2.clone()  # a view at an odd offset; x rows are read 16 bytes at a time
            ptrs = (x2.data_ptr(),) + ptrs[1:]
        part = tickets = None
        if plan.ksplit > 1:
            part = scratch_buffer(dev, plan.ksplit * M * N).data_ptr()
            tickets = ticket_buffer(dev, N // 128).data_ptr()
        fn = _build.kernel_fn("w4a8_gemv", "w4a8_gemv_fused", 18, int_args=range(8, 17))
        err = fn(*ptrs, part, tickets, table, M, N, K, w.blocksize, plan.per, plan.ksplit, *flags)
        w4a8_gemv.launches_fused += 1
    else:
        xq = torch.empty((M, K), dtype=torch.int8, device=dev)
        ra = torch.empty((M,), dtype=torch.float32, device=dev)
        part = scratch_buffer(dev, plan.ksplit * M * N)
        fn = _build.kernel_fn("w4a8_gemv", "w4a8_gemv", 19, int_args=range(9, 18))
        err = fn(*ptrs, xq.data_ptr(), ra.data_ptr(), part.data_ptr(), table,
                 M, N, K, w.blocksize, plan.per, plan.ksplit, *flags)
    _build.check(f"w4a8_gemv ({plan.body})", err)
    w4a8_gemv.launches += 1
    return out


# launches of either body, and of the fused body alone
w4a8_gemv.launches = 0
w4a8_gemv.launches_fused = 0


def matmul_4bit_w4a8(
    x: torch.Tensor,
    w: QLinearWeight,
    bias: Optional[torch.Tensor] = None,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """out ~= x @ dequant(W)^T with int8 activations and int8 weight codes.
    Compressed scales and untileable shapes take the exact path
    (matmul_4bit_fused), as in the JAX package."""
    from .matmul_4bit import ExactDequantGrad, differentiable

    if differentiable(x, bias):
        return ExactDequantGrad.apply(_w4a8_impl, x, w, bias, out_dtype)
    return _w4a8_impl(x, w, bias, out_dtype)


def _w4a8_impl(x, w: QLinearWeight, bias, out_dtype):
    from .matmul_4bit import _nk_tiles, matmul_4bit_fused

    N, K = w.shape
    lead = x.shape[:-1]
    M = int(np.prod(lead)) if lead else 1
    tn, tkb = _nk_tiles(w, N, K)
    if M == 0 or tn is None or tkb is None or w.compressed or K % (2 * w.blocksize) != 0:
        return matmul_4bit_fused(x, w, bias, compute_dtype=out_dtype)
    x2 = x.reshape(M, K)
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.float()
    out = w4a8_gemv(x2.contiguous(), w, bias, out_dtype)
    return out.reshape(*lead, N)


# ---------------------------------------------------------------------------
# the per-column int8 grid: kernels F (dequant_int8) and G (w4a8_grouped)
# ---------------------------------------------------------------------------


def _col_grid(w: QLinearWeight):
    """(colmax (N,), f (2, nbh, N)): each column's largest block scale and
    the factor ``absmax * 127 * safe_inv(colmax)`` that moves a block onto
    the column's int8 grid, in f32 and in the JAX package's order."""
    amax = w.scales_f32()
    colmax = amax.amax(dim=(0, 1))
    return colmax, (amax * (127.0 * safe_inv(colmax))[None, None, :]).contiguous()


def col_grid(w: QLinearWeight):
    """``_col_grid``'s (colmax, f) by the column-grid kernel on CUDA
    tensors (the same numbers bit for bit), by the plain version on CPU
    tensors. Kernel F's route and kernel G take them."""
    from .matmul_4bit import _scale_args

    if not check_cuda_tensors("col_grid", w.absmax, w.absmax_scale, w.absmax_offset):
        return _col_grid(w)
    # compressed scales are decoded in the kernel first (decode_absmax's
    # rounding), as the JAX package decodes them before its kernel F
    s_bf16, am_s, am_o, dtab = _scale_args(w)
    if not w.absmax.is_contiguous():
        raise ValueError("col_grid: the scales must be contiguous")
    _, nbh, N = w.absmax.shape
    dev = w.absmax.device
    colmax = torch.empty((N,), dtype=torch.float32, device=dev)
    f = torch.empty((2, nbh, N), dtype=torch.float32, device=dev)
    fn = _build.kernel_fn("dequant_int8", "col_grid", 10, int_args=range(3, 6))
    err = fn(w.absmax.data_ptr(), colmax.data_ptr(), f.data_ptr(), 2 * nbh, N, s_bf16,
             am_s, am_o, dtab, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("col_grid", err)
    return colmax, f


def _dequant8_mode(w: QLinearWeight) -> int:
    from .matmul_4bit import _MODE_BF16_TABLE, _MODE_F32_INT4

    # the JAX kernel decodes table types in bf16 and int4 arithmetically in f32
    return _MODE_F32_INT4 if w.quant_type == "int4" else _MODE_BF16_TABLE


def _dequant8_plain(w: QLinearWeight, f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel F: int8 (K, N)."""
    from .matmul_4bit import _decode_table

    mode = _dequant8_mode(w)
    table = torch.tensor(list(_decode_table(w.quant_type, w.blocksize, mode)),
                         dtype=torch.float32, device=w.packed.device)
    K2 = w.packed.shape[0]
    planes = []
    for p, codes in enumerate(((w.packed >> 4).long(), (w.packed & 0xF).long())):
        fp = torch.repeat_interleave(f[p], w.blocksize, dim=0)[:K2]
        planes.append(torch.clamp(torch.round(table[codes] * fp), -127.0, 127.0))
    return torch.cat(planes, dim=0).to(torch.int8)


class Dequant8Plan(NamedTuple):
    """Kernel F's launch: the tiled body ("tiled": tiles of DEQ8_ROWS
    packed rows by DEQ8_COLS columns walked by ``grid`` persistent CTAs,
    CTA b taking tiles b, b + grid, ...; tile t covers packed rows from
    (t // ceil(N / DEQ8_COLS)) * DEQ8_ROWS and columns from
    (t % ceil(N / DEQ8_COLS)) * DEQ8_COLS) or the stride body ("stride":
    grid 0)."""

    body: str
    grid: int


DEQ8_ROWS, DEQ8_COLS = 128, 128  # packed rows and columns per tile of the tiled body
_DEQ8_SLOTS = 3  # its ring slots
_SMEM_PER_SM = 233472  # shared memory of an H100 SM; a CTA also reserves 1 KB


def _deq8_blocks(bs: int) -> int:
    """Quantization blocks a tile's packed rows can touch (the f rows it
    loads), as the kernel counts them."""
    if bs >= DEQ8_ROWS:
        return 2 if bs % DEQ8_ROWS else 1
    return (DEQ8_ROWS - 1) // bs + 2 if DEQ8_ROWS % bs else DEQ8_ROWS // bs


def deq8_smem(bs: int) -> int:
    """Dynamic shared memory of the tiled body: two out buffers of both
    planes, the ring of packed bytes and factors, the code tables, and 1
    KB to align to (``tiled_smem_bytes`` in csrc/dequant_int8.cu)."""
    nf, tile = _deq8_blocks(bs), DEQ8_COLS * DEQ8_ROWS
    return 1024 + 4 * tile + _DEQ8_SLOTS * (tile + 2 * nf * DEQ8_COLS * 4) + 2 * nf * DEQ8_COLS * 16


@functools.lru_cache(maxsize=None)
def dequant8_plan(N: int, K: int, bs: int, sms: int) -> Dequant8Plan:
    """The tiled body where the blocksize is a multiple of 16 (a warp's 16
    rows lie in one block) and N of 16 (TMA's row stride); as many CTAs as
    fit an SM's shared memory on every SM, no more than tiles. The stride
    body takes the rest."""
    if bs % 16 or N % 16:
        return Dequant8Plan("stride", 0)
    tiles = -(-(K // 2) // DEQ8_ROWS) * -(-N // DEQ8_COLS)
    per_sm = max(1, _SMEM_PER_SM // (deq8_smem(bs) + 1024))
    return Dequant8Plan("tiled", min(tiles, per_sm * sms))


def dequant_int8(w: QLinearWeight, f: torch.Tensor) -> torch.Tensor:
    """Kernel F on CUDA tensors; the plain version on CPU tensors.
    Returns the int8 codes (K, N) on the per-column grid. On the card they
    are stored as (N, K) rows and returned as their transposed view, the
    layout torch._int_mm takes without a copy."""
    if not check_cuda_tensors("dequant_int8", w.packed, f):
        return _dequant8_plain(w, f)
    N, K = w.shape
    bs = w.blocksize
    if N % 4 or K % (2 * bs) or bs % 4 or tuple(w.packed.shape) != (K // 2, N):
        raise ValueError(f"dequant_int8: unsupported shape N={N} K={K} bs={bs}")
    if f.dtype != torch.float32 or tuple(f.shape) != (2, K // (2 * bs), N) \
            or not f.is_contiguous() or not w.packed.is_contiguous():
        raise ValueError("dequant_int8: f must be contiguous f32 (2, K/(2 bs), N)")
    return _dequant8_launch(w, f, dequant8_plan(N, K, bs, sm_count(w.packed.device)))


def _dequant8_launch(w: QLinearWeight, f: torch.Tensor, plan: Dequant8Plan) -> torch.Tensor:
    """Launch kernel F's body ``plan.body`` on checked CUDA tensors."""
    from .matmul_4bit import _decode_table

    N, K = w.shape
    bs = w.blocksize
    packed = w.packed
    if plan.body == "tiled":  # TMA reads from 16-byte aligned addresses
        packed = packed if packed.data_ptr() % 16 == 0 else packed.clone()
        f = f if f.data_ptr() % 16 == 0 else f.clone()
    out_t = torch.empty((N, K), dtype=torch.int8, device=packed.device)
    fn = _build.kernel_fn("dequant_int8", "dequant_int8", 9, int_args=range(4, 8))
    err = fn(
        packed.data_ptr(), f.data_ptr(), out_t.data_ptr(),
        ctypes.addressof(_decode_table(w.quant_type, bs, _dequant8_mode(w))),
        K, N, bs, plan.grid, torch.cuda.current_stream(packed.device).cuda_stream,
    )
    _build.check(f"dequant_int8 ({plan.body})", err)
    dequant_int8.launches += 1
    if plan.body == "tiled":
        dequant_int8.launches_tiled += 1
    return out_t.t()


# launches of either body, and of the tiled body alone
dequant_int8.launches = 0
dequant_int8.launches_tiled = 0


def _int8_declined(w: QLinearWeight) -> bool:
    """Whether the JAX package's kernel F declines the weight's shape
    (its tiling: N in 128-column tiles, each half padded to 8 blocks)."""
    N, K = w.shape
    half = K // 2
    bs = w.blocksize
    tn = pick_tile(N, (256, 128))
    if tn is None or K % (2 * bs) != 0:
        return True
    step = 8 * bs
    hp = ((half + step - 1) // step) * step
    if step * tn * 4 > 512 * 256 * 4 and tn == 256 and N % 128 == 0:
        tn = 128
    return step * tn * 4 > 512 * 256 * 4 or hp > 2 * half


def dequantize_to_int8(w: QLinearWeight):
    """(wq (K, N) int8, colmax (N,) f32) with dequant(W)^T ~ wq * colmax/127,
    decoded once by kernel F; (None, None) for the shapes the JAX package's
    kernel declines, which callers route elsewhere."""
    if _int8_declined(w):
        return None, None
    colmax, f = col_grid(w)
    return dequant_int8(w, f), colmax


def _quant_rows_kernel(x2: torch.Tensor):
    """(xq (M, K) int8, row_absmax (M,) f32) of CUDA activations, by the
    per-row quantization kernel of A and G: the same numbers as
    _quant_rows."""
    M, K = x2.shape
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.float()
    x2 = x2.contiguous()
    xq = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    ra = torch.empty((M,), dtype=torch.float32, device=x2.device)
    fn = _build.kernel_fn("dequant_int8", "quant_rows", 7, int_args=range(3, 6))
    err = fn(x2.data_ptr(), xq.data_ptr(), ra.data_ptr(), M, K, int(x2.dtype == torch.bfloat16),
             torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check("quant_rows", err)
    return xq, ra


def _grouped_plain(x2: torch.Tensor, w: QLinearWeight, bias, out_dtype) -> torch.Tensor:
    """Plain PyTorch version of kernel G."""
    xq, ra = _quant_rows(x2)
    colmax, f = _col_grid(w)
    table = torch.tensor(_int8_code_table(w.code), dtype=torch.float32, device=x2.device)
    K2 = w.packed.shape[0]
    planes = []
    for p, codes in enumerate(((w.packed >> 4).long(), (w.packed & 0xF).long())):
        g = torch.repeat_interleave(f[p], w.blocksize, dim=0)[:K2] * np.float32(1.0 / 127.0)
        planes.append(torch.clamp(torch.round(table[codes] * g), -127.0, 127.0))
    # exact int32 sums, held exactly in float64
    out = (xq.double() @ torch.cat(planes, dim=0).double()).float()
    out = out * (colmax * np.float32(1.0 / 127.0))[None, :]
    out = out * _div127(ra)[:, None]
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


# kernel G's wgmma body: a CTA's time in us per step of both planes (2 x 64
# rows of K), a K split's fixed cost in us and its cost per partial output
# element, fitted to the plans `chip_smoke.py --probe` times on the H100
# (PERF.md section 6)
_GROUPED_STEP_US = 4.13
_GROUPED_SPLIT = (34.4, 2.79e-6)


def grouped_plan(M: int, N: int, K: int, bs: int, sms: int) -> LaunchPlan:
    """Kernel G's launch on ``sms`` SMs: the wgmma body (256-row tiles,
    64-row K steps, K split to fill the SMs) where half-K is a whole number
    of steps and a 16-row regrid group lies in one quantization block; the
    mma.sync body (128-row tiles, no split) otherwise."""
    half = K // 2
    if half % 64 == 0 and bs % 16 == 0 and (bs % 64 == 0 or 64 % bs == 0):
        split_us, elem_us = _GROUPED_SPLIT
        per, ks, _ = split_k(-(-M // 256) * (N // 128), half // 64, max(1, bs // 64), sms, 1,
                             _GROUPED_STEP_US, split_us, 256 * 128 * elem_us)
        return LaunchPlan("wgmma", 256, per, ks)
    return LaunchPlan("mma_sync", 128, -(-half // 64), 1)


def w4a8_grouped(x2: torch.Tensor, w: QLinearWeight, bias: Optional[torch.Tensor],
                 out_dtype) -> torch.Tensor:
    """Kernel G on CUDA tensors; the plain version on CPU tensors.
    x2 (M, K) f32/bf16 -> (M, N) in out_dtype (f32 or bf16)."""
    if not check_cuda_tensors("w4a8_grouped", x2, w.packed, w.absmax, bias):
        return _grouped_plain(x2, w, bias, out_dtype)
    M, K = x2.shape
    N = w.shape[0]
    bs = w.blocksize
    if x2.dtype not in (torch.float32, torch.bfloat16) or not x2.is_contiguous():
        raise ValueError(f"w4a8_grouped: x must be contiguous f32/bf16, got {x2.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w4a8_grouped: out_dtype must be f32 or bf16, got {out_dtype}")
    if w.absmax.dtype not in (torch.float32, torch.bfloat16) or w.compressed:
        raise ValueError("w4a8_grouped: raw f32/bf16 scales only")
    if N % 128 or K % (2 * bs) or bs % 4 or w.shape[1] != K or M == 0:
        raise ValueError(f"w4a8_grouped: untileable shape M={M} N={N} K={K} bs={bs}")
    if not (w.packed.is_contiguous() and w.absmax.is_contiguous()):
        raise ValueError("w4a8_grouped: weight tensors must be contiguous")
    return _grouped_launch(x2, w, bias, out_dtype,
                           grouped_plan(M, N, K, bs, sm_count(x2.device)))


def _grouped_launch(x2, w: QLinearWeight, bias, out_dtype, plan: LaunchPlan) -> torch.Tensor:
    """Launch kernel G's body ``plan.body`` on checked CUDA tensors."""
    from .matmul_4bit import _INT8_CODES, _decode_table

    M, K = x2.shape
    N = w.shape[0]
    bs = w.blocksize
    dev = x2.device
    colmax, f = col_grid(w)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    ra = torch.empty((M,), dtype=torch.float32, device=dev)
    part = (torch.empty((plan.ksplit, M, N), dtype=torch.int32, device=dev)
            if plan.ksplit > 1 else None)
    b = None if bias is None else bias.float().contiguous()
    fn = _build.kernel_fn("w4a8_grouped", "w4a8_grouped", 20, int_args=range(10, 19))
    err = fn(
        x2.data_ptr(), w.packed.data_ptr(), f.data_ptr(), colmax.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), xq.data_ptr(), ra.data_ptr(),
        None if part is None else part.data_ptr(),
        ctypes.addressof(_decode_table(w.quant_type, bs, _INT8_CODES)),
        M, N, K, bs, int(x2.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), int(plan.body == "wgmma"), plan.per, plan.ksplit,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("w4a8_grouped", err)
    w4a8_grouped.launches += 1
    if plan.body == "wgmma":
        w4a8_grouped.launches_wgmma += 1
    return out


# launches of either body, and of the wgmma body alone
w4a8_grouped.launches = 0
w4a8_grouped.launches_wgmma = 0


def matmul_4bit_w4a8_grouped(
    x: torch.Tensor,
    w: QLinearWeight,
    bias: Optional[torch.Tensor] = None,
    out_dtype=torch.bfloat16,
    tm: Optional[int] = None,
) -> torch.Tensor:
    """out ~= x @ dequant(W)^T with per-row int8 activations and the weight
    regridded in the kernel onto one int8 grid per column (kernel G), one
    int32 sum over all of K. Shapes the JAX package's kernel cannot tile
    take matmul_4bit_fused, as there. ``tm`` (the JAX kernel's row tile)
    is accepted and unused: rows are independent, and kernel G masks a
    ragged M."""
    from .matmul_4bit import ExactDequantGrad, differentiable

    if differentiable(x, bias):
        return ExactDequantGrad.apply(_grouped_impl, x, w, bias, out_dtype)
    return _grouped_impl(x, w, bias, out_dtype)


def _grouped_impl(x, w: QLinearWeight, bias, out_dtype):
    from .matmul_4bit import _nk_tiles, matmul_4bit_fused

    N, K = w.shape
    lead = x.shape[:-1]
    M = int(np.prod(lead)) if lead else 1
    tn, tkb = _nk_tiles(w, N, K)
    bs = w.blocksize
    if (M == 0 or tn is None or tkb is None or w.compressed
            or K % (2 * bs) != 0 or tkb % bs != 0):
        return matmul_4bit_fused(x, w, bias, compute_dtype=out_dtype)
    x2 = x.reshape(M, K)
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.float()
    out = w4a8_grouped(x2.contiguous(), w, bias, out_dtype)
    return out.reshape(*lead, N)


def _w8a8_epilogue(out32, ra, colmax, bias, out_dtype):
    out = out32.float() * (_div127(ra)[:, None] * _div127(colmax)[None, :])
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def _w8a8_plain(x2: torch.Tensor, w: QLinearWeight, bias, out_dtype) -> torch.Tensor:
    """Plain PyTorch version of the W8A8 route; the int8 product runs in
    float64, which holds each of its sums exactly."""
    xq, ra = _quant_rows(x2)
    colmax, f = _col_grid(w)
    out32 = xq.double() @ _dequant8_plain(w, f).double()
    return _w8a8_epilogue(out32, ra, colmax, bias, out_dtype)


def matmul_4bit_w8a8_prefill(
    x: torch.Tensor,
    w: QLinearWeight,
    bias: Optional[torch.Tensor] = None,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """out ~= x @ dequant(W)^T with the weight decoded once per call to int8
    codes on the per-column grid (kernel F), per-row int8 activations and
    one exact int8 product, which the JAX package leaves to XLA and the
    card runs as torch._int_mm (cuBLAS). Shapes dequantize_to_int8
    declines take matmul_4bit_fused, as in the JAX package."""
    from .matmul_4bit import ExactDequantGrad, differentiable

    if differentiable(x, bias):
        return ExactDequantGrad.apply(_w8a8_impl, x, w, bias, out_dtype)
    return _w8a8_impl(x, w, bias, out_dtype)


def _w8a8_impl(x, w: QLinearWeight, bias, out_dtype):
    from .matmul_4bit import matmul_4bit_fused

    N, K = w.shape
    lead = x.shape[:-1]
    M = int(np.prod(lead)) if lead else 1
    if M == 0 or _int8_declined(w):
        return matmul_4bit_fused(x, w, bias, compute_dtype=out_dtype)
    x2 = x.reshape(M, K)
    if not x2.is_cuda:
        return _w8a8_plain(x2, w, bias, out_dtype).reshape(*lead, N)
    wq, colmax = dequantize_to_int8(w)
    xq, ra = _quant_rows_kernel(x2)
    if M <= 16:  # torch._int_mm takes more than 16 rows
        xq = torch.cat([xq, xq.new_zeros((17 - M, K))])
    out32 = torch._int_mm(xq, wq)[:M]
    return _w8a8_epilogue(out32, ra, colmax, bias, out_dtype).reshape(*lead, N)
