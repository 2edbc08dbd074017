"""Exact 4-bit dequant-matmul (kernel B, ``mm4_fused``) and the dense
dequantize of large-M prefill (kernel E, ``dequantize_transposed``).

``out = x[:, :K/2] @ (dec(hi) * s_hi) + x[:, K/2:] @ (dec(lo) * s_lo)``
with f32 accumulation, the numerics of the JAX package's
``ops/matmul_4bit.py``:

- bf16 compute with a table codebook decodes in bf16: the table entry and
  the scale are rounded to bf16 and so is their product;
- int4 decodes arithmetically, ``(7 - (i & 7)) / 7`` or ``-(i & 7) / 7``
  for ``i >= 8``, and f32 compute decodes in f32; the product is then cast
  to x's dtype.

Compressed statistics (uint8 dynamic-map codes of the block scales and an
f32 range and mean per plane and column, ``ops.common.compress_absmax``)
decode each scale once as ``decode_absmax`` does, one fma rounded once,
in both kernels and their plain versions; the rest is unchanged.

Kernel E decodes with the same rounding points into a dense W^T (K, N),
on a TMA body for both scale formats where N is a multiple of 16 and on
the first port's bodies (the unaligned route) elsewhere, as
``dequant4_plan`` picks before the launch; from ``PREFILL_MIN_M`` rows
(``PREFILL_MIN_M_UNALIGNED`` for weights whose half-K is not a multiple
of 8 quantization blocks) ``matmul_4bit_fused`` decodes the weight once
with it and runs one dense matmul, as the JAX package does.

The 4-bit routes are differentiable in x and the bias (``ExactDequantGrad``,
the JAX package's custom_vjp): the backward is the exact-dequant product
``grad_x = (g.float() @ W.float()).to(x.dtype)``, with W from kernel E in
f32 (equal to the JAX package's ``w.dequantize()``) and the product in f32
(TF32 stays off, PyTorch's default), and ``grad_bias = g.float()`` summed
over the rows. The packed weight gets no gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import codebooks
from . import _build
from .common import (LaunchPlan, QLinearWeight, _ksplit, check_cuda_tensors, pick_tile,
                     sm_count, split_k)
from .dynamic8 import decode_table

__all__ = [
    "matmul_4bit_fused", "mm4_fused", "dequantize_transposed", "ExactDequantGrad",
    "PREFILL_MIN_M", "PREFILL_MIN_M_UNALIGNED", "mm4_plan", "dequant4_plan", "Dequant4Plan",
    "deq4_smem",
]

# rows from which matmul_4bit_fused decodes the weight once to a dense
# array (kernel E) and runs one dense matmul, the JAX package's thresholds
PREFILL_MIN_M = 2048
PREFILL_MIN_M_UNALIGNED = 256

_MODE_F32_TABLE, _MODE_F32_INT4, _MODE_BF16_TABLE = 0, 1, 2
_INT8_CODES = 3  # the W4A8 kernels' table, not a decode mode


def _nk_tiles(w: QLinearWeight, N: int, K: int):
    """The JAX kernel's tileability test: (tn, tkb) or None entries."""
    tn = pick_tile(N, (256, 128))
    half = K // 2
    tkb = None
    for c in (8 * w.blocksize, 16 * w.blocksize):
        if half % c == 0:
            tkb = c
            break
    if tkb is None and half % w.blocksize == 0 and tn and half * tn <= 4 * 1024 * 1024:
        tkb = half  # whole half-plane as one K step
    return tn, tkb


def _decode_mode(w: QLinearWeight, compute_dtype, decode_dtype) -> int:
    if decode_dtype is None:
        use16 = w.quant_type != "int4" and compute_dtype == torch.bfloat16
        decode_dtype = torch.bfloat16 if use16 else torch.float32
    if decode_dtype == torch.bfloat16:
        return _MODE_BF16_TABLE
    return _MODE_F32_INT4 if w.quant_type == "int4" else _MODE_F32_TABLE


def _decode_planes(w: QLinearWeight, mode: int, x_dtype) -> tuple:
    """Both scaled planes (K/2, N) in x's dtype, as the kernel decodes them."""
    K2 = w.packed.shape[0]
    N = w.shape[0]
    hi_c, lo_c = (w.packed >> 4).long(), (w.packed & 0xF).long()
    s = w.scales_f32()
    s_rep = [torch.repeat_interleave(s[p], w.blocksize, dim=0)[:K2] for p in (0, 1)]
    planes = []
    for codes, sp in zip((hi_c, lo_c), s_rep):
        if mode == _MODE_BF16_TABLE:
            tbl = torch.tensor(np.asarray(w.code, np.float32)).to(codes.device, torch.bfloat16)
            val = tbl[codes] * sp.to(torch.bfloat16)  # bf16 product, rounded once
        elif mode == _MODE_F32_INT4:
            mag = (codes & 7).float()
            val = torch.where((codes & 8) != 0, -mag, 7.0 - mag) * np.float32(1.0 / 7.0)
            val = val * sp
        else:
            tbl = torch.tensor(np.asarray(w.code, np.float32)).to(codes.device)
            val = tbl[codes] * sp
        planes.append(val.to(x_dtype).reshape(K2, N))
    return planes


@functools.lru_cache(maxsize=None)
def _decode_table(quant_type: str, blocksize: int, mode: int):
    """The 16 table values a kernel takes, as a ctypes float array: the
    bf16-rounded table, int4's arithmetic values (7 - (i & 7)) * fl(1/7)
    or -(i & 7) * fl(1/7), the f32 table, or (``_INT8_CODES``) the int8
    codes round(code * 127)."""
    code = codebooks.get_4bit_type(quant_type, blocksize=blocksize)
    if mode == _MODE_BF16_TABLE:
        vals = torch.tensor(np.asarray(code, np.float32)).to(torch.bfloat16).float().numpy()
    elif mode == _MODE_F32_INT4:
        i = np.arange(16)
        mag = (i & 7).astype(np.float32)
        vals = np.where(i & 8, -mag, np.float32(7.0) - mag).astype(np.float32) * np.float32(1.0 / 7.0)
    elif mode == _INT8_CODES:
        from .matmul_w4a8 import _int8_code_table

        vals = _int8_code_table(code)
    else:
        vals = np.asarray(code, np.float32)
    return (ctypes.c_float * 16)(*[float(v) for v in vals])


def _scale_args(w: QLinearWeight) -> tuple:
    """The scale arguments of kernels B and E: (raw scales in bf16 or not,
    range, mean, dynamic-map table) pointers, the last three None for raw
    scales. Compressed codes must come with contiguous f32 (2, 1, N)
    sidecars."""
    if not w.compressed:
        if w.absmax.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"scales must be f32/bf16 or compressed codes, got {w.absmax.dtype}")
        return int(w.absmax.dtype == torch.bfloat16), None, None, None
    N = w.shape[0]
    sc, off = w.absmax_scale, w.absmax_offset
    if w.absmax.dtype != torch.uint8 or any(
            t.dtype != torch.float32 or tuple(t.shape) != (2, 1, N) or not t.is_contiguous()
            for t in (sc, off)):
        raise ValueError("compressed scales: uint8 codes with contiguous f32 (2, 1, N) sidecars")
    return 0, sc.data_ptr(), off.data_ptr(), decode_table(w.absmax.device).data_ptr()


def _dequant4_plain(w: QLinearWeight, out_dtype) -> torch.Tensor:
    """Plain PyTorch version of kernel E: both planes stacked, (K, N)."""
    mode = _decode_mode(w, out_dtype, None)
    return torch.cat(_decode_planes(w, mode, out_dtype), dim=0)


class Dequant4Plan(NamedTuple):
    """Kernel E's launch: ``body`` "tma" (the TMA body: tiles of ``rows``
    packed rows by ``cols`` columns through a ring of ``slots`` stages on
    ``grid`` persistent CTAs) or "unaligned" (N % 16 != 0: the first
    port's bodies, all other fields 0)."""

    body: str
    rows: int
    cols: int
    slots: int
    grid: int


DEQ4_MAX_ROWS = 64  # packed rows of a tile at most
DEQ4_SLOTS = 4  # ring stages
DEQ4_SMEM_MAX = 225 * 1024  # dynamic shared memory a CTA may take (kSmemMax in the source)
_SMEM_PER_SM = 233472  # shared memory of an H100 SM; a CTA also reserves 1 KB


def deq4_smem(rows: int, cols: int, slots: int, bs: int, compressed: bool = False) -> int:
    """Dynamic shared memory of the TMA body: the ring's stages (the packed
    box, both planes' scale boxes with room for f32 scales, and for
    compressed scales both planes' range and mean), for compressed scales
    the tile's decoded scales, and 1 KB to align to (``deq4_slot_bytes``
    in csrc/dequantize_transposed.cu)."""
    nsr = rows // bs if rows >= bs else 1
    stage = rows * cols + 2 * nsr * cols * 4 + (16 * cols if compressed else 0)
    return 1024 + slots * stage + (2 * nsr * cols * 4 if compressed else 0)


@functools.lru_cache(maxsize=None)
def dequant4_plan(N: int, K: int, bs: int, sms: int, compressed: bool = False) -> Dequant4Plan:
    """Kernel E's route and launch for a weight the wrapper's guard takes
    (N % 4 == 0, K % (2 bs) == 0, bs % 4 == 0). The TMA body where N is a
    multiple of 16 (TMA's row stride), else the unaligned route. Tiles:
    the most packed rows up to DEQ4_MAX_ROWS that divide K/2, are a
    multiple or a divisor of bs (a tile touches whole scale rows) and keep
    the ring within DEQ4_SMEM_MAX (at bs 4 a 64-row tile holds 16 scale
    rows, too many with compressed scales), by 256 columns (128 where N is
    a multiple of 128 but not of 256), through a ring of DEQ4_SLOTS
    stages. The grid: as many CTAs as fit the SMs'
    shared memory, up to 3 an SM, for raw scales; one an SM for
    compressed ones, whose tiles add a decode and a barrier (the fastest
    over a 7B layer's linears of the plans ``chip_smoke.py --probe
    dequant`` timed on the H100); evened out so that every CTA takes the
    same number of tiles or one fewer."""
    if N % 16:
        return Dequant4Plan("unaligned", 0, 0, 0, 0)
    half = K // 2
    cols = 128 if N % 256 and N % 128 == 0 else 256
    rows = max(r for r in range(4, DEQ4_MAX_ROWS + 1, 4)
               if half % r == 0 and (r % bs == 0 or bs % r == 0)
               and deq4_smem(r, cols, DEQ4_SLOTS, bs, compressed) <= DEQ4_SMEM_MAX)
    per_sm = 1 if compressed else min(3, _SMEM_PER_SM // (
        deq4_smem(rows, cols, DEQ4_SLOTS, bs) + 1024))
    tiles = -(-N // cols) * (half // rows)
    waves = -(-tiles // (per_sm * sms))
    return Dequant4Plan("tma", rows, cols, DEQ4_SLOTS, -(-tiles // waves))


def dequantize_transposed(w: QLinearWeight, out_dtype=torch.bfloat16) -> torch.Tensor:
    """W^T (K, N) densely decoded in out_dtype (f32 or bf16): kernel E on
    CUDA tensors (the route ``dequant4_plan`` picks), its plain version on
    CPU tensors. The JAX package decodes shapes its Pallas kernel declines
    (blocksize >= 256 at bf16, or a K that padding to 8 quantization blocks
    would double) in XLA instead, with one f32 product rounded once; kernel
    E takes every shape, so there the result can differ from the JAX
    package's by one rounding."""
    if not check_cuda_tensors("dequantize_transposed", w.packed, w.absmax, w.absmax_scale,
                              w.absmax_offset):
        return _dequant4_plain(w, out_dtype)
    N, K = w.shape
    bs = w.blocksize
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dequantize_transposed: out_dtype must be f32 or bf16, got {out_dtype}")
    if N % 4 or K % (2 * bs) or bs % 4 or tuple(w.packed.shape) != (K // 2, N):
        raise ValueError(f"dequantize_transposed: unsupported shape N={N} K={K} bs={bs}")
    if not (w.packed.is_contiguous() and w.absmax.is_contiguous()):
        raise ValueError("dequantize_transposed: weight tensors must be contiguous")
    return _dequant4_launch(w, out_dtype,
                            dequant4_plan(N, K, bs, sm_count(w.packed.device), w.compressed))


def _dequant4_launch(w: QLinearWeight, out_dtype, plan: Dequant4Plan) -> torch.Tensor:
    """Launch kernel E's route ``plan.body`` on checked CUDA tensors."""
    N, K = w.shape
    bs = w.blocksize
    if plan.body == "tma":  # TMA reads from 16-byte aligned addresses
        odd = {k: t.clone() for k in ("packed", "absmax", "absmax_scale", "absmax_offset")
               if (t := getattr(w, k)) is not None and t.data_ptr() % 16}
        if odd:
            w = dataclasses.replace(w, **odd)
    s_bf16, am_s, am_o, dtab = _scale_args(w)
    packed, absmax = w.packed, w.absmax
    mode = _decode_mode(w, out_dtype, None)
    out = torch.empty((K, N), dtype=out_dtype, device=packed.device)
    fn = _build.kernel_fn("dequantize_transposed", "dequantize_transposed", 18,
                          int_args=range(4, 14))
    err = fn(
        packed.data_ptr(), absmax.data_ptr(), out.data_ptr(),
        ctypes.addressof(_decode_table(w.quant_type, bs, mode)),
        K, N, bs, s_bf16, int(out_dtype == torch.bfloat16), int(mode == _MODE_BF16_TABLE),
        plan.rows, plan.cols, plan.slots, plan.grid, am_s, am_o, dtab,
        torch.cuda.current_stream(packed.device).cuda_stream,
    )
    _build.check(f"dequantize_transposed ({plan.body})", err)
    dequantize_transposed.launches += 1
    dequantize_transposed.launches_compressed += int(w.compressed)
    dequantize_transposed.launches_tma += int(plan.body == "tma")
    return out


# launches of either route, those on compressed scales, and those of the TMA body
dequantize_transposed.launches = 0
dequantize_transposed.launches_compressed = 0
dequantize_transposed.launches_tma = 0


def _dense_matmul(x2: torch.Tensor, wt: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x2 @ wt with f32 accumulation, cast to compute_dtype: the dense
    product the JAX package leaves to XLA. cuBLAS accumulates a bf16
    product in f32 on the card; the CPU computes it in f32 explicitly."""
    if x2.is_cuda:
        return torch.matmul(x2, wt).to(compute_dtype)
    return (x2.float() @ wt.float()).to(compute_dtype)


def _mm4_plain(x2, w: QLinearWeight, bias, compute_dtype, mode: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B."""
    K2 = w.packed.shape[0]
    w_hi, w_lo = _decode_planes(w, mode, x2.dtype)
    xf = x2.float()
    out = xf[:, :K2] @ w_hi.float() + xf[:, K2:] @ w_lo.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(compute_dtype)


# kernel B's tensor-core tiles (rows, columns): CTAs per SM (by shared
# memory) and a CTA's time per 32-row step in us; a K split's fixed cost in
# us and its cost per partial output element. The times are fitted to the
# plans `chip_smoke.py --probe` times on the H100 (PERF.md section 6).
_MM4_TILES = {(64, 128): (2, 1.37), (128, 128): (1, 0.934), (128, 256): (1, 1.71),
              (256, 128): (1, 1.33)}
_MM4_SPLIT = (6.67, 2.38e-6)


@functools.lru_cache(maxsize=None)
def mm4_plan(M: int, N: int, K: int, bs: int, x_dtype, sms: int,
             compressed: bool = False) -> LaunchPlan:
    """Kernel B's launch on ``sms`` SMs. The tensor-core body takes bf16 x
    where half-K is a whole number of its 32-row steps and a step's 8-row
    decode groups each lie in one quantization block, with the tile and K
    split that ``split_k`` ranks cheapest (it beats the SIMT body from one
    row on); with ``compressed`` scales every tile but 128 x 256, which has
    no shared memory left for the decode table. The SIMT body takes the
    rest (f32 x, other shapes): 4-row tiles, ``per`` quantization blocks
    per warp. Cached: a decode step asks for the same plans in every
    layer."""
    half = K // 2
    if x_dtype == torch.bfloat16 and half % 32 == 0 and bs % 8 == 0 and (
            bs % 32 == 0 or 32 % bs == 0):
        best = None
        split_us, elem_us = _MM4_SPLIT
        for (bm, bn), (ctas_per_sm, step_us) in _MM4_TILES.items():
            if N % bn or (compressed and (bm, bn) == (128, 256)):
                continue
            per, ks, est = split_k(-(-M // bm) * (N // bn), half // 32, max(1, bs // 32), sms,
                                   ctas_per_sm, step_us, split_us, bm * bn * elem_us)
            if best is None or est < best[0]:
                best = (est, LaunchPlan("tc", bm, per, ks, bn))
        return best[1]
    g, ks = _ksplit(half // bs, N // 128, -(-M // 4))
    return LaunchPlan("simt", 4, g, ks)


def mm4_fused(x2: torch.Tensor, w: QLinearWeight, bias: Optional[torch.Tensor],
              compute_dtype, decode_dtype=None) -> torch.Tensor:
    """Kernel B on CUDA tensors; the plain version on CPU tensors.
    x2 (M, K) already in compute_dtype -> (M, N) in compute_dtype. The
    body follows ``mm4_plan``."""
    mode = _decode_mode(w, compute_dtype, decode_dtype)
    if not check_cuda_tensors("mm4_fused", x2, w.packed, w.absmax, w.absmax_scale,
                              w.absmax_offset, bias):
        return _mm4_plain(x2, w, bias, compute_dtype, mode)
    M, K = x2.shape
    N = w.shape[0]
    bs = w.blocksize
    if compute_dtype not in (torch.float32, torch.bfloat16) or x2.dtype != compute_dtype:
        raise ValueError(f"mm4_fused: x ({x2.dtype}) must be in compute_dtype f32/bf16")
    if not x2.is_contiguous() or not w.packed.is_contiguous() or not w.absmax.is_contiguous():
        raise ValueError("mm4_fused: tensors must be contiguous")
    if N % 128 or K % (2 * bs) or bs % 4 or w.shape[1] != K or M == 0:
        raise ValueError(f"mm4_fused: untileable shape M={M} N={N} K={K} bs={bs}")
    if x2.data_ptr() % 16:
        x2 = x2.clone()  # a view at an odd offset; TMA reads 16-byte aligned rows
    return _mm4_launch(x2, w, bias, mode,
                       mm4_plan(M, N, K, bs, x2.dtype, sm_count(x2.device), w.compressed))


def _mm4_launch(x2, w: QLinearWeight, bias, mode: int, plan: LaunchPlan) -> torch.Tensor:
    """Launch kernel B's body ``plan.body`` on checked CUDA tensors."""
    s_bf16, am_s, am_o, dtab = _scale_args(w)
    M, K = x2.shape
    N = w.shape[0]
    dev = x2.device
    out = torch.empty((M, N), dtype=x2.dtype, device=dev)
    part = torch.empty((plan.ksplit, M, N), dtype=torch.float32, device=dev) \
        if plan.body == "simt" or plan.ksplit > 1 else None
    b = None if bias is None else bias.float().contiguous()
    table = ctypes.addressof(_decode_table(w.quant_type, w.blocksize, mode))
    ptrs = (x2.data_ptr(), w.packed.data_ptr(), w.absmax.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), table)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.body == "tc":
        # TMA reads x, the packed bytes and the scales from 16-byte aligned addresses
        assert all(t.data_ptr() % 16 == 0 for t in (x2, w.packed, w.absmax)), "unaligned tensor"
        fn = _build.kernel_fn("mm4_fused", "mm4_fused_tc", 21, int_args=range(7, 17))
        err = fn(*ptrs, M, N, K, w.blocksize, plan.bm, plan.bn, plan.per, plan.ksplit, s_bf16,
                 mode, am_s, am_o, dtab, stream)
        mm4_fused.launches_tc += 1
    else:
        fn = _build.kernel_fn("mm4_fused", "mm4_fused", 20, int_args=range(7, 16))
        err = fn(*ptrs, M, N, K, w.blocksize, plan.per, plan.ksplit,
                 int(x2.dtype == torch.bfloat16), s_bf16, mode, am_s, am_o, dtab, stream)
    _build.check(f"mm4_fused ({plan.body})", err)
    mm4_fused.launches += 1
    mm4_fused.launches_compressed += int(w.compressed)
    return out


# launches of either body, of the tensor-core body alone, and on compressed scales
mm4_fused.launches = 0
mm4_fused.launches_tc = 0
mm4_fused.launches_compressed = 0


class ExactDequantGrad(torch.autograd.Function):
    """A 4-bit route with the JAX package's exact-dequant backward:
    ``apply(impl, x, w, bias, *args)`` runs ``impl(x, w, bias, *args)``
    forward. The forward keeps its route's numerics (the W4A8 routes'
    activation rounding included); the backward passes straight through
    it, as the JAX package's custom_vjp does."""

    @staticmethod
    def forward(ctx, impl, x, w, bias, *args):
        ctx.w, ctx.x_shape, ctx.x_dtype = w, x.shape, x.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.n_args = len(args)
        return impl(x, w, bias, *args)

    @staticmethod
    def backward(ctx, g):
        gf = g.float().reshape(-1, g.shape[-1])
        grad_x = grad_b = None
        if ctx.needs_input_grad[1]:
            w = ctx.w
            wt = dequantize_transposed(w, torch.float32)  # (K, N), kernel E on the card
            if w.dtype != "float32":
                wt = wt.to(getattr(torch, w.dtype)).float()
            grad_x = torch.matmul(gf, wt.t()).to(ctx.x_dtype).reshape(ctx.x_shape)
        if ctx.needs_input_grad[3]:
            grad_b = gf.sum(0).to(ctx.bias_dtype)
        return (None, grad_x, None, grad_b) + (None,) * ctx.n_args


def differentiable(x: torch.Tensor, bias: Optional[torch.Tensor]) -> bool:
    """Whether a route call must record its backward."""
    return torch.is_grad_enabled() and (
        x.requires_grad or (bias is not None and bias.requires_grad))


def matmul_4bit_fused(
    x: torch.Tensor,
    w: QLinearWeight,
    bias: Optional[torch.Tensor] = None,
    compute_dtype=torch.bfloat16,
    decode_dtype=None,
) -> torch.Tensor:
    """out = x @ dequant(W)^T (+ bias) in compute_dtype; the weight stays
    4-bit. Shapes the kernel cannot tile take a plain dequantize and
    matmul, as the JAX package does. Differentiable in x and bias
    (``ExactDequantGrad``)."""
    if differentiable(x, bias):
        return ExactDequantGrad.apply(_matmul_4bit_fused_impl, x, w, bias, compute_dtype,
                                      decode_dtype)
    return _matmul_4bit_fused_impl(x, w, bias, compute_dtype, decode_dtype)


def _matmul_4bit_fused_impl(x, w: QLinearWeight, bias, compute_dtype, decode_dtype):
    N, K = w.shape
    lead = x.shape[:-1]
    M = int(np.prod(lead)) if lead else 1
    x2 = x.reshape(M, K).to(compute_dtype)
    tn, tkb = _nk_tiles(w, N, K)
    if M == 0 or tn is None or tkb is None or K % (2 * w.blocksize) != 0:
        wd = w.dequantize().to(compute_dtype)
        out = (x2.float() @ wd.float().T).to(compute_dtype)
        if bias is not None:
            out = out + bias
        return out.reshape(*lead, N)
    whole_half = tkb == K // 2 and (K // 2) % (8 * w.blocksize) != 0
    if M >= (PREFILL_MIN_M_UNALIGNED if whole_half else PREFILL_MIN_M):
        # large M: decode the weight once (kernel E), then one dense matmul
        out = _dense_matmul(x2, dequantize_transposed(w, compute_dtype), compute_dtype)
        if bias is not None:
            out = out + bias
        return out.reshape(*lead, N)
    out = mm4_fused(x2.contiguous(), w, bias, compute_dtype, decode_dtype)
    return out.reshape(*lead, N)
