"""Fused LLM.int8 matmul of up to 128 rows (kernel I, ``int8_matmul``).

``out = (x quantized per row) @ CB^T``, dequantized: each row of x is
quantized in the kernel as ``clip(round(x * inv), +-127)`` with ``inv =
127 * safe_inv(row_absmax)`` (127 for an all-zero row), the int8 product
with the vector-wise weight ``CB`` (N, K) is an exact int32 sum, and the
epilogue is the JAX package's ``acc * ((1 / inv) * (SCB * f32(1/127)))``
then ``+ bias`` in f32, cast to the output type. The row absmax comes from
the caller, so outlier columns can be masked out of it upstream
(``functional.llm_int8_matmul``).

One launch per call: ``int8_plan`` picks the wgmma width (M rounded up to
a width wgmma takes for s8), the K splits, whose exact int32 sums the
kernel's last CTA per column tile adds before the epilogue, and the K
bytes a stage and shared memory of the kernel's copy ring.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .common import (check_cuda_tensors, pick_tile, safe_inv, scratch_buffer, sm_count,
                     ticket_buffer)

__all__ = ["int8_matmul_fused", "int8_matmul", "int8_plan", "int8_split_plan", "Int8Plan",
           "INT8_WIDTHS", "INT8_SMEM"]

_BN, _STEP = 128, 128  # the kernel's column tile; the plan's K step in bytes
# the widths (rows of x) wgmma.m64nXk32 takes for s8 operands, up to 128
INT8_WIDTHS = (8, 16, 24, 32, 48, 64, 80, 96, 112, 128)
# CTAs per SM the plan aims at: more K splits cost more in the merge than
# they gain in copies (chip_smoke.py --probe int8)
_I8_CTAS_PER_SM = 1
# dynamic shared memory a CTA of the kernel may take (kSmemMax in
# csrc/int8_matmul.cu); its ring takes all but 1 KB where the grid has one
# CTA per SM, and 108 KB where two share an SM
INT8_SMEM = 227 * 1024 - 2048
_RING_SHARED = 108 * 1024


def _mm8_plain(x2, inv, CB, SCB, bias, out_dtype) -> torch.Tensor:
    """Plain PyTorch version of kernel I; the int8 product runs in float64,
    which holds each of its sums exactly."""
    xq = torch.clamp(torch.round(x2.float() * inv[:, None]), -127.0, 127.0)
    acc = (xq.double() @ CB.double().T).float()
    scale = (1.0 / inv)[:, None] * (SCB.float() * np.float32(1.0 / 127.0))[None, :]
    out = acc * scale
    if bias is not None:
        out = out + bias.float()[None, :]
    return out.to(out_dtype)


class Int8Plan(NamedTuple):
    """Kernel I's launch: the wgmma width (rows of x in the product, >= M),
    128-byte K steps per split and the number of K splits (split z covers
    steps [z * per, min((z + 1) * per, K / 128)), the grid is
    (ceil(N / 128), ksplit)), the K bytes a stage and the bytes of shared
    memory its ring of stages may take."""

    width: int
    per: int
    ksplit: int
    kb: int
    ring: int


def int8_split_plan(M: int, N: int, K: int, ks: int, sms: int) -> Int8Plan:
    """Kernel I's launch with about ``ks`` K splits (as many as whole
    splits of ceil(steps / ks) steps make). Where the grid has one CTA per
    SM the ring takes the SM's shared memory and, at width 8, a stage two
    128-byte steps (half the loop's fixed cost a stage); where CTAs share
    an SM, 108 KB and one step. Above width 8 a stage is 64 bytes: x's
    stages take the room of more slots."""
    width = next(w for w in INT8_WIDTHS if w >= M)
    steps = K // _STEP
    per = -(-steps // ks)
    ksplit = -(-steps // per)
    alone = -(-N // _BN) * ksplit <= sms
    if width > 8:
        kb = 64
    else:
        kb = 256 if alone and K % 256 == 0 and per % 2 == 0 else 128
    return Int8Plan(width, per, ksplit, kb, INT8_SMEM - 1024 if alone else _RING_SHARED)


@functools.lru_cache(maxsize=None)
def int8_plan(M: int, N: int, K: int, sms: int) -> Int8Plan:
    """About _I8_CTAS_PER_SM CTAs per SM over the 128-column tiles and K
    splits, no more splits than steps, and split sums of at most half the
    weight's bytes (each split stores M * N int32 that the last CTA reads)."""
    ks = max(1, min(K // _STEP, _I8_CTAS_PER_SM * sms // -(-N // _BN), K // (8 * M)))
    return int8_split_plan(M, N, K, ks, sms)


def int8_matmul(x2: torch.Tensor, inv: torch.Tensor, CB: torch.Tensor, SCB: torch.Tensor,
                bias: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    """Kernel I on CUDA tensors; the plain version on CPU tensors.
    x2 (M, K) f32/bf16, inv (M,) f32, CB (N, K) int8, SCB (N,) -> (M, N)."""
    if not check_cuda_tensors("int8_matmul", x2, inv, CB, SCB, bias):
        return _mm8_plain(x2, inv, CB, SCB, bias, out_dtype)
    M, K = x2.shape
    N = CB.shape[0]
    if x2.dtype not in (torch.float32, torch.bfloat16) or not x2.is_contiguous():
        raise ValueError(f"int8_matmul: x must be contiguous f32/bf16, got {x2.dtype}")
    if CB.dtype != torch.int8 or tuple(CB.shape) != (N, K) or not CB.is_contiguous() \
            or CB.data_ptr() % 16:
        raise ValueError("int8_matmul: CB must be contiguous, 16-byte aligned int8 (N, K)")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul: out_dtype must be f32 or bf16, got {out_dtype}")
    if not 1 <= M <= 128 or N % 64 or K % _STEP:
        raise ValueError(f"int8_matmul: untileable shape M={M} N={N} K={K}")
    return _int8_launch(x2, inv, CB, SCB, bias, out_dtype, int8_plan(M, N, K, sm_count(x2.device)))


def _int8_launch(x2, inv, CB, SCB, bias, out_dtype, plan: Int8Plan) -> torch.Tensor:
    """Launch kernel I with ``plan`` on checked CUDA tensors. It allocates
    only ``out``: the splits' scratch and tickets are kept per device."""
    M, K = x2.shape
    N = CB.shape[0]
    dev = x2.device
    if x2.data_ptr() % 16:
        x2 = x2.clone()  # a view at an odd offset; TMA reads x from a 16-byte aligned address
    iv = inv.float().contiguous()
    sc = SCB.float().contiguous()
    b = None if bias is None else bias.float().contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    part = tickets = None
    if plan.ksplit > 1:  # int32 sums in the f32 scratch's bytes
        part = scratch_buffer(dev, plan.ksplit * M * N).data_ptr()
        tickets = ticket_buffer(dev, -(-N // _BN)).data_ptr()
    fn = _build.kernel_fn("int8_matmul", "int8_matmul", 19, int_args=range(8, 18))
    err = fn(
        x2.data_ptr(), iv.data_ptr(), CB.data_ptr(), sc.data_ptr(),
        None if b is None else b.data_ptr(), part, tickets, out.data_ptr(),
        M, N, K, plan.width, plan.per, plan.ksplit, plan.kb, plan.ring,
        int(x2.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("int8_matmul", err)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def int8_matmul_fused(
    x: torch.Tensor,
    CB: torch.Tensor,
    SCB: torch.Tensor,
    row_absmax: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype=None,
) -> Optional[torch.Tensor]:
    """dequant(quant_rowwise(x) @ CB^T) + bias through kernel I, (M, N);
    None where the JAX kernel declines (no rows, more than 128, or N or K
    that its tiles cannot cover), and the caller then takes the unfused
    route. The JAX kernel's padding of M to a row tile is a TPU rule the
    port does not need."""
    M, K = x.shape
    N = CB.shape[0]
    if M == 0 or M > 128:
        return None
    if pick_tile(N, (512, 256, 128)) is None or pick_tile(K, (1024, 512, 256, 128)) is None:
        return None
    inv = torch.where(row_absmax > 0, 127.0 * safe_inv(row_absmax),
                      torch.full_like(row_absmax, 127.0)).float()
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return int8_matmul(x.contiguous(), inv, CB, SCB, bias, out_dtype or x.dtype)
