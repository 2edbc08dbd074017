"""Fused LLM.int8 matmul of up to 128 rows (kernel I, ``int8_matmul``).

``out = (x quantized per row) @ CB^T``, dequantized: each row of x is
quantized in the kernel as ``clip(round(x * inv), +-127)`` with ``inv =
127 * safe_inv(row_absmax)`` (127 for an all-zero row), the int8 product
with the vector-wise weight ``CB`` (N, K) is an exact int32 sum, and the
epilogue is the JAX package's ``acc * ((1 / inv) * (SCB * f32(1/127)))``
then ``+ bias`` in f32, cast to the output type. The row absmax comes from
the caller, so outlier columns can be masked out of it upstream
(``functional.llm_int8_matmul``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from .common import check_cuda_tensors, pick_tile, safe_inv

__all__ = ["int8_matmul_fused", "int8_matmul"]

_BN, _BK = 64, 128  # the kernel's column tile and K step


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


def _ksplit(M: int, N: int, K: int) -> int:
    """K splits so that the grid holds ~4 blocks per SM, while the int32
    partials stay under a quarter of the weight's bytes."""
    steps = K // _BK
    want = -(-528 // (N // _BN))
    ks = max(1, min(want, steps, K // (16 * M)))
    per = -(-steps // ks)
    return -(-steps // per)


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
    if CB.dtype != torch.int8 or tuple(CB.shape) != (N, K) or not CB.is_contiguous():
        raise ValueError("int8_matmul: CB must be contiguous int8 (N, K)")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul: out_dtype must be f32 or bf16, got {out_dtype}")
    if not 1 <= M <= 128 or N % _BN or K % _BK:
        raise ValueError(f"int8_matmul: untileable shape M={M} N={N} K={K}")
    ksplit = _ksplit(M, N, K)
    dev = x2.device
    iv = inv.float().contiguous()
    sc = SCB.float().contiguous()
    b = None if bias is None else bias.float().contiguous()
    part = torch.empty((ksplit, M, N), dtype=torch.int32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    fn = _build.kernel_fn("int8_matmul", "int8_matmul", 14, int_args=range(7, 13))
    err = fn(
        x2.data_ptr(), iv.data_ptr(), CB.data_ptr(), sc.data_ptr(),
        None if b is None else b.data_ptr(), part.data_ptr(), out.data_ptr(),
        M, N, K, ksplit, int(x2.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
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
