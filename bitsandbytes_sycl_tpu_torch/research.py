"""FP8 matmuls simulated through the FP8 codebooks (the JAX package's
``research.py``): quantize through an E4M3 or E5M2 map
(``codebooks.create_fp8_map``), dequantize, then an f32 product, as
bitsandbytes' research package does. The H100's native float8 types are
not used: this module keeps the JAX package's numerics.

- mixed: A blockwise with the forward (E4M3) map at ``bsz``, B with one
  absmax; the backward quantizes the gradient blockwise with the backward
  (E5M2) map at ``bsz2`` for grad_A, and grad_B uses the raw gradient.
- global: A and B with one absmax each under the forward map; the backward
  quantizes the gradient with one absmax under the backward map for both
  gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import codebooks
from . import functional as F

__all__ = ["matmul_fp8_mixed", "matmul_fp8_global", "default_fp8_codes"]


def default_fp8_codes(device=None):
    """(forward E4M3 map, backward E5M2 map) as f32 tensors."""
    fw = torch.from_numpy(codebooks.create_fp8_map(True, 4, 3, 8)).to(device)
    bw = torch.from_numpy(codebooks.create_fp8_map(True, 5, 2, 8)).to(device)
    return fw, bw


def _q_blockwise(x: torch.Tensor, code, blocksize: int) -> torch.Tensor:
    if x.numel() == 0:
        return x
    q, st = F.quantize_blockwise(x, code=code, blocksize=min(blocksize, max(x.numel(), 1)))
    return F.dequantize_blockwise(q, st).to(x.dtype)


def _q_global(x: torch.Tensor, code) -> torch.Tensor:
    if x.numel() == 0:
        return x
    q, (absmax, table) = F.quantize(x, code=code)
    return F.dequantize(q, absmax=absmax, code=table).to(x.dtype)


def _grad_b(fA: torch.Tensor, g: torch.Tensor, b_dim: int) -> torch.Tensor:
    """a^T @ g: a 2-D B sums the batch dims of A into its gradient; a
    batched B keeps one gradient per batch."""
    if b_dim > 2:
        return fA.float().transpose(-1, -2) @ g.float()
    return fA.reshape(-1, fA.shape[-1]).float().T @ g.reshape(-1, g.shape[-1]).float()


class _FP8Mixed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B, fw_code, bw_code, bsz, bsz2):
        fA = _q_blockwise(A, fw_code, bsz)
        fB = _q_global(B, fw_code)
        ctx.save_for_backward(fA, fB, bw_code)
        ctx.bsz2, ctx.b_dtype = bsz2, B.dtype
        return (fA.float() @ fB.float()).to(A.dtype)

    @staticmethod
    def backward(ctx, g):
        fA, fB, bw_code = ctx.saved_tensors
        fg = _q_blockwise(g, bw_code, ctx.bsz2)
        grad_A = (fg.float() @ fB.float().transpose(-1, -2)).to(fA.dtype)
        grad_B = _grad_b(fA, g, fB.dim()).to(ctx.b_dtype)
        return grad_A, grad_B, None, None, None, None


class _FP8Global(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B, fw_code, bw_code, bsz, bsz2):
        fA = _q_global(A, fw_code)
        fB = _q_global(B, fw_code)
        ctx.save_for_backward(fA, fB, bw_code)
        ctx.b_dtype = B.dtype
        return (fA.float() @ fB.float()).to(A.dtype)

    @staticmethod
    def backward(ctx, g):
        fA, fB, bw_code = ctx.saved_tensors
        fg = _q_global(g, bw_code)
        grad_A = (fg.float() @ fB.float().transpose(-1, -2)).to(fA.dtype)
        grad_B = _grad_b(fA, fg, fB.dim()).to(ctx.b_dtype)
        return grad_A, grad_B, None, None, None, None


def _resolve(fw_code, bw_code, device):
    if fw_code is None or bw_code is None:
        dfw, dbw = default_fp8_codes(device)
        fw_code = dfw if fw_code is None else fw_code
        bw_code = dbw if bw_code is None else bw_code
    return fw_code, bw_code


def matmul_fp8_mixed(A: torch.Tensor, B: torch.Tensor, fw_code: Optional[torch.Tensor] = None,
                     bw_code: Optional[torch.Tensor] = None, bsz: int = 64,
                     bsz2: int = 256) -> torch.Tensor:
    """fp8(A) @ fp8(B); grad_A through the E5M2-quantized gradient, grad_B
    through the raw one (the "mixed" rule)."""
    fw_code, bw_code = _resolve(fw_code, bw_code, A.device)
    return _FP8Mixed.apply(A, B, fw_code, bw_code, bsz, bsz2)


def matmul_fp8_global(A: torch.Tensor, B: torch.Tensor, fw_code: Optional[torch.Tensor] = None,
                      bw_code: Optional[torch.Tensor] = None, bsz: int = 64,
                      bsz2: int = 256) -> torch.Tensor:
    """fp8(A) @ fp8(B) with one absmax per tensor; both gradients through
    the E5M2-quantized gradient."""
    fw_code, bw_code = _resolve(fw_code, bw_code, A.device)
    return _FP8Global.apply(A, B, fw_code, bw_code, bsz, bsz2)
