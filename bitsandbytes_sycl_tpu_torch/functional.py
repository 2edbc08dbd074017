"""The subset of the JAX package's ``functional.py`` that the port serves:
codebook encode and 4-bit packing (for the quantizer of ``ops/common.py``)
and the LLM.int8 functions.

Codebook encode rounds to nearest with strict-``>`` midpoint thresholds: an
input exactly on a midpoint goes to the lower code, NaN encodes as 0.0.

LLM.int8 (vector-wise int8 weights ``CB`` (N, K) with row scales ``SCB``,
per-row int8 activations, an fp sidecar over outlier columns) keeps the
JAX package's rounding points: ``round`` is half to even, every ``/ 127``
divides by a tensor (``_div127``), and the int8 product is exact (float64
on the CPU, ``torch._int_mm`` on the card).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import codebooks

__all__ = [
    "pack_4bit", "unpack_4bit", "get_colrow_absmax", "int8_vectorwise_quant",
    "int8_linear_matmul", "int8_mm_dequant", "llm_int8_prepare_outliers", "llm_int8_matmul",
]


@functools.lru_cache(maxsize=None)
def _sorted_code_and_perm(quant_type: str, blocksize: int = 64):
    """(sorted codebook values, permutation sorted-rank -> code index,
    midpoints between sorted values, code-order table), all numpy."""
    if quant_type not in ("nf4", "fp4", "int4", "af4"):
        raise ValueError(f"unknown quant_type {quant_type!r}")
    code = codebooks.get_4bit_type(quant_type, blocksize=blocksize)
    order = np.argsort(code, kind="stable").astype(np.int32)
    sorted_code = code[order]
    mids = codebooks.code_midpoints(sorted_code)
    return sorted_code, order, mids, code


def _code_arrays(quant_type: str):
    """(code-order table, sorted values, rank->code perm, midpoints)."""
    sorted_code, order, mids, table = _sorted_code_and_perm(quant_type)
    return table, sorted_code, order, mids


def _encode_nearest(x: torch.Tensor, mids: np.ndarray, order: np.ndarray) -> torch.Tensor:
    """Nearest-codebook encode of f32 ``x`` to uint8 codes.

    rank = #{mids < x} (``searchsorted`` side left); ``order`` maps the
    rank to the code index (identity for monotone codebooks)."""
    x = torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype, device=x.device), x)
    m = torch.from_numpy(np.ascontiguousarray(mids)).to(x.device)
    rank = torch.searchsorted(m, x.contiguous(), right=False)
    if not np.array_equal(order, np.arange(order.shape[0])):
        rank = torch.from_numpy(order.astype(np.int64)).to(x.device)[rank]
    return rank.to(torch.uint8)


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    ok = x > 0
    return torch.where(ok, 1.0 / torch.where(ok, x, torch.ones_like(x)), torch.zeros_like(x))


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, correctly rounded on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its rounded reciprocal instead."""
    return t / torch.tensor(127.0, dtype=t.dtype, device=t.device)


def pack_4bit(codes: torch.Tensor) -> torch.Tensor:
    """Pack flat 4-bit codes two per byte: element 2i high, 2i+1 low."""
    if codes.shape[0] % 2:
        codes = torch.cat([codes, codes.new_zeros(1)])
    pairs = codes.reshape(-1, 2)
    return (pairs[:, 0] << 4 | pairs[:, 1]).to(torch.uint8)


def unpack_4bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of pack_4bit; returns flat (n,) uint8 codes."""
    codes = torch.stack([packed >> 4, packed & 0x0F], dim=-1).reshape(-1)
    return codes[:n]


# ---------------------------------------------------------------------------
# LLM.int8: vector-wise int8 matmul with outlier decomposition
# ---------------------------------------------------------------------------


def get_colrow_absmax(A: torch.Tensor, threshold: float = 0.0):
    """(row_absmax, col_absmax, outlier_cols) of a 2D array; with threshold
    > 0, entries >= threshold leave the row statistics and a column whose
    absmax reaches it is an outlier column."""
    absA = A.float().abs()
    col_absmax = absA.amax(dim=0)
    if threshold > 0.0:
        outlier_cols = col_absmax >= threshold
        row_absmax = torch.where(absA >= threshold, torch.zeros_like(absA), absA).amax(dim=1)
    else:
        outlier_cols = torch.zeros(A.shape[1], dtype=torch.bool, device=A.device)
        row_absmax = absA.amax(dim=1)
    return row_absmax, col_absmax, outlier_cols


def _quant_int8(A32: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """clip(round(A * 127 * safe_inv(absmax)), +-127) as row-major int8
    (the layout kernel I and torch._int_mm take, whatever A's strides);
    absmax broadcasts against A."""
    q = torch.clamp(torch.round(A32 * (127.0 * _safe_inv(absmax))), -127.0, 127.0)
    return q.to(torch.int8).contiguous()


def int8_vectorwise_quant(A: torch.Tensor, axis: int = 1):
    """Symmetric per-vector int8 quantization: (codes, absmax along axis)."""
    A32 = A.float()
    absmax = A32.abs().amax(dim=axis, keepdim=True)
    return _quant_int8(A32, absmax), absmax.squeeze(axis)


def int8_linear_matmul(CA: torch.Tensor, CB: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exact: in float64 on the
    CPU, which holds every sum of K products of +-127 codes, and as
    torch._int_mm on the card, whose rule M > 16 zero rows padding M to 32
    meet (they are dropped)."""
    if not CA.is_cuda:
        return (CA.double() @ CB.double().T).to(torch.int32)
    M = CA.shape[0]
    if M <= 16:
        CA = torch.cat([CA, CA.new_zeros((32 - M, CA.shape[1]))])
    return torch._int_mm(CA.contiguous(), CB.t())[:M]


def int8_mm_dequant(out32: torch.Tensor, SCA: torch.Tensor, SCB: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, dtype=torch.bfloat16) -> torch.Tensor:
    """int32 -> float epilogue: out32 * (SCA x SCB) / 127^2 (+ bias)."""
    scale = (SCA.float()[:, None] * SCB.float()[None, :]) * np.float32(1.0 / (127.0 * 127.0))
    out = out32.float() * scale
    if bias is not None:
        out = out + bias.float()[None, :]
    return out.to(dtype)


def llm_int8_prepare_outliers(CB: torch.Tensor, SCB: torch.Tensor, outlier_idx) -> dict:
    """Static outlier state of a weight: {"idx" (B,) int32, "keep" (K,) f32
    zero at idx, "subB" (B, N) f32 dequantized outlier columns}."""
    K = CB.shape[1]
    idx = torch.as_tensor(outlier_idx, device=CB.device).to(torch.int32)
    keep = torch.ones((K,), dtype=torch.float32, device=CB.device)
    keep[idx.long()] = 0.0
    subB = (CB[:, idx.long()].float() * _div127(SCB.float())[:, None]).T.contiguous()
    return {"idx": idx, "keep": keep, "subB": subB}


def llm_int8_matmul(
    A: torch.Tensor,
    CB: torch.Tensor,
    SCB: torch.Tensor,
    threshold: float = 6.0,
    bias: Optional[torch.Tensor] = None,
    outlier_budget: int = 64,
    use_fused: bool = True,
    outliers: Optional[dict] = None,
) -> torch.Tensor:
    """The LLM.int8 forward: per-row int8 activations times CB (N, K), the
    dequant epilogue, and an fp sidecar over the outlier columns (static
    ``outliers`` from llm_int8_prepare_outliers, or per call the
    ``outlier_budget`` columns of largest absmax that reach ``threshold``).

    ``use_fused`` sends up to 128 rows, without per-call outliers, through
    kernel I (``ops.matmul_int8``); other calls quantize, multiply in int8
    and dequantize as three steps. The JAX package defaults to the fused
    route on a TPU only; its two routes round the epilogue differently."""
    lead, K = A.shape[:-1], A.shape[-1]
    N = CB.shape[0]
    A2 = A.reshape(-1, K)
    out_dtype = A.dtype

    def fused(x, row_absmax):
        if not use_fused:
            return None
        from .ops.matmul_int8 import int8_matmul_fused

        return int8_matmul_fused(x, CB, SCB, row_absmax, bias=bias, out_dtype=out_dtype)

    if threshold <= 0.0:
        out = fused(A2, A2.float().abs().amax(dim=1))
        if out is None:
            CA, SCA = int8_vectorwise_quant(A2)
            out = int8_mm_dequant(int8_linear_matmul(CA, CB), SCA, SCB, bias, out_dtype)
        return out.reshape(*lead, N)

    if outliers is not None:
        x_kept = A2 * outliers["keep"].to(A2.dtype)[None, :]
        row_absmax = x_kept.float().abs().amax(dim=1)
        out = fused(x_kept, row_absmax)
        if out is None:
            CA = _quant_int8(x_kept.float(), row_absmax[:, None])
            out = int8_mm_dequant(int8_linear_matmul(CA, CB), row_absmax, SCB, bias, out_dtype)
        subA = A2[:, outliers["idx"].long()].float()
        out = out + (subA @ outliers["subB"].float()).to(out_dtype)
        return out.reshape(*lead, N)

    budget = min(outlier_budget, K)
    A32 = A2.float()
    top_vals, idx = torch.topk(A32.abs().amax(dim=0), budget)
    is_outlier = (top_vals >= threshold).float()
    keep = torch.ones((K,), dtype=torch.float32, device=A.device)
    keep[idx] = 1.0 - is_outlier
    A_kept = A32 * keep[None, :]
    row_absmax = A_kept.abs().amax(dim=1)
    CA = _quant_int8(A_kept, row_absmax[:, None])
    out = int8_mm_dequant(int8_linear_matmul(CA, CB), row_absmax, SCB, bias, out_dtype)
    subA = A32[:, idx] * is_outlier[None, :]
    subB = CB[:, idx].float() * _div127(SCB.float())[:, None]  # (N, budget)
    out = out + (subA @ subB.T).to(out_dtype)
    return out.reshape(*lead, N)
