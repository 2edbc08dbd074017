"""Codebook encode and 4-bit packing helpers (the subset of the JAX
package's ``functional.py`` that the quantizer of ``ops/common.py`` needs).

Round-to-nearest with strict-``>`` midpoint thresholds: an input exactly on
a midpoint goes to the lower code, NaN encodes as 0.0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import codebooks

__all__ = ["pack_4bit", "unpack_4bit"]


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
