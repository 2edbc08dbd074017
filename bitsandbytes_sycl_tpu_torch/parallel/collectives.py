"""Tensor-parallel quantized matmuls over a mesh dim (Megatron style), the
JAX package's ``parallel/collectives.py`` on ``torch.distributed``.

The weight arguments are this rank's local shards (``mesh.shard_qweight``
for 4-bit weights; the rows or columns of CB for LLM.int8), whose ``shape``
describes the local weight; the activations and biases are the whole
tensors every rank holds, as the JAX functions take their global
arguments. Each rank runs kernel B (``matmul_4bit_fused``) or kernel I
(``functional.llm_int8_matmul``) on its shard:

- column-parallel: W sharded on N; x replicated; the output stays
  N-sharded (or is all-gathered with ``gather_output``);
- row-parallel: W sharded on K; each rank takes its slice of x's
  features; the partial products are summed with one all-reduce.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import functional as F
from ..ops.common import QLinearWeight
from ..ops.matmul_4bit import matmul_4bit_fused
from .mesh import _local_qw, all_gather, axis_group, axis_rank, axis_size, psum

__all__ = [
    "tp_matmul_4bit_col",
    "tp_matmul_4bit_row",
    "tp_all_gather_matmul_4bit",
    "tp_matmul_int8_col",
    "tp_matmul_int8_row",
]


def _slice(t: torch.Tensor, mesh, axis: str, dim: int = -1) -> torch.Tensor:
    n = t.shape[dim] // axis_size(mesh, axis)
    return t.narrow(dim, axis_rank(mesh, axis) * n, n)


def tp_matmul_4bit_col(
    x: torch.Tensor,
    qw: QLinearWeight,
    mesh,
    axis: str = "model",
    bias: Optional[torch.Tensor] = None,
    gather_output: bool = False,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Column-parallel fused 4-bit linear: ``qw`` is this rank's N slice;
    ``bias`` the whole (N,) bias, of which the rank adds its slice. Returns
    the rank's (..., N/tp) output, or the whole (..., N) with
    ``gather_output``."""
    bias_l = None if bias is None else _slice(bias, mesh, axis).to(compute_dtype)
    out = matmul_4bit_fused(x.to(compute_dtype), qw, bias=bias_l, compute_dtype=compute_dtype)
    if gather_output:
        out = all_gather(out, axis_group(mesh, axis), dim=-1)
    return out


def tp_matmul_4bit_row(
    x: torch.Tensor,
    qw: QLinearWeight,
    mesh,
    axis: str = "model",
    bias: Optional[torch.Tensor] = None,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Row-parallel fused 4-bit linear: ``qw`` is this rank's byte rows of
    the planar weight (``shard_qweight(..., "row")``), which hold two
    half-ranges of K, so the rank's activations are its slices of x's
    high and low halves, side by side; the partial products are summed
    over the axis and ``bias`` is added once, after the sum."""
    K = x.shape[-1]
    x = x.to(compute_dtype)
    xloc = torch.cat([_slice(x[..., : K // 2], mesh, axis), _slice(x[..., K // 2:], mesh, axis)],
                     dim=-1)
    out = psum(matmul_4bit_fused(xloc, qw, bias=None, compute_dtype=compute_dtype),
               axis_group(mesh, axis))
    return out + bias.to(compute_dtype) if bias is not None else out


def tp_all_gather_matmul_4bit(
    x: torch.Tensor,
    qw: QLinearWeight,
    mesh,
    axis: str = "model",
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """FSDP style: the weight rests column-sharded; each rank all-gathers
    the packed bytes (4-bit on the wire) and scales, and computes the whole
    product. The output is replicated."""
    g = axis_group(mesh, axis)
    full = {"packed": all_gather(qw.packed, g, dim=1), "absmax": all_gather(qw.absmax, g, dim=2)}
    if qw.compressed:
        full["absmax_scale"] = all_gather(qw.absmax_scale, g, dim=2)
        full["absmax_offset"] = all_gather(qw.absmax_offset, g, dim=2)
    return matmul_4bit_fused(x.to(compute_dtype), _local_qw(qw, **full),
                             compute_dtype=compute_dtype)


def tp_matmul_int8_col(
    x: torch.Tensor,
    CB: torch.Tensor,
    SCB: torch.Tensor,
    mesh,
    axis: str = "model",
    threshold: float = 0.0,
    gather_output: bool = False,
) -> torch.Tensor:
    """Column-parallel LLM.int8 linear: CB (N/tp, K) and SCB (N/tp,) are
    this rank's rows. The activations' row statistics come from the
    replicated x, so the numbers are the single device's."""
    out = F.llm_int8_matmul(x, CB, SCB, threshold=threshold)
    if gather_output:
        out = all_gather(out, axis_group(mesh, axis), dim=-1)
    return out


def tp_matmul_int8_row(
    x: torch.Tensor,
    CB: torch.Tensor,
    SCB: torch.Tensor,
    mesh,
    axis: str = "model",
    threshold: float = 0.0,
) -> torch.Tensor:
    """Row-parallel LLM.int8 linear: CB (N, K/tp) is this rank's columns,
    SCB the whole (N,) row scales; the rank takes its slice of x's
    features and the partial products are summed. Each rank quantizes its
    activation slice with its local row absmax, as the JAX package does:
    the scales differ from the single device's global-row quantization,
    with the same or a tighter error bound (local absmax <= global)."""
    out = F.llm_int8_matmul(_slice(x, mesh, axis), CB, SCB, threshold=threshold)
    return psum(out, axis_group(mesh, axis))
