"""Ring attention: sequence (context) parallelism over an "sp" mesh dim,
the JAX package's ``parallel/ring.py`` on ``torch.distributed``.

Queries and the KV sequence are split along the sequence: each rank holds
its contiguous chunk (B, S/n, H, D). The K/V chunks rotate around the ring
by point-to-point transfers while each rank accumulates flash-style
online-softmax partial results for its query chunk, so no rank holds the
whole sequence or the whole score matrix. Causality is decided per (query
chunk, kv chunk) pair in absolute positions, so the result is causal
attention. The products are f32 ``torch.matmul``s, as the JAX package
computes them with f32 einsums and no kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .mesh import axis_group, axis_rank, axis_size, ring_shift

__all__ = ["ring_attention"]


def _chunk_attend(q, k, v, q_pos, k_pos, scale):
    """Partial attention of q (B, Tq, H, D) against one kv chunk: the
    unnormalized sum (B, Tq, H, D), the row max m and row sum l (B, H,
    Tq)."""
    sc = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    mask = k_pos[None, None, None, :] <= q_pos[None, None, :, None]
    sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
    m = sc.amax(dim=-1)
    w = torch.exp(sc - m[..., None])
    return torch.einsum("bhts,bshd->bthd", w, v.float()), m, w.sum(dim=-1)


def ring_attention(
    q: torch.Tensor,  # (B, S/n, H, D): this rank's chunk of the sequence
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "sp",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal self-attention with the sequence split over ``axis``: q, k,
    v are this rank's chunks (rank i holds positions [i * S/n, (i + 1) *
    S/n)); returns the rank's chunk of the output, in q's dtype. Each of
    the n ring steps attends the local queries to the visiting kv chunk
    and merges with the online-softmax rule."""
    B, Tl, H, D = q.shape
    n, i, group = axis_size(mesh, axis), axis_rank(mesh, axis), axis_group(mesh, axis)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ar = torch.arange(Tl, device=q.device)
    q_pos = i * Tl + ar
    acc = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tl), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for r in range(n):
        src = (i - r) % n  # the kv chunk visiting at round r started at rank i - r
        a_new, m_new, l_new = _chunk_attend(q, kv[0], kv[1], q_pos, src * Tl + ar, scale)
        m_all = torch.maximum(m, m_new)
        c_old, c_new = torch.exp(m - m_all), torch.exp(m_new - m_all)
        acc = acc * c_old.transpose(1, 2)[..., None] + a_new * c_new.transpose(1, 2)[..., None]
        l = l * c_old + l_new * c_new
        m = m_all
        if r < n - 1:  # rotate the kv chunk one step around the ring
            kv = ring_shift(kv, group)
    inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, torch.ones_like(l)), torch.zeros_like(l))
    return (acc * inv.transpose(1, 2)[..., None]).to(q.dtype)
