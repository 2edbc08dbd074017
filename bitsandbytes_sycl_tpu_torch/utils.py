"""Utilities of the JAX package's ``utils`` that the port serves."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["find_outlier_dims"]


def find_outlier_dims(weight: torch.Tensor, reduction_dim: int = 0, zscore: float = 4.0,
                      topk: Optional[int] = None) -> torch.Tensor:
    """Dimensions whose mean magnitude is a z-score outlier against the
    rest (population standard deviation): the ``topk`` largest as int32
    indices when topk is set, else a boolean mask of z > zscore."""
    m = weight.float().abs().mean(dim=reduction_dim)
    z = (m - m.mean()) / (m.std(correction=0) + 1e-12)
    if topk is not None:
        return torch.topk(z, topk).indices.to(torch.int32)
    return z > zscore
