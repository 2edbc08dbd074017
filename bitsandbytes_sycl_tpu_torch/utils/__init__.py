"""Utilities of the JAX package's ``utils``: outlier detection, metadata
carried as tensors, and model surgery (``replace_linear``)."""

from __future__ import annotations

import json
import weakref
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = [
    "find_outlier_dims",
    "OutlierTracer",
    "pack_dict_to_tensor",
    "unpack_tensor_to_dict",
    "replace_linear",
]


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


class OutlierTracer:
    """Weight-outlier registry: ``find_outlier_dims`` of a weight, computed
    once per weight (its identity and version counter, so a write in
    place computes it again)."""

    _instance: Optional["OutlierTracer"] = None

    def __init__(self):
        self.cache: Dict[tuple, tuple] = {}

    @classmethod
    def get_instance(cls) -> "OutlierTracer":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def get_outliers(self, weight: torch.Tensor, zscore: float = 4.0) -> torch.Tensor:
        key = (id(weight), weight._version, zscore)
        hit = self.cache.get(key)
        if hit is None or hit[0]() is not weight:
            hit = self.cache[key] = (weakref.ref(weight), find_outlier_dims(weight, zscore=zscore))
        return hit[1]

    def get_hvalue(self, weight: torch.Tensor) -> int:
        return id(weight)


def pack_dict_to_tensor(d: Dict[str, Any]) -> torch.Tensor:
    """A JSON-encodable dict as a uint8 tensor, so quantization metadata can
    ride in a state_dict or a safetensors file."""
    return torch.from_numpy(np.frombuffer(json.dumps(d).encode("utf-8"), dtype=np.uint8).copy())


def unpack_tensor_to_dict(t) -> Dict[str, Any]:
    """Inverse of pack_dict_to_tensor (a uint8 tensor or numpy array)."""
    arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return json.loads(arr.astype(np.uint8).tobytes().decode("utf-8"))


def replace_linear(model, quant_type: str = "nf4", blocksize: int = 64,
                   compress_statistics: bool = False, predicate: Optional[Callable] = None):
    """Model surgery.

    On a tree of dicts and lists of tensors: ``nn.quantize_linear_params``
    (every 2D "kernel"/"weight" leaf, or those ``predicate(path, leaf)``
    accepts, becomes ``{"packed", "quant_state"}``); returns the new tree.

    On a ``torch.nn.Module``: every ``torch.nn.Linear`` (those
    ``predicate(name, module)`` accepts) is swapped, in place, for a
    ``LinearNF4``/``LinearFP4``/``Linear4bit`` on the same device that holds
    the bnb-format bytes ``quantize_linear_params`` gives for its weight,
    with its bias, computing in the weight's dtype; returns the module.
    """
    from ..nn.modules import Linear4bit, LinearFP4, LinearNF4, quantize_linear_params

    if not isinstance(model, torch.nn.Module):
        return quantize_linear_params(model, quant_type=quant_type, blocksize=blocksize,
                                      compress_statistics=compress_statistics,
                                      predicate=predicate)
    cls = {"nf4": LinearNF4, "fp4": LinearFP4}.get(quant_type, Linear4bit)
    names = [name for name, m in model.named_modules()
             if isinstance(m, torch.nn.Linear) and (predicate is None or predicate(name, m))]
    for name in names:
        lin = model.get_submodule(name)
        q = quantize_linear_params({"weight": lin.weight.detach()}, quant_type=quant_type,
                                   blocksize=blocksize,
                                   compress_statistics=compress_statistics)["weight"]
        new = cls(lin.in_features, lin.out_features,
                  bias=False if lin.bias is None else lin.bias.detach(), quant_type=quant_type,
                  blocksize=blocksize, compress_statistics=compress_statistics,
                  compute_dtype=lin.weight.dtype, device=lin.weight.device,
                  weight=(q["packed"], q["quant_state"]))
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, child, new)
        del lin, q, new
    return model
