"""Turn the JAX package's Llama parameters, LoRA adapters and optimizer
states into the port's.

The input is the JAX parameter tree with its arrays converted to numpy
(``jax.tree.map(np.asarray, params)``): 4-bit linears stay objects (or
dicts) with ``packed``, ``absmax``, ``shape``, ``blocksize``, ``quant_type``
and ``dtype`` (compressed statistics: uint8 codes in ``absmax`` beside the
f32 sidecars ``absmax_scale`` and ``absmax_offset``); LLM.int8 linears are
dicts ``{"CB", "SCB"[, "outliers": {"idx", "keep", "subB"}]}`` whose leaves
come across as tensors. The bytes
are the same in both packages, so the result holds bit-identical weights
(and the JAX package's outlier columns). bfloat16 arrays arrive as numpy's extension
type; they are read through a uint16 view, so nothing here needs it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops.common import QLinearWeight, resolve_device

__all__ = ["params_from_jax", "tensor_from_numpy", "lora_from_jax", "optim_state_from_jax"]

_QFIELDS = ("packed", "absmax", "shape", "blocksize", "quant_type", "dtype")


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy array (bfloat16 included) -> torch tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _is_qweight(obj) -> bool:
    if isinstance(obj, dict):
        return all(k in obj for k in _QFIELDS)
    return all(hasattr(obj, k) for k in _QFIELDS)


def _convert(obj, device):
    if _is_qweight(obj):
        get = obj.get if isinstance(obj, dict) else lambda k: getattr(obj, k, None)
        side = {k: None if get(k) is None else tensor_from_numpy(get(k), device)
                for k in ("absmax_scale", "absmax_offset")}
        return QLinearWeight(
            packed=tensor_from_numpy(_field(obj, "packed"), device),
            absmax=tensor_from_numpy(_field(obj, "absmax"), device),
            shape=tuple(int(s) for s in _field(obj, "shape")),
            blocksize=int(_field(obj, "blocksize")),
            quant_type=str(_field(obj, "quant_type")),
            dtype=str(_field(obj, "dtype")),
            **side,
        )
    if isinstance(obj, dict):
        return {k: _convert(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_convert(v, device) for v in obj]
    return tensor_from_numpy(obj, device)


def params_from_jax(tree: Dict, cfg, device=None) -> Dict:
    """The JAX package's llama params (numpy leaves) as the port's params:
    embed, norms, per-layer QLinearWeights or LLM.int8 dicts and the
    optional lm_head."""
    if getattr(cfg, "num_experts", 1) > 1:
        raise NotImplementedError("MoE is not ported yet (ROADMAP Queue A #10)")
    dev = resolve_device(device)
    return _convert(tree, dev)


def lora_from_jax(tree, device=None):
    """The JAX package's adapter tree (numpy leaves: per layer {proj: {"A",
    "B", "scale"}}) as the port's, every leaf an f32 tensor that requires
    grad, on ``device`` (CUDA unless given another)."""
    dev = resolve_device(device)

    def leaf(a):
        return tensor_from_numpy(np.asarray(a, np.float32), dev).requires_grad_()

    return [{name: {k: leaf(v) for k, v in ab.items()} for name, ab in layer.items()}
            for layer in tree]


def optim_state_from_jax(state, params, opt) -> None:
    """Load a JAX ``BnbOptimizerState`` (numpy leaves) into ``opt``, an
    ``optim.BnbOptimizer`` over the tensors of ``params``, a tree (lists and
    dicts) of the JAX state's ``inner`` structure: each tensor's state dict
    (``state1``, ``absmax1``, ...) and the step count."""
    inner = state.inner if hasattr(state, "inner") else state["inner"]
    count = state.count if hasattr(state, "count") else state["count"]

    def walk(p, s):
        if isinstance(p, torch.Tensor):
            opt.state[p] = {k: tensor_from_numpy(v, p.device) for k, v in s.items()}
        elif isinstance(p, dict):
            for k in p:
                walk(p[k], s[k])
        else:
            for a, b in zip(p, s):
                walk(a, b)

    walk(params, inner)
    opt.count = int(np.asarray(count))
