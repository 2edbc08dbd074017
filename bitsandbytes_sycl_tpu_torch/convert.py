"""Turn the JAX package's Llama parameters, LoRA adapters, optimizer
states, QuantStates and ``nn`` modules' variables into the port's.

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
from .types import QuantState

__all__ = ["params_from_jax", "tensor_from_numpy", "lora_from_jax", "optim_state_from_jax",
           "quant_state_from_jax", "module_from_jax"]

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


def quant_state_from_jax(qs, device=None) -> QuantState:
    """The JAX package's QuantState (numpy leaves, or an object or dict
    with its fields) as the port's, on ``device`` (CUDA unless given
    another), the nested level included."""
    dev = resolve_device(device)
    get = qs.get if isinstance(qs, dict) else lambda k: getattr(qs, k, None)
    offset, state2 = get("offset"), get("state2")
    return QuantState(
        absmax=tensor_from_numpy(get("absmax"), dev),
        code=tensor_from_numpy(np.asarray(get("code"), np.float32), dev),
        shape=tuple(int(s) for s in get("shape")),
        dtype=str(get("dtype")),
        blocksize=int(get("blocksize")),
        quant_type=str(get("quant_type")),
        offset=None if offset is None else tensor_from_numpy(np.asarray(offset, np.float32), dev),
        state2=None if state2 is None else quant_state_from_jax(state2, dev),
    )


def module_from_jax(port_cls, variables: Dict, device=None, **cfg):
    """A port ``nn`` module of class ``port_cls`` holding the bytes of a
    Flax module's variables (``{"params", "quants"}``, numpy leaves):
    Linear4bit and its subclasses (either storage mode), Linear8bitLt
    (float or int8 weights, static outlier columns), Embedding,
    StableEmbedding, OutlierAwareLinear and SwitchBackLinearBnb. ``cfg``
    takes the constructor's other options (compute_dtype, threshold, ...),
    which the variables do not record."""
    from . import nn

    dev = resolve_device(device)
    params, quants = variables.get("params", {}), variables.get("quants", {})

    def t(a):
        return tensor_from_numpy(a, dev)

    bias = t(params["bias"]) if "bias" in params else False
    if issubclass(port_cls, nn.Linear4bit):
        qv = quants["weight"]
        if "qweight" in qv:
            w = _convert(qv["qweight"], dev)
            N, K = w.shape
        else:
            w = (t(qv["packed"]), quant_state_from_jax(qv["quant_state"], dev))
            N, K = w[1].shape
        return port_cls(K, N, bias=bias, device=dev, weight=w, **cfg)
    if issubclass(port_cls, nn.Linear8bitLt):
        if "weight" in params:
            W = t(params["weight"])
            return port_cls(W.shape[1], W.shape[0], bias=bias, has_fp16_weights=True, device=dev,
                            weight=W, **cfg)
        qv = quants["weight"]
        CB, SCB = t(qv["CB"]), t(qv["SCB"])
        if "outliers" in qv:
            cfg["outlier_idx"] = t(qv["outliers"]["idx"])
        return port_cls(CB.shape[1], CB.shape[0], bias=bias, has_fp16_weights=False, device=dev,
                        weight=(CB, SCB), **cfg)
    if issubclass(port_cls, (nn.Embedding, nn.StableEmbedding)):
        E = t(params["embedding"])
        m = port_cls(E.shape[0], E.shape[1], device=dev, weight=E, **cfg)
        if issubclass(port_cls, nn.StableEmbedding):
            with torch.no_grad():
                m.norm.weight.copy_(t(params["norm"]["scale"]))
                m.norm.bias.copy_(t(params["norm"]["bias"]))
        return m
    if issubclass(port_cls, (nn.OutlierAwareLinear, nn.SwitchBackLinearBnb)):
        W = t(params["weight"])
        return port_cls(W.shape[1], W.shape[0], bias=bias, device=dev, weight=W, **cfg)
    raise TypeError(f"module_from_jax: no conversion for {port_cls.__name__}")
