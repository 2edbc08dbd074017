"""Quantized layers as ``torch.nn.Module``s (the JAX package's Flax
``nn/modules.py``), with its defaults.

Quantized weights are registered buffers, so ``.to()``, ``state_dict()``
and ``load_state_dict()`` carry them; trainable tensors (biases, float
weights) are parameters. Each constructor takes ``device`` (CUDA unless
given another; ``ops.common.resolve_device``) and an optional
``torch.Generator`` for its random initialisation (the JAX modules'
initialisers: lecun-normal weights, zero biases, a normal or xavier-uniform
embedding table), or the ``weight`` to use instead.

``Linear4bit`` keeps both of the JAX module's storage modes:
``use_kernel=True`` (the default, where in_features is a multiple of
2 * blocksize) holds a kernel-layout weight (``quantize_4bit_native``)
run through ``autograd.matmul_4bit_kernel``; otherwise it holds the
bnb-format bytes and QuantState of ``functional.quantize_4bit`` run through
``autograd.matmul_4bit``. Both reach kernel B (or E from 2048 rows) on
the card where the kernel layout's shape rule holds.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .. import functional as F
from ..autograd import matmul_4bit, matmul_4bit_kernel, matmul_8bit_lt, matmul_8bit_train
from ..ops.common import QLinearWeight, quantize_4bit_native, resolve_device
from ..types import QuantState

__all__ = [
    "Linear4bit",
    "LinearNF4",
    "LinearFP4",
    "Linear8bitLt",
    "Embedding",
    "StableEmbedding",
    "OutlierAwareLinear",
    "SwitchBackLinearBnb",
    "quantize_linear_params",
]

# flax's truncated normal: the stddev of a standard normal truncated to
# [-2, 2], by which the lecun-normal stddev is divided
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(out_features, in_features, device, generator) -> torch.Tensor:
    std = math.sqrt(1.0 / in_features) / _TRUNC_STD
    w = torch.empty((out_features, in_features), dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _bias(out_features, bias, dtype, device) -> Optional[torch.nn.Parameter]:
    if bias is False or bias is None:
        return None
    if bias is True:
        return torch.nn.Parameter(torch.zeros((out_features,), dtype=dtype, device=device))
    return torch.nn.Parameter(bias.detach().to(device=device, dtype=dtype).clone())


class Linear4bit(torch.nn.Module):
    """4-bit weight-only linear layer: y = x @ W^T + b, W of logical shape
    (out_features, in_features), computed in ``compute_dtype``.

    ``weight``: None (a random lecun-normal weight from ``generator``), a
    float (out, in) tensor to quantize, a ``QLinearWeight`` (kernel
    layout) or a ``(packed, QuantState)`` pair (bnb format), kept as given.
    ``bias``: True (zeros), False, or a tensor.
    """

    def __init__(self, in_features: int, out_features: int, bias=True, quant_type: str = "nf4",
                 blocksize: int = 64, compress_statistics: bool = False,
                 compute_dtype=torch.bfloat16, quant_dtype: str = "bfloat16",
                 use_kernel: bool = True, device=None, weight=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel and in_features % (2 * blocksize) == 0
        if isinstance(weight, QLinearWeight):
            self.use_kernel = True
            self._set_qweight(weight.to(dev))
        elif isinstance(weight, (tuple, list)):
            self.use_kernel = False
            packed, qs = weight
            self._set_bnb(packed.to(dev), qs.to(dev))
        else:
            w = _lecun_normal(out_features, in_features, dev, generator) if weight is None \
                else weight.detach().to(dev)
            if self.use_kernel:
                self._set_qweight(quantize_4bit_native(
                    w.float() if weight is None else w, blocksize=blocksize,
                    quant_type=quant_type, compress_statistics=compress_statistics))
            else:
                self._set_bnb(*F.quantize_4bit(
                    w.to(getattr(torch, quant_dtype)), blocksize=blocksize,
                    compress_statistics=compress_statistics, quant_type=quant_type))
        self.bias = _bias(out_features, bias, compute_dtype, dev)

    def _set_qweight(self, qw: QLinearWeight) -> None:
        if tuple(qw.shape) != (self.out_features, self.in_features):
            raise ValueError(f"weight shape {qw.shape} != {(self.out_features, self.in_features)}")
        self.quant_type, self.blocksize, self.weight_dtype = qw.quant_type, qw.blocksize, qw.dtype
        self.register_buffer("packed", qw.packed)
        self.register_buffer("absmax", qw.absmax)
        self.register_buffer("absmax_scale", qw.absmax_scale)
        self.register_buffer("absmax_offset", qw.absmax_offset)

    def _set_bnb(self, packed: torch.Tensor, qs: QuantState) -> None:
        if tuple(qs.shape) != (self.out_features, self.in_features):
            raise ValueError(f"weight shape {qs.shape} != {(self.out_features, self.in_features)}")
        self.quant_type, self.blocksize, self.weight_dtype = qs.quant_type, qs.blocksize, qs.dtype
        self.register_buffer("packed", packed)
        self.register_buffer("absmax", qs.absmax)
        self.register_buffer("code", qs.code)
        self.register_buffer("offset", qs.offset)
        s2 = qs.state2
        self.register_buffer("state2_absmax", None if s2 is None else s2.absmax)
        self.register_buffer("state2_code", None if s2 is None else s2.code)
        self._state2_meta = None if s2 is None else (s2.shape, s2.dtype, s2.blocksize,
                                                     s2.quant_type)

    @property
    def qweight(self) -> QLinearWeight:
        """The kernel-layout weight over this module's buffers."""
        return QLinearWeight(self.packed, self.absmax, (self.out_features, self.in_features),
                             self.blocksize, self.quant_type, self.weight_dtype,
                             self.absmax_scale, self.absmax_offset)

    @property
    def quant_state(self) -> QuantState:
        """The bnb-format QuantState over this module's buffers."""
        state2 = None
        if self._state2_meta is not None:
            shape, dtype, bs, qt = self._state2_meta
            state2 = QuantState(self.state2_absmax, self.state2_code, shape, dtype, bs, qt)
        return QuantState(self.absmax, self.code, (self.out_features, self.in_features),
                          self.weight_dtype, self.blocksize, self.quant_type, self.offset, state2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.in_features)
        if self.use_kernel:
            out = matmul_4bit_kernel(x2, self.qweight, self.bias)
        else:
            out = matmul_4bit(x2, self.packed, self.quant_state, self.bias)
        return out.reshape(*lead, self.out_features)


class LinearNF4(Linear4bit):
    def __init__(self, in_features: int, out_features: int, bias=True, **kw):
        kw.setdefault("quant_type", "nf4")
        super().__init__(in_features, out_features, bias, **kw)


class LinearFP4(Linear4bit):
    def __init__(self, in_features: int, out_features: int, bias=True, **kw):
        kw.setdefault("quant_type", "fp4")
        super().__init__(in_features, out_features, bias, **kw)


class Linear8bitLt(torch.nn.Module):
    """LLM.int8 linear layer.

    ``has_fp16_weights=True``: a trainable weight (parameter, compute
    dtype), quantized per row on every call; gradients reach it.
    ``has_fp16_weights=False``: a frozen int8 weight ``CB`` and row scales
    ``SCB`` (buffers). ``outlier_idx`` (static input columns) precomputes
    the outlier sidecar once. Kernel I runs up to 128 rows with
    ``threshold=0`` or with ``outlier_idx``; a threshold without
    ``outlier_idx`` finds outliers per call, in three steps without it.

    ``weight``: None (random lecun-normal), a float (out, in) tensor, or,
    frozen, a ``(CB, SCB)`` pair.
    """

    def __init__(self, in_features: int, out_features: int, bias=True,
                 has_fp16_weights: bool = False, threshold: float = 6.0,
                 compute_dtype=torch.bfloat16, outlier_idx=None, device=None, weight=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.has_fp16_weights, self.threshold = has_fp16_weights, threshold
        self.compute_dtype = compute_dtype
        if isinstance(weight, (tuple, list)):
            CB, SCB = (t.to(dev) for t in weight)
        else:
            w = _lecun_normal(out_features, in_features, dev, generator) if weight is None \
                else weight.detach().to(dev)
            if has_fp16_weights:
                self.weight = torch.nn.Parameter(w.to(compute_dtype))
            else:
                CB, SCB = F.int8_vectorwise_quant(w)
        if not has_fp16_weights:
            self.register_buffer("CB", CB)
            self.register_buffer("SCB", SCB)
            self.has_outliers = outlier_idx is not None
            if self.has_outliers:
                o = F.llm_int8_prepare_outliers(CB, SCB, outlier_idx)
                self.register_buffer("outlier_idx", o["idx"])
                self.register_buffer("outlier_keep", o["keep"])
                self.register_buffer("outlier_subB", o["subB"])
        self.bias = _bias(out_features, bias, compute_dtype, dev)

    @property
    def outliers(self) -> Optional[dict]:
        if self.has_fp16_weights or not self.has_outliers:
            return None
        return {"idx": self.outlier_idx, "keep": self.outlier_keep, "subB": self.outlier_subB}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.in_features)
        if self.has_fp16_weights:
            out = matmul_8bit_train(x2, self.weight, self.threshold, self.bias)
        else:
            out = matmul_8bit_lt(x2, self.CB, self.SCB, self.threshold, self.bias, self.outliers)
        return out.reshape(*lead, self.out_features)


class Embedding(torch.nn.Module):
    """A plain embedding table (``weight``, normal init) in ``dtype``."""

    def __init__(self, num_embeddings: int, features: int, dtype=torch.float32, device=None,
                 weight: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if weight is None:
            weight = torch.randn((num_embeddings, features), generator=generator, device=dev)
        self.weight = torch.nn.Parameter(weight.detach().to(device=dev, dtype=dtype).clone())

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.embedding(ids, self.weight)


class StableEmbedding(torch.nn.Module):
    """Embedding (f32 table, xavier-uniform init) followed by LayerNorm in
    f32, cast to ``dtype``. The LayerNorm's eps is flax's 1e-6; flax takes
    the variance as mean(x^2) - mean(x)^2, PyTorch by two passes, so the
    outputs agree within f32 rounding."""

    def __init__(self, num_embeddings: int, features: int, dtype=torch.float32, device=None,
                 weight: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        if weight is None:
            weight = torch.nn.init.xavier_uniform_(
                torch.empty((num_embeddings, features), device=dev), generator=generator)
        self.weight = torch.nn.Parameter(weight.detach().to(device=dev,
                                                            dtype=torch.float32).clone())
        self.norm = torch.nn.LayerNorm(features, eps=1e-6, device=dev, dtype=torch.float32)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.norm(torch.nn.functional.embedding(ids, self.weight)).to(self.dtype)


class OutlierAwareLinear(torch.nn.Module):
    """Linear whose weight is int8-quantized per row except on its outlier
    input dims (the z-score of each dim's population std over the rows
    above ``zscore``), which stay in the compute dtype as an exact
    sidecar."""

    def __init__(self, in_features: int, out_features: int, bias=True, zscore: float = 4.0,
                 compute_dtype=torch.bfloat16, device=None,
                 weight: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.zscore, self.compute_dtype = zscore, compute_dtype
        w = _lecun_normal(out_features, in_features, dev, generator) if weight is None else weight
        self.weight = torch.nn.Parameter(w.detach().to(device=dev, dtype=torch.float32).clone())
        self.bias = _bias(out_features, bias, compute_dtype, dev)

    def outlier_mask(self) -> torch.Tensor:
        std = self.weight.std(dim=0, correction=0)
        zstd = (std - std.mean()) * F._safe_inv(std.std(correction=0))
        return zstd > self.zscore

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        W, cd = self.weight, self.compute_dtype
        outlier = self.outlier_mask()
        keep = (~outlier).float()
        CB, SCB = F.int8_vectorwise_quant(W * keep[None, :])
        Wq = (CB.float() * F._div127(SCB)[:, None]).to(cd)
        x2 = x.reshape(-1, self.in_features).to(cd)
        out = (x2.float() @ Wq.float().T).to(cd)
        om = outlier.to(cd)
        side = (x2 * om[None, :]).float() @ (W.to(cd) * om[None, :]).float().T
        out = out + side.to(cd)
        if self.bias is not None:
            out = out + self.bias
        return out.reshape(*x.shape[:-1], self.out_features)


class SwitchBackLinearBnb(torch.nn.Module):
    """Int8 forward, full-precision backward (SwitchBack): a trainable
    weight in the compute dtype through ``matmul_8bit_train``."""

    def __init__(self, in_features: int, out_features: int, bias=True, threshold: float = 6.0,
                 compute_dtype=torch.bfloat16, device=None,
                 weight: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.threshold, self.compute_dtype = threshold, compute_dtype
        w = _lecun_normal(out_features, in_features, dev, generator) if weight is None else weight
        self.weight = torch.nn.Parameter(w.detach().to(device=dev, dtype=compute_dtype).clone())
        self.bias = _bias(out_features, bias, compute_dtype, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(-1, self.in_features).to(self.compute_dtype)
        out = matmul_8bit_train(x2, self.weight, self.threshold, self.bias)
        return out.reshape(*x.shape[:-1], self.out_features)


def _default_pred(path: tuple, leaf: torch.Tensor) -> bool:
    name = str(path[-1]) if path else ""
    return leaf.ndim == 2 and ("kernel" in name or "weight" in name)


def quantize_linear_params(params, quant_type: str = "nf4", blocksize: int = 64,
                           compress_statistics: bool = False,
                           predicate: Optional[Callable[[tuple, torch.Tensor], bool]] = None):
    """A copy of a tree of dicts and lists of tensors in which every leaf
    that ``predicate(path, leaf)`` accepts (by default a 2D tensor whose key
    names a "kernel" or "weight") becomes ``{"packed", "quant_state"}`` of
    ``functional.quantize_4bit``."""
    pred = predicate or _default_pred

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(path + (i,), v) for i, v in enumerate(node))
        if isinstance(node, torch.Tensor) and pred(path, node):
            packed, qs = F.quantize_4bit(node, blocksize=blocksize,
                                         compress_statistics=compress_statistics,
                                         quant_type=quant_type)
            return {"packed": packed, "quant_state": qs}
        return node

    return walk((), params)
