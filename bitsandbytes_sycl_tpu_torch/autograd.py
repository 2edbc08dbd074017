"""Differentiable quantized matmuls as ``torch.autograd.Function``s (the
JAX package's ``autograd.py``, whose ``custom_vjp``s they follow):

- ``matmul_8bit_lt``: LLM.int8 with a frozen int8 weight (kernel I up to
  128 rows, threshold 0 or static outliers); the backward is full
  precision, grad_A = g @ (CB * SCB / 127);
- ``matmul_8bit_train``: the int8 forward of a trainable float weight,
  gradients to A, W and the bias in full precision;
- ``matmul_4bit``: a bnb-format 4-bit weight, through kernels B and E
  (``matmul_4bit_kernel``) where the kernel route applies, else the plain
  dequantize-and-matmul with its exact-dequant backward;
- ``matmul_4bit_kernel``: a kernel-layout weight, whose backward is
  ``ops.matmul_4bit.ExactDequantGrad`` (kernel E in f32, then an f32
  product).

Quantized weights get no gradient. ``matmul`` is ``bnb.matmul``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import functional as F
from .types import QuantState

__all__ = ["matmul", "matmul_4bit", "matmul_4bit_kernel", "matmul_8bit_lt", "matmul_8bit_train",
           "MatmulLtState", "GlobalOutlierPooler", "get_inverse_transform_indices", "undo_layout"]


class _MatMul8bitLt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, CB, SCB, threshold, bias, outliers):
        ctx.save_for_backward(CB, SCB)
        ctx.a_shape, ctx.a_dtype = A.shape, A.dtype
        ctx.has_bias, ctx.bias_dtype = bias is not None, None if bias is None else bias.dtype
        return F.llm_int8_matmul(A, CB, SCB, threshold=threshold, bias=bias, outliers=outliers)

    @staticmethod
    def backward(ctx, g):
        CB, SCB = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        grad_A = grad_b = None
        if ctx.needs_input_grad[0]:
            W = CB.float() * F._div127(SCB.float())[:, None]
            grad_A = (g2.float() @ W).reshape(ctx.a_shape).to(ctx.a_dtype)
        if ctx.has_bias and ctx.needs_input_grad[4]:
            grad_b = g2.float().sum(0).to(ctx.bias_dtype)
        return grad_A, None, None, None, grad_b, None


def matmul_8bit_lt(A: torch.Tensor, CB: torch.Tensor, SCB: torch.Tensor, threshold: float = 6.0,
                   bias: Optional[torch.Tensor] = None,
                   outliers: Optional[dict] = None) -> torch.Tensor:
    """LLM.int8 A @ dequant(CB)^T (+ bias) with the outlier sidecar
    (``functional.llm_int8_matmul``), differentiable in A and the bias."""
    return _MatMul8bitLt.apply(A, CB, SCB, threshold, bias, outliers)


class _MatMul8bitTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, W, threshold, bias):
        ctx.save_for_backward(A, W)
        ctx.has_bias, ctx.bias_dtype = bias is not None, None if bias is None else bias.dtype
        CB, SCB = F.int8_vectorwise_quant(W)
        return F.llm_int8_matmul(A, CB, SCB, threshold=threshold, bias=bias)

    @staticmethod
    def backward(ctx, g):
        A, W = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        A2 = A.reshape(-1, A.shape[-1]).float()
        grad_A = (g2 @ W.float()).reshape(A.shape).to(A.dtype) if ctx.needs_input_grad[0] else None
        grad_W = (g2.T @ A2).to(W.dtype) if ctx.needs_input_grad[1] else None
        grad_b = g2.sum(0).to(ctx.bias_dtype) if ctx.has_bias and ctx.needs_input_grad[3] else None
        return grad_A, grad_W, None, grad_b


def matmul_8bit_train(A: torch.Tensor, W: torch.Tensor, threshold: float = 0.0,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 forward of a trainable weight W (quantized per row each
    call); gradients reach A, W and the bias in full precision."""
    return _MatMul8bitTrain.apply(A, W, threshold, bias)


class _MatMul4bitRef(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, data, quant_state, bias):
        ctx.data, ctx.quant_state = data, quant_state
        ctx.a_dtype = A.dtype
        ctx.has_bias, ctx.bias_dtype = bias is not None, None if bias is None else bias.dtype
        return F.matmul_4bit_ref(A, data, quant_state, bias)

    @staticmethod
    def backward(ctx, g):
        grad_A = grad_b = None
        if ctx.needs_input_grad[0]:
            W = F.dequantize_4bit(ctx.data, ctx.quant_state).to(g.dtype)
            grad_A = torch.matmul(g.float(), W.float()).to(ctx.a_dtype)
        if ctx.has_bias and ctx.needs_input_grad[3]:
            grad_b = g.reshape(-1, g.shape[-1]).float().sum(0).to(ctx.bias_dtype)
        return grad_A, None, None, grad_b


def matmul_4bit_kernel(A: torch.Tensor, w, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A @ dequant(w)^T (+ bias) of a kernel-layout weight (QLinearWeight)
    in A's dtype: kernel B, or from 2048 rows kernel E and one dense
    matmul; differentiable in A and the bias (``ExactDequantGrad``)."""
    from .ops.matmul_4bit import matmul_4bit_fused

    return matmul_4bit_fused(A, w, bias, compute_dtype=A.dtype)


def matmul_4bit(A: torch.Tensor, data: torch.Tensor, quant_state: QuantState,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable 4-bit weight-only matmul A @ W^T (+ bias) of a
    bnb-format weight of logical shape (out, in). Where the kernel route
    applies (a 2D weight, in a multiple of 2 * blocksize) the weight is
    repacked once (``functional._cached_kernel_layout``) and runs through
    ``matmul_4bit_kernel``; otherwise the plain route. Gradients reach A
    and the bias only."""
    qw = F._route_fused_4bit(A, data, quant_state)
    if qw is not None:
        return matmul_4bit_kernel(A, qw, bias)
    return _MatMul4bitRef.apply(A, data, quant_state, bias)


@dataclasses.dataclass
class MatmulLtState:
    """bnb's per-layer LLM.int8 state as a plain value: the int8 weight
    and its row scales, or a float weight (``has_fp16_weights``)."""

    CB: Optional[torch.Tensor] = None  # int8 (N, K)
    SCB: Optional[torch.Tensor] = None  # f32 (N,)
    threshold: float = 0.0
    has_fp16_weights: bool = True
    use_pool: bool = False

    def reset_grads(self):
        return None


def matmul(A: torch.Tensor, B: Optional[torch.Tensor], SCB: Optional[torch.Tensor] = None,
           bias: Optional[torch.Tensor] = None, threshold: float = 0.0,
           state: Optional[MatmulLtState] = None) -> torch.Tensor:
    """``bnb.matmul``, the LLM.int8 linear:
    matmul(A, CB, SCB, ...) a pre-quantized int8 weight;
    matmul(A, W, threshold=...) a float weight, trainable;
    matmul(A, None, state=state, ...) bnb's state object."""
    if state is not None:
        if state.has_fp16_weights:
            return matmul_8bit_train(A, B, state.threshold, bias)
        return matmul_8bit_lt(A, state.CB, state.SCB, state.threshold, bias)
    if SCB is None:
        return matmul_8bit_train(A, B, threshold, bias)
    return matmul_8bit_lt(A, B, SCB, threshold, bias)


class GlobalOutlierPooler:
    """The outlier feature indices seen across the layers of one model (the
    first feature dimension seen; layers of another dimension are
    ignored)."""

    _instance = None

    def __init__(self):
        self.outliers = set()
        self.model_dim = None

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def initialize(self):
        self.outliers = set()
        self.model_dim = None

    def add_outliers(self, outlier_idx, feature_dim):
        if self.model_dim is None:
            self.model_dim = feature_dim
        if feature_dim != self.model_dim:
            return
        idx = outlier_idx.tolist() if isinstance(outlier_idx, torch.Tensor) else \
            np.asarray(outlier_idx).tolist()
        self.outliers.update(idx)

    def get_current_outlier_idx(self) -> torch.Tensor:
        return torch.tensor(sorted(self.outliers), dtype=torch.int32)


def get_inverse_transform_indices(transform_tile, tile_size) -> torch.Tensor:
    """The index permutation that undoes a tiled layout transform
    (``transform_tile`` maps a (d1, d2) int tensor to its tiled order)."""
    d1, d2 = tile_size
    assert d1 * d2 < 2 ** 31
    tile_indices = torch.arange(d1 * d2, dtype=torch.int64).reshape(d1, d2)
    permuted = torch.as_tensor(transform_tile(tile_indices)).reshape(-1).long().cpu()
    inverse = torch.empty_like(permuted)
    inverse[permuted] = torch.arange(permuted.numel(), dtype=torch.int64)
    return inverse.reshape(d1, d2).to(torch.int32)


def undo_layout(permuted_tensor: torch.Tensor, tile_indices: torch.Tensor) -> torch.Tensor:
    """Row-major order back from a tiled layout, by the inverse permutation
    of ``get_inverse_transform_indices``."""
    flat = permuted_tensor.reshape(-1)
    return flat[tile_indices.reshape(-1).long().to(flat.device)].reshape(permuted_tensor.shape)
