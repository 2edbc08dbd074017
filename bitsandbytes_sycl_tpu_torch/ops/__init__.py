"""Ops of the port: each TPU kernel of the slice is a hand-written Hopper
kernel (``csrc/``) behind a wrapper that runs it on CUDA tensors and its
plain PyTorch version on CPU tensors."""

from .attention import prefill_attention_int8_stacked, prefill_attn_int8
from .common import QLinearWeight, quantize_4bit_native, resolve_device
from .matmul_4bit import matmul_4bit_fused, mm4_fused
from .matmul_w4a8 import matmul_4bit_w4a8, w4a8_gemv
from .paged_attention import (
    paged_attn_int8,
    paged_decode_attention_int8,
    paged_decode_attention_int8_stacked,
)

# the wrappers that launch a kernel, each with its `launches` counter
KERNELS = (w4a8_gemv, mm4_fused, prefill_attn_int8, paged_attn_int8)

__all__ = [
    "QLinearWeight",
    "quantize_4bit_native",
    "resolve_device",
    "matmul_4bit_w4a8",
    "matmul_4bit_fused",
    "prefill_attention_int8_stacked",
    "paged_decode_attention_int8",
    "paged_decode_attention_int8_stacked",
    "w4a8_gemv",
    "mm4_fused",
    "prefill_attn_int8",
    "paged_attn_int8",
    "KERNELS",
]
