"""Ops of the port: each TPU kernel of the slice is a hand-written Hopper
kernel (``csrc/``) behind a wrapper that runs it on CUDA tensors and its
plain PyTorch version on CPU tensors."""

from .attention import (
    decode_attention_int8,
    decode_attention_int8_stacked,
    decode_attn_int8,
    prefill_attention_int8_stacked,
    prefill_attn_int8,
)
from .common import (QLinearWeight, from_kernel_layout, quantize_4bit_native, resolve_device,
                     to_kernel_layout)
from .matmul_4bit import dequantize_transposed, matmul_4bit_fused, mm4_fused
from .matmul_w4a8 import (
    dequant_int8,
    dequantize_to_int8,
    matmul_4bit_w4a8,
    matmul_4bit_w4a8_grouped,
    matmul_4bit_w8a8_prefill,
    w4a8_gemv,
    w4a8_grouped,
)
from .matmul_int8 import int8_matmul, int8_matmul_fused
from .optim8 import optim8_1state, optim8_2state, optim8_blockwise_fused
from .paged_attention import (
    paged_attn_int8,
    paged_decode_attention_int8,
    paged_decode_attention_int8_stacked,
)

# the wrappers that launch a kernel, each with its `launches` counter
KERNELS = (w4a8_gemv, mm4_fused, prefill_attn_int8, paged_attn_int8,
           dequantize_transposed, dequant_int8, w4a8_grouped, decode_attn_int8, int8_matmul,
           optim8_2state, optim8_1state)

__all__ = [
    "QLinearWeight",
    "quantize_4bit_native",
    "resolve_device",
    "to_kernel_layout",
    "from_kernel_layout",
    "matmul_4bit_w4a8",
    "matmul_4bit_fused",
    "matmul_4bit_w4a8_grouped",
    "matmul_4bit_w8a8_prefill",
    "dequantize_transposed",
    "dequantize_to_int8",
    "prefill_attention_int8_stacked",
    "decode_attention_int8",
    "decode_attention_int8_stacked",
    "int8_matmul_fused",
    "paged_decode_attention_int8",
    "paged_decode_attention_int8_stacked",
    "w4a8_gemv",
    "mm4_fused",
    "prefill_attn_int8",
    "paged_attn_int8",
    "dequant_int8",
    "w4a8_grouped",
    "decode_attn_int8",
    "int8_matmul",
    "optim8_blockwise_fused",
    "optim8_2state",
    "optim8_1state",
    "KERNELS",
]
