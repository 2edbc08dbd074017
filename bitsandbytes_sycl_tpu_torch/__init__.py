"""bitsandbytes_sycl_tpu_torch: the PyTorch and CUDA port of
bitsandbytes_sycl_tpu for NVIDIA Hopper (H100).

Typical use::

    import bitsandbytes_sycl_tpu_torch as bnb

    packed, qs = bnb.quantize_nf4(w)
    y = bnb.matmul_4bit(x, packed, qs)

It mirrors the JAX package's module paths. The library surface: the
blockwise 8-bit and 4-bit quantizers and ``QuantState`` (``functional``,
``types``), the LLM.int8 functions, the differentiable matmuls
(``autograd``: ``matmul``, ``matmul_4bit``), the quantized layers
(``nn``: ``Linear4bit``, ``LinearNF4``, ``Linear8bitLt``, ...) and
``utils.replace_linear``. Serving: the 4-bit formats, the W4A8, exact
4-bit and LLM.int8 linears (with the serving-time int8 repack), int8-KV
prefill, contiguous and paged decode attention, the Llama model and the
continuous-batching engine in its contiguous and paged modes. QLoRA
fine-tuning: the 4-bit linears' backwards, LoRA adapters
(``models/lora.py``) and the 8-bit optimizers (``optim``), blockwise or
whole-tensor, in the dynamic maps or any 256-entry table. Each TPU kernel
of those paths is a hand-written sm_90a CUDA kernel under ``csrc/``, built
by nvcc at first use. Entry points run on CUDA unless given
``device="cpu"``, where the kernels' plain PyTorch versions run; the
functional entries follow their tensors' device.
"""

from . import autograd, codebooks, convert, functional, nn, optim, utils
from .autograd import MatmulLtState, matmul, matmul_4bit
from .functional import (
    dequantize_4bit,
    dequantize_blockwise,
    dequantize_fp4,
    dequantize_nf4,
    int8_double_quant,
    int8_linear_matmul,
    int8_mm_dequant,
    llm_int8_matmul,
    llm_int8_prepare_outliers,
    quantize_4bit,
    quantize_blockwise,
    quantize_fp4,
    quantize_nf4,
)
from .ops.common import QLinearWeight, quantize_4bit_native, resolve_device
from .types import QTensor, QuantState

__version__ = "0.1.0"

__all__ = [
    "codebooks",
    "functional",
    "QuantState",
    "QTensor",
    "quantize_blockwise",
    "dequantize_blockwise",
    "quantize_4bit",
    "dequantize_4bit",
    "quantize_nf4",
    "dequantize_nf4",
    "quantize_fp4",
    "dequantize_fp4",
    "int8_double_quant",
    "int8_linear_matmul",
    "int8_mm_dequant",
    "llm_int8_matmul",
    "llm_int8_prepare_outliers",
    "matmul",
    "matmul_4bit",
    "MatmulLtState",
    "autograd",
    "convert",
    "nn",
    "optim",
    "utils",
    "QLinearWeight",
    "quantize_4bit_native",
    "resolve_device",
]
