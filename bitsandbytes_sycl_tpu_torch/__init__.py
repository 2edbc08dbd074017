"""bitsandbytes_sycl_tpu_torch: the PyTorch and CUDA port of
bitsandbytes_sycl_tpu for NVIDIA Hopper (H100).

It mirrors the JAX package's module paths and carries Llama serving: the
4-bit formats, the W4A8, exact 4-bit and LLM.int8 linears (with the
serving-time int8 repack), int8-KV prefill, contiguous and paged decode
attention, the Llama model and the continuous-batching engine in its
contiguous and paged modes; and QLoRA fine-tuning: the 4-bit linears'
backwards, LoRA adapters (``models/lora.py``) and the 8-bit optimizers
(``optim``): blockwise states in the dynamic maps or in any 256-entry
table (``functional.optimizer_update_8bit_blockwise(qmap1=, qmap2=)``,
the maps of ``codebooks`` and ``functional.estimate_quantiles``), and
whole-tensor states (``optim.*8bit(block_wise=False)``,
``functional.optimizer_update_8bit``). Each TPU kernel of those paths is
a hand-written sm_90a CUDA kernel under ``csrc/``, built by nvcc at
first use. Entry points run on CUDA unless given ``device="cpu"``,
where the kernels' plain PyTorch versions run.
"""

from . import codebooks, convert, functional, optim, utils
from .ops.common import QLinearWeight, quantize_4bit_native, resolve_device

__version__ = "0.1.0"

__all__ = ["codebooks", "convert", "functional", "optim", "utils", "QLinearWeight",
           "quantize_4bit_native", "resolve_device"]
