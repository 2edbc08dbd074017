"""Model families of the port: Llama, with QLoRA adapters."""

from .llama import LlamaConfig, init_kv_cache, init_params, llama_forward, quantize_params
from .lora import init_lora, lora_leaves, merge_lora, qlora_loss_fn, stack_lora

__all__ = ["LlamaConfig", "init_params", "quantize_params", "llama_forward", "init_kv_cache",
           "init_lora", "lora_leaves", "qlora_loss_fn", "merge_lora", "stack_lora"]
