"""Model families of the port (this slice: Llama)."""

from .llama import LlamaConfig, init_kv_cache, init_params, llama_forward, quantize_params

__all__ = ["LlamaConfig", "init_params", "quantize_params", "llama_forward", "init_kv_cache"]
