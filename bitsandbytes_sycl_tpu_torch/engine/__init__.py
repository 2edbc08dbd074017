"""Serving engine of the port: continuous batching over the contiguous
cache or the paged pool, and speculative decoding."""

from .engine import EngineConfig, InferenceEngine
from .paged import PageAllocator, PagedKVPool, init_page_pool, paged_ingest
from .speculative import speculative_generate, speculative_generate_jit

__all__ = [
    "EngineConfig", "InferenceEngine", "PageAllocator", "PagedKVPool",
    "speculative_generate", "speculative_generate_jit", "init_page_pool", "paged_ingest",
]
