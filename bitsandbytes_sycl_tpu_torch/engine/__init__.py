"""Serving engine of the port: paged continuous batching."""

from .engine import EngineConfig, InferenceEngine
from .paged import PageAllocator, init_page_pool, paged_ingest

__all__ = ["EngineConfig", "InferenceEngine", "PageAllocator", "init_page_pool", "paged_ingest"]
