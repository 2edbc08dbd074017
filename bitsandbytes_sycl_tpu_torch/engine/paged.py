"""Paged int8 KV storage: a shared page pool and per-sequence page tables.

Pool leaves (L = layers, NP = pages, H = kv heads, P = page size):
K and V (L, NP, H, P, D) int8 token-major, scales (L, NP, H, P) f32.
A page id addresses the same slot in every layer, so one table serves the
whole model. Page ids follow the JAX package's allocator (pop from the end
of the free list, page 0 reserved), so pools can be compared page by page.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.common import resolve_device

__all__ = ["PageAllocator", "init_page_pool", "paged_ingest"]


class PageAllocator:
    """Host-side page bookkeeping: free list + per-slot page tables.
    ``reserve_page0`` keeps page 0 as the trash page that retired slots
    keep writing to."""

    def __init__(self, num_pages: int, page_size: int,
                 max_pages_per_seq: int, reserve_page0: bool = False):
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages = max_pages_per_seq
        self._free: List[int] = list(range(1 if reserve_page0 else 0, num_pages))
        self.tables: Dict[int, List[int]] = {}

    def free_pages(self) -> int:
        return len(self._free)

    def alloc_slot(self, slot: int, n_tokens: int) -> List[int]:
        """Allocate pages to hold n_tokens for `slot` (replacing any
        current allocation)."""
        self.release_slot(slot)
        need = max(1, -(-n_tokens // self.page_size))
        if need > self.max_pages:
            raise ValueError(f"{n_tokens} tokens exceed max_pages_per_seq")
        if need > len(self._free):
            raise RuntimeError("page pool exhausted")
        pages = [self._free.pop() for _ in range(need)]
        self.tables[slot] = pages
        return pages

    def extend_slot(self, slot: int, n_tokens: int) -> None:
        """Grow slot's allocation to cover n_tokens (decode growth)."""
        pages = self.tables.setdefault(slot, [])
        need = max(1, -(-n_tokens // self.page_size))
        if need > self.max_pages:
            raise ValueError("sequence exceeds max_pages_per_seq")
        while len(pages) < need:
            if not self._free:
                raise RuntimeError("page pool exhausted")
            pages.append(self._free.pop())

    def release_slot(self, slot: int) -> None:
        for p in self.tables.pop(slot, []):
            self._free.append(p)

    def table_array(self, slots: Sequence[int]) -> np.ndarray:
        """(B, max_pages) int32 table for the given slots; unused entries
        repeat the last page."""
        out = np.zeros((len(slots), self.max_pages), np.int32)
        for i, s in enumerate(slots):
            pages = self.tables.get(s, [0])
            out[i, : len(pages)] = pages
            out[i, len(pages):] = pages[-1] if pages else 0
        return out


def init_page_pool(cfg, num_pages: int, page_size: int, device=None) -> Dict:
    """Zeroed int8 page pool (see the module docstring for the layout)."""
    if page_size % 128:
        raise ValueError("page_size must be lane-aligned (multiple of 128)")
    bits = getattr(cfg, "kv_bits", 8)
    if bits == 4:
        raise NotImplementedError("int4 (kv_bits=4) pages are not ported yet (ROADMAP Queue B #3)")
    if bits != 8:
        raise ValueError(f"kv_bits must be 4 or 8, got {bits}")
    dev = resolve_device(device)
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.hd
    return {
        "k": torch.zeros((L, num_pages, H, page_size, D), dtype=torch.int8, device=dev),
        "v": torch.zeros((L, num_pages, H, page_size, D), dtype=torch.int8, device=dev),
        "k_scale": torch.zeros((L, num_pages, H, page_size), dtype=torch.float32, device=dev),
        "v_scale": torch.zeros((L, num_pages, H, page_size), dtype=torch.float32, device=dev),
    }


def paged_ingest(pool: Dict, cacheK: Dict, page_ids, used, valid) -> Dict:
    """Copy a contiguous prefill cache (k (L, K, H, D, S), v (L, K, H, S, D),
    scales (L, K, H, S)) into pool pages, in place: page j of valid row k
    (j < used[k]) goes to pool page page_ids[k, j]. The index arrays are
    host-side (numpy or lists)."""
    P = pool["v_scale"].shape[3]
    page_ids, used, valid = np.asarray(page_ids), np.asarray(used), np.asarray(valid)
    for k in range(page_ids.shape[0]):
        if not valid[k]:
            continue
        for j in range(int(used[k])):
            pid, s0 = int(page_ids[k, j]), j * P
            pool["k"][:, pid] = cacheK["k"][:, k, :, :, s0:s0 + P].transpose(-1, -2)
            pool["v"][:, pid] = cacheK["v"][:, k, :, s0:s0 + P, :]
            pool["k_scale"][:, pid] = cacheK["k_scale"][:, k, :, s0:s0 + P]
            pool["v_scale"][:, pid] = cacheK["v_scale"][:, k, :, s0:s0 + P]
    return pool
