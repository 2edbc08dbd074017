"""Paged int8 KV storage: a shared page pool and per-sequence page tables.

Pool leaves (L = layers, NP = pages, H = kv heads, P = page size):
K and V (L, NP, H, P, D) int8 token-major, scales (L, NP, H, P) f32. With
``kv_bits=4`` K and V are (L, NP, H, P/2, D) uint8: byte row r packs
token 2r (high nibble) and 2r + 1 (low), sign-magnitude codes on the +-7
grid, and the per-token scales are stored in parity-grouped column order
(``_scale_cols``), as ``ops.paged_attention`` reads them.
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
    """Zeroed page pool, int8 or (``cfg.kv_bits == 4``) kv4 (see the
    module docstring for the layout)."""
    if page_size % 128:
        raise ValueError("page_size must be lane-aligned (multiple of 128)")
    bits = getattr(cfg, "kv_bits", 8)
    if bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {bits}")
    dev = resolve_device(device)
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.hd
    rows = page_size // 2 if bits == 4 else page_size
    kv_dtype = torch.uint8 if bits == 4 else torch.int8
    return {
        "k": torch.zeros((L, num_pages, H, rows, D), dtype=kv_dtype, device=dev),
        "v": torch.zeros((L, num_pages, H, rows, D), dtype=kv_dtype, device=dev),
        "k_scale": torch.zeros((L, num_pages, H, page_size), dtype=torch.float32, device=dev),
        "v_scale": torch.zeros((L, num_pages, H, page_size), dtype=torch.float32, device=dev),
    }


def _pack4(c8: torch.Tensor, tok_axis: int) -> torch.Tensor:
    """int8 codes on the +-127 grid -> kv4 nibble pairs of adjacent tokens
    along ``tok_axis``: byte row r = token 2r (high nibble) | 2r + 1 (low),
    by ``ops.paged_attention.requant_nib4``."""
    from ..ops.paged_attention import requant_nib4

    ev, od = requant_nib4(c8).unflatten(tok_axis, (-1, 2)).unbind(tok_axis + 1)
    return (ev << 4) | od


def _scale_cols(s: torch.Tensor, tok_axis: int) -> torch.Tensor:
    """Per-token scales -> kv4's parity-grouped column order along
    ``tok_axis``: the even tokens, then the odd ones (token t at column
    (t % 2) * P/2 + t // 2)."""
    ev, od = s.unflatten(tok_axis, (-1, 2)).unbind(tok_axis + 1)
    return torch.cat([ev, od], dim=tok_axis)


def paged_ingest(pool: Dict, cacheK: Dict, page_ids, used, valid) -> Dict:
    """Copy a contiguous prefill cache (k (L, K, H, D, S), v (L, K, H, S, D),
    scales (L, K, H, S)) into pool pages, in place: page j of valid row k
    (j < used[k]) goes to pool page page_ids[k, j]; a kv4 pool takes the
    int8 rows requantized onto its +-7 grid (``_pack4``) and the scales in
    its column order. The index arrays are host-side (numpy or lists)."""
    P = pool["v_scale"].shape[3]
    kv4 = pool["v"].dtype == torch.uint8
    page_ids, used, valid = np.asarray(page_ids), np.asarray(used), np.asarray(valid)
    for k in range(page_ids.shape[0]):
        if not valid[k]:
            continue
        for j in range(int(used[k])):
            pid, s0 = int(page_ids[k, j]), j * P
            kp = cacheK["k"][:, k, :, :, s0:s0 + P].transpose(-1, -2)  # (L, H, P, D)
            vp = cacheK["v"][:, k, :, s0:s0 + P, :]
            ksp = cacheK["k_scale"][:, k, :, s0:s0 + P]
            vsp = cacheK["v_scale"][:, k, :, s0:s0 + P]
            if kv4:
                kp, vp = _pack4(kp, 2), _pack4(vp, 2)
                ksp, vsp = _scale_cols(ksp, 2), _scale_cols(vsp, 2)
            pool["k"][:, pid] = kp
            pool["v"][:, pid] = vp
            pool["k_scale"][:, pid] = ksp
            pool["v_scale"][:, pid] = vsp
    return pool
