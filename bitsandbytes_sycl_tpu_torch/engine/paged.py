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

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.common import resolve_device

__all__ = ["PageAllocator", "PagedKVPool", "init_page_pool", "paged_ingest"]


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


class PagedKVPool(PageAllocator):
    """A fixed pool of int8 KV pages shared by all sequences and layers,
    with its allocator: the standalone (non-engine) API, which owns its
    tensors on ``device`` (CUDA unless given another) and writes them in
    place. ``init_page_pool`` gives the layout; the engine's paged mode
    keeps its pool in a dict beside a bare ``PageAllocator``."""

    def __init__(self, cfg, num_pages: int, page_size: int = 128,
                 max_pages_per_seq: Optional[int] = None, device=None):
        super().__init__(num_pages, page_size,
                         max_pages_per_seq or -(-cfg.max_seq_len // page_size))
        self.cfg = cfg
        if getattr(cfg, "kv_bits", 8) == 4:
            raise NotImplementedError(
                "kv_bits=4 pages are written by the engine's paged mode (nibble pairs of "
                "adjacent tokens); this pool writes int8 rows: use InferenceEngine(paged=True)")
        self.device = resolve_device(device)
        pool = init_page_pool(cfg, num_pages, page_size, self.device)
        self.k, self.v = pool["k"], pool["v"]
        self.k_scale, self.v_scale = pool["k_scale"], pool["v_scale"]

    def _leaves(self) -> Dict:
        return {"k": self.k, "v": self.v, "k_scale": self.k_scale, "v_scale": self.v_scale}

    # -------------------------------------------------------------- writes
    def write_decode_step(self, li: int, kq, ks, vq, vs, slots: Sequence[int], positions) -> None:
        """Write one decode step's quantized k/v of layer ``li``: kq (B, H,
        D, 1) int8, ks (B, H, 1), vq (B, H, 1, D), vs (B, H, 1), at the
        absolute ``positions`` (B,) of ``slots`` (whose pages the caller
        has extended to cover them)."""
        positions = np.asarray(positions, np.int64)
        for b, s in enumerate(slots):
            p = self.tables[s][int(positions[b]) // self.page_size]
            o = int(positions[b]) % self.page_size
            self.k[li, p, :, o] = kq[b, :, :, 0]
            self.v[li, p, :, o] = vq[b, :, 0]
            self.k_scale[li, p, :, o] = ks[b, :, 0]
            self.v_scale[li, p, :, o] = vs[b, :, 0]

    def ingest_contiguous(self, slot: int, cache: Dict, batch_index: int, n_tokens: int) -> None:
        """Allocate ``slot``'s pages for ``n_tokens`` and copy row
        ``batch_index`` of a contiguous int8 cache (models/llama layout: k
        (L, B, H, D, S), v (L, B, H, S, D), scales (L, B, H, S)) into them,
        page by page."""
        pages = self.alloc_slot(slot, n_tokens)
        row = {k: cache[k][:, batch_index:batch_index + 1] for k in self._leaves()}
        paged_ingest(self._leaves(), row, np.asarray([pages]), [len(pages)], [True])

    # ------------------------------------------------------------ attention
    def attend(self, li: int, q: torch.Tensor, slots: Sequence[int], lengths) -> torch.Tensor:
        """Paged decode attention of q (B, 1, Hq, D) over layer ``li`` of
        ``slots``' pages, ``lengths`` (B,) tokens each: kernel D's
        single-layer entry."""
        from ..ops.paged_attention import paged_decode_attention_int8

        pt = torch.as_tensor(self.table_array(slots), device=self.device)
        lens = torch.as_tensor(np.asarray(lengths, np.int32), device=self.device)
        return paged_decode_attention_int8(q, self.k[li], self.k_scale[li], self.v[li],
                                           self.v_scale[li], pt, lens)
