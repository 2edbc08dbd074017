"""Continuous-batching inference engine over the int8 KV cache.

The scheduler of the JAX package's engine, in PyTorch: each sequence owns
a batch slot; pending prompts prefill as one padded batch into a
contiguous scratch cache, whose rows are then copied into their slots of
the contiguous (B, ...) cache (the default) or into pool pages
(``EngineConfig(paged=True)``; a model config with ``kv_bits=4`` gets kv4
pages, as in the JAX package, whose contiguous cache stays int8 whatever
``kv_bits`` says); every decode step advances all slots at
once, inactive ones riding along (contiguous) or writing to the trash page
(paged); finished slots refill from the pending queue. Prompt lengths are
bucketed (at least 32) and the prefill batch is padded to a power of two,
so the row counts that route the linears are the JAX engine's. With
``EngineConfig.prefill_chunk`` > 0, prompts longer than a chunk prefill
chunk by chunk at absolute offsets into the scratch cache. With
``EngineConfig.w8a8_prefill``, each prefill batch runs on a transient int8
repack of the 4-bit weights (``repack_params_int8``), which decode never
holds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.llama import LlamaConfig, init_kv_cache, llama_forward, repack_params_int8
from ..ops.common import resolve_device
from .paged import PageAllocator, init_page_pool, paged_ingest

__all__ = ["EngineConfig", "InferenceEngine"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX package's EngineConfig, field for field."""

    max_batch: int = 8
    max_new_tokens: int = 128
    eos_token: int = -1  # -1: never stop on a token
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no top-k filter
    prefill_buckets: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048)
    prefill_chunk: int = 0
    paged: bool = False
    page_size: int = 128
    num_pages: int = 0
    w8a8_prefill: bool = False


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pow2_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _grid_bucket(n: int, cap: int) -> int:
    b = n if n <= 2 else 4 * ((n + 3) // 4)
    return max(1, min(b, cap))


class InferenceEngine:
    """Continuous-batching decode of a quantized Llama-family model over
    the contiguous int8 KV cache, or the paged pool with
    ``EngineConfig(paged=True)``."""

    def __init__(
        self,
        model_cfg: LlamaConfig,
        params: Dict,
        engine_cfg: EngineConfig = EngineConfig(),
        forward_fn=None,
        init_cache_fn=None,
        mesh=None,
        tp_axis: str = "model",
        lora=None,
        device=None,
        seed: int = 0,
    ):
        if lora is not None:
            raise NotImplementedError("multi-LoRA serving is not ported yet (ROADMAP Queue A #6)")
        if mesh is not None:
            raise NotImplementedError("tensor parallelism is not ported yet (ROADMAP Queue A #13)")
        if forward_fn is not None or init_cache_fn is not None:
            raise NotImplementedError("other model families are not ported yet (ROADMAP Queue A #10)")
        if engine_cfg.paged and not model_cfg.kv_quant:
            raise ValueError("paged mode requires kv_quant=True (int8 pages)")
        if not model_cfg.kv_quant:
            raise NotImplementedError(
                "the bf16 KV cache (kv_quant=False) is not ported yet (ROADMAP Queue A #4)")
        if engine_cfg.paged and model_cfg.max_seq_len % engine_cfg.page_size:
            raise ValueError("paged mode needs max_seq_len % page_size == 0")
        self.device = resolve_device(device)
        self.mcfg = model_cfg
        self.ecfg = engine_cfg
        self.params = params
        # prefill calls run under the int8 repack's config with w8a8_prefill
        self._pf_cfg = (dataclasses.replace(model_cfg, quant="int8", llm_int8_threshold=0.0)
                        if engine_cfg.w8a8_prefill else model_cfg)
        B = engine_cfg.max_batch
        self._alloc = None
        if engine_cfg.paged:
            maxp = model_cfg.max_seq_len // engine_cfg.page_size
            n_pages = engine_cfg.num_pages or (B * maxp + 1)
            # page 0 is the reserved trash page: retired slots keep writing there
            self._alloc = PageAllocator(n_pages, engine_cfg.page_size, maxp, reserve_page0=True)
            self.cache = init_page_pool(model_cfg, n_pages, engine_cfg.page_size, self.device)
        else:
            self.cache = init_kv_cache(model_cfg, B, self.device)
        self.seq_lens = np.zeros((B,), np.int32)
        self.active = np.zeros((B,), bool)
        self.slot_tokens: List[List[int]] = [[] for _ in range(B)]
        self.slot_budget = np.zeros((B,), np.int32)
        self._last_tokens = np.zeros((B,), np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, logits: torch.Tensor) -> List[int]:
        """Greedy (first maximum) or temperature / top-k sampling; the step
        moves only the sampled ids to the host."""
        t = float(self.ecfg.temperature)
        if t <= 0.0:
            return logits.argmax(dim=-1).tolist()
        lg = logits.float() / t
        if self.ecfg.top_k > 0:
            kth = torch.sort(lg, dim=-1).values[:, -self.ecfg.top_k][:, None]
            lg = torch.where(lg < kth, torch.full_like(lg, -float("inf")), lg)
        probs = torch.softmax(lg, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].tolist()

    def _prefill_params(self) -> Dict:
        """The params the prefill calls see: the engine's, or with
        w8a8_prefill an int8 repack built anew for each prefill batch and
        dropped after it."""
        if not self.ecfg.w8a8_prefill:
            return self.params
        return repack_params_int8(self.params, self.mcfg)[0]

    # ----------------------------------------------------------------- slots
    def free_slots(self) -> List[int]:
        return [i for i in range(self.ecfg.max_batch) if not self.active[i]]

    def register_prefix(self, prefix_ids, adapter_id: int = 0) -> int:
        raise NotImplementedError("the prefix cache is not ported yet (ROADMAP Queue A #6)")

    def add_request(self, prompt_ids: Sequence[int], max_new_tokens: Optional[int] = None,
                    adapter_id: int = 0) -> int:
        """Prefill a prompt into a free slot; returns the slot id."""
        return self.add_requests([prompt_ids], max_new_tokens, [adapter_id])[0]

    @torch.no_grad()
    def add_requests(self, prompts: Sequence[Sequence[int]], max_new_tokens: Optional[int] = None,
                     adapter_ids: Optional[Sequence[int]] = None, prefix: Optional[int] = None
                     ) -> List[int]:
        """Prefill several prompts as one padded batch; returns the slots."""
        if prefix is not None:
            raise NotImplementedError("the prefix cache is not ported yet (ROADMAP Queue A #6)")
        if adapter_ids is not None and any(a != 0 for a in adapter_ids):
            raise NotImplementedError("multi-LoRA serving is not ported yet (ROADMAP Queue A #6)")
        slots = self.free_slots()
        if len(prompts) > len(slots):
            raise RuntimeError("not enough free slots; call step() until they free")
        if not prompts:
            return []
        budget = self.ecfg.max_new_tokens if max_new_tokens is None else max_new_tokens
        if budget < 1:
            raise ValueError("max_new_tokens must be >= 1")
        for prompt in prompts:
            if len(prompt) > self.mcfg.max_seq_len - 1:
                raise ValueError("prompt longer than max_seq_len")
        max_len = max(len(p) for p in prompts)
        T = min(max(_bucket(max_len, self.ecfg.prefill_buckets), max_len), self.mcfg.max_seq_len)
        K = len(prompts)
        Kb = _pow2_bucket(K, self.ecfg.max_batch)
        toks = np.zeros((Kb, T), np.int32)
        lens = np.ones((Kb,), np.int64)  # dummy rows: len 1, never inserted
        for i, prompt in enumerate(prompts):
            toks[i, : len(prompt)] = prompt
            lens[i] = len(prompt)
        dev = self.device
        cacheK = init_kv_cache(self.mcfg, Kb, dev)
        rows = torch.arange(Kb, device=dev)
        chunk = self.ecfg.prefill_chunk
        # chunking pads T up to a chunk multiple; a prompt whose padded
        # length overruns the cache takes one whole chunk, as the JAX engine
        # does (a clamped write would overwrite earlier KV)
        if not (0 < chunk < T and -(-T // chunk) * chunk <= self.mcfg.max_seq_len):
            chunk = T
        # chunks at absolute offsets into the scratch cache; each prompt's
        # next-token logits come from the chunk holding its last token
        Tc = -(-T // chunk) * chunk
        toks_c = np.zeros((Kb, Tc), np.int32)
        toks_c[:, :T] = toks
        last = None
        pparams = self._prefill_params()
        for off in range(0, Tc, chunk):
            pos = (off + torch.arange(chunk, device=dev)).expand(Kb, chunk)
            logits, cacheK = llama_forward(
                pparams, self._pf_cfg, torch.as_tensor(toks_c[:, off:off + chunk], device=dev),
                cacheK, pos)
            idx = np.clip(lens - 1 - off, 0, chunk - 1)
            hit = torch.as_tensor((lens - 1 >= off) & (lens - 1 < off + chunk), device=dev)
            at = logits[rows, torch.as_tensor(idx, device=dev)]
            last = at if last is None else torch.where(hit[:, None], at, last)
            del logits
        del pparams
        nxt = self._sample(last)

        if self._alloc is None:
            # each prompt's scratch row, whole, into its slot of every leaf
            for i in range(len(prompts)):
                for key, leaf in self.cache.items():
                    leaf[:, slots[i]] = cacheK[key][:, i]
        else:
            self._ingest(cacheK, prompts, slots)
        del cacheK

        out_slots: List[int] = []
        for i, prompt in enumerate(prompts):
            slot = slots[i]
            tok = int(nxt[i])
            self.slot_tokens[slot] = list(prompt) + [tok]
            self.seq_lens[slot] = len(prompt)
            self._last_tokens[slot] = tok
            self.slot_budget[slot] = budget - 1
            self.active[slot] = not (tok == self.ecfg.eos_token or self.slot_budget[slot] <= 0)
            out_slots.append(slot)
        return out_slots

    def _ingest(self, cacheK: Dict, prompts, slots) -> None:
        """Paged mode: allocate each prompt's pages and copy its scratch
        rows into them."""
        Kb = cacheK["k"].shape[1]
        page_ids = np.zeros((Kb, self._alloc.max_pages), np.int32)
        used = np.zeros((Kb,), np.int32)
        valid = np.zeros((Kb,), bool)
        got: List[int] = []
        try:
            for i, prompt in enumerate(prompts):
                pages = self._alloc.alloc_slot(slots[i], len(prompt))
                page_ids[i, : len(pages)] = pages
                used[i] = len(pages)
                valid[i] = True
                got.append(slots[i])
        except (RuntimeError, ValueError):
            for s in got:  # don't leak pages on pool exhaustion
                self._alloc.release_slot(s)
            raise
        paged_ingest(self.cache, cacheK, page_ids, used, valid)

    def _paged_cache(self):
        """Paged mode: this step's page tables and write places in a cache
        dict beside the pool, and the config with its page-horizon hint."""
        B = self.ecfg.max_batch
        P = self.ecfg.page_size
        dev = self.device
        # inactive rows write to the reserved trash page 0
        wp = np.zeros((B,), np.int32)
        wo = np.zeros((B,), np.int32)
        used_pages = 1
        for b in range(B):
            if self.active[b]:
                pos = int(self.seq_lens[b])
                self._alloc.extend_slot(b, pos + 1)
                wp[b] = self._alloc.tables[b][pos // P]
                wo[b] = pos % P
                used_pages = max(used_pages, -(-pos // P))
        hint = _grid_bucket(used_pages, self.mcfg.max_seq_len // P)
        cache = dict(self.cache)
        cache["page_table"] = torch.as_tensor(self._alloc.table_array(range(B)), device=dev)
        cache["write_page"] = torch.as_tensor(wp, device=dev)
        cache["write_off"] = torch.as_tensor(wo, device=dev)
        return cache, dataclasses.replace(self.mcfg, pages_hint=hint)

    @torch.no_grad()
    def step(self) -> Dict[int, int]:
        """One decode step for every active slot. Returns {slot: new_token}
        and retires finished slots."""
        if not self.active.any():
            return {}
        B = self.ecfg.max_batch
        dev = self.device
        if self._alloc is None:  # inactive slots ride along at their last position
            cache, cfg = self.cache, self.mcfg
        else:
            cache, cfg = self._paged_cache()
        tokens = torch.as_tensor(self._last_tokens.reshape(B, 1), device=dev)
        positions = torch.as_tensor(self.seq_lens.reshape(B, 1).astype(np.int64), device=dev)
        logits, _ = llama_forward(self.params, cfg, tokens, cache, positions)
        nxt = self._sample(logits[:, 0])
        out: Dict[int, int] = {}
        for b in range(B):
            if not self.active[b]:
                continue
            self.seq_lens[b] += 1
            tok = int(nxt[b])
            self.slot_tokens[b].append(tok)
            self._last_tokens[b] = tok
            out[b] = tok
            self.slot_budget[b] -= 1
            if (tok == self.ecfg.eos_token or self.slot_budget[b] <= 0
                    or self.seq_lens[b] >= self.mcfg.max_seq_len - 1):
                self.active[b] = False
                if self._alloc is not None:
                    self._alloc.release_slot(b)
        return out

    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: Optional[int] = None,
                 adapter_ids: Optional[Sequence[int]] = None, on_token=None) -> List[List[int]]:
        """Continuous batching: streams prompts through the slot pool.
        ``on_token(request_id, token)`` streams each generated token."""
        pending = list(enumerate(prompts))
        results: Dict[int, List[int]] = {}
        slot_owner: Dict[int, int] = {}

        def fill():
            take = min(len(pending), len(self.free_slots()))
            if not take:
                return
            batch = [pending.pop(0) for _ in range(take)]
            aids = [adapter_ids[rid] if adapter_ids is not None else 0 for rid, _ in batch]
            slots = self.add_requests([p for _, p in batch], max_new_tokens, aids)
            for (rid, prompt), slot in zip(batch, slots):
                if on_token is not None:
                    on_token(rid, self.slot_tokens[slot][-1])
                if self.active[slot]:
                    slot_owner[slot] = rid
                else:  # retired at prefill (budget 1 or first-token EOS)
                    results[rid] = self.slot_tokens[slot][len(prompt):]

        fill()
        while self.active.any() or pending:
            before = self.active.copy()
            new = self.step()
            if on_token is not None:
                for slot, tok in new.items():
                    if slot in slot_owner:
                        on_token(slot_owner[slot], tok)
            for b in range(self.ecfg.max_batch):
                if before[b] and not self.active[b]:
                    rid = slot_owner.pop(b, None)
                    if rid is None:
                        continue
                    results[rid] = self.slot_tokens[b][len(prompts[rid]):]
            fill()
        return [results[i] for i in range(len(prompts))]

    def generate_speculative(self, *args, **kwargs):
        raise NotImplementedError("speculative decoding is not ported yet (ROADMAP Queue A #12)")

    def snapshot(self):
        raise NotImplementedError("engine snapshots are not ported yet (ROADMAP Queue A #6)")

    def restore(self, snap):
        raise NotImplementedError("engine snapshots are not ported yet (ROADMAP Queue A #6)")
