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

As in the JAX package, the engine also serves the bf16 cache
(``kv_quant=False``, contiguous only), several LoRA adapters at once
(``lora=stack_lora([...])``, one adapter id per request and slot), shared
prefixes (``register_prefix``: the prefix's KV is prefilled once and each
batch that uses it starts from a fresh copy of it, its suffixes at
positions ``plen + t``), snapshots of the whole serving state
(``snapshot``/``restore``, and ``durable_snapshot`` for ``torch.save``) and
speculative generation (``generate_speculative``, engine/speculative.py).
The cache is written in place, so a snapshot clones it and a restore
clones it back.

The engine is model-agnostic, as the JAX package's: any forward with the
``(params, cfg, tokens, cache, positions) -> (logits, cache)`` contract
serves through ``forward_fn`` (``gptj_forward``, ``opt_forward`` and their
family aliases; ``llama_forward`` by default), with the cache from
``init_cache_fn`` (``init_kv_cache`` by default, whose layout every family
shares). Every model call (prefill, prefix, decode step, speculative
target) goes through that one forward.

Tensor parallelism (``mesh=``, a ``DeviceMesh`` with the ``tp_axis`` dim):
every rank builds the engine over its shard of the params
(``parallel.shard_llama_params``), holds its kv heads of the caches and
serves through ``parallel.llama_forward_tp``, running the same host loop
in lockstep with the others, as the JAX package's engine runs one program
over the mesh.
"""

from __future__ import annotations

import dataclasses
import functools
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
    """Continuous-batching decode of a quantized decoder over the
    contiguous KV cache (int8, or bf16 with ``kv_quant=False``), or the
    paged int8 pool with ``EngineConfig(paged=True)``; ``forward_fn`` and
    ``init_cache_fn`` serve another family than Llama's; ``lora`` is a
    ``stack_lora`` tree whose adapters the requests pick by id."""

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
        # tensor parallelism: every rank builds the engine over its local
        # params (parallel.shard_llama_params) and runs the same host loop in
        # lockstep, so the page allocators and schedules stay identical
        self.mesh = mesh
        self._tp_axis = tp_axis
        tp = 1
        if mesh is not None:
            from ..parallel.mesh import axis_size

            tp = axis_size(mesh, tp_axis)  # a TypeError for anything but a DeviceMesh
            if engine_cfg.w8a8_prefill:
                raise NotImplementedError(
                    "w8a8_prefill does not compose with a TP mesh yet: the repacked {CB, SCB} "
                    "leaves would need their own shardings; use repack_params_int8 on the "
                    "unsharded tree before shard_llama_params instead")
            if engine_cfg.paged and getattr(model_cfg, "kv_bits", 8) == 4:
                raise NotImplementedError(
                    "kv_bits=4 does not compose with a TP mesh yet: the nib_prev staging leaves "
                    "need their own shardings")
        # multi-adapter serving: a stack_lora tree; each request picks its
        # adapter with add_request(adapter_id=...)
        self._lora = lora
        self._n_adapters = 1
        if lora is not None:
            if forward_fn is not None:
                # a family's forward must take the adapter kwargs (gptj_forward
                # and opt_forward do); a **kwargs wrapper passes them on
                import inspect

                sig = inspect.signature(forward_fn).parameters
                var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.values())
                if not var_kw and ("lora" not in sig or "lora_ids" not in sig):
                    raise NotImplementedError(
                        "forward_fn does not accept lora/lora_ids kwargs: lora serving needs a "
                        "forward with the llama_forward adapter contract")
            first = next(iter(lora[0].values()))
            if first["A"].dim() != 3:
                raise ValueError("engine lora must be the stacked form (stack_lora): a 2-D "
                                 "adapter would ignore adapter_ids")
            self._n_adapters = int(first["A"].shape[0])
        if engine_cfg.paged and not model_cfg.kv_quant:
            raise ValueError("paged mode requires kv_quant=True (int8 pages)")
        if engine_cfg.paged and model_cfg.max_seq_len % engine_cfg.page_size:
            raise ValueError("paged mode needs max_seq_len % page_size == 0")
        self.device = resolve_device(device)
        self._fwd = forward_fn or llama_forward
        self._init_cache = init_cache_fn or init_kv_cache
        # the caches hold this rank's kv heads under a mesh
        self._kv_cfg = model_cfg
        if mesh is not None:
            from ..parallel.llama_tp import (_check_divisible, llama_forward_tp, local_config,
                                             shard_lora_params)

            self._kv_cfg = local_config(model_cfg, tp)
            if forward_fn is None:
                _check_divisible(model_cfg, tp)
                self._fwd = functools.partial(llama_forward_tp, mesh=mesh, axis=tp_axis)
                if lora is not None:
                    # adapters shard congruently with the base projections
                    self._lora = shard_lora_params(lora, mesh, tp_axis)
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
            self.cache = init_page_pool(self._kv_cfg, n_pages, engine_cfg.page_size, self.device)
        else:
            self.cache = self._init_cache(self._kv_cfg, B, self.device)
        self.seq_lens = np.zeros((B,), np.int32)
        self.active = np.zeros((B,), bool)
        self.slot_tokens: List[List[int]] = [[] for _ in range(B)]
        self.slot_budget = np.zeros((B,), np.int32)
        self._last_tokens = np.zeros((B,), np.int32)
        self.slot_adapter = np.zeros((B,), np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._prefixes: Dict[int, Dict] = {}  # prefix_id -> {cache, tokens, adapter}
        self._next_prefix_id = 0
        self.last_speculative_stats: Optional[Dict] = None

    def _forward(self, params, cfg, tokens, cache, positions, adapter_ids):
        """The engine's forward with its adapters, one id per batch row."""
        if self._lora is None:
            return self._fwd(params, cfg, tokens, cache, positions)
        ids = torch.as_tensor(np.asarray(adapter_ids, np.int64), device=self.device)
        return self._fwd(params, cfg, tokens, cache, positions, lora=self._lora, lora_ids=ids)

    def _sample(self, logits: torch.Tensor) -> List[int]:
        """Greedy (first maximum) or temperature / top-k sampling; the step
        moves only the sampled ids to the host. Under a mesh every rank
        samples the same ids without a broadcast: the logits are the same
        bits on every rank (each all-reduce hands every rank the one reduced
        result, and the final norm and lm_head run replicated on the same
        inputs through deterministic kernels), and every rank's generator
        starts from the same seed and draws in the same order."""
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

    @torch.no_grad()
    def register_prefix(self, prefix_ids: Sequence[int], adapter_id: int = 0) -> int:
        """Prefill a shared prefix (e.g. a system prompt) once and keep its
        KV; ``add_requests(prefix=pid)`` then pays only the suffix prefill.
        The stored cache is (L, 1, ...), prefilled with adapter
        ``adapter_id`` (through the W8A8 repack with ``w8a8_prefill``)."""
        prompt = [int(t) for t in prefix_ids]
        if not prompt or len(prompt) > self.mcfg.max_seq_len - 2:
            raise ValueError("prefix must be non-empty and fit the cache")
        self._check_adapters([adapter_id])
        T = min(max(_bucket(len(prompt), self.ecfg.prefill_buckets), len(prompt)),
                self.mcfg.max_seq_len)
        toks = np.zeros((1, T), np.int32)
        toks[0, : len(prompt)] = prompt
        _, cache1 = self._prefill(toks, np.asarray([len(prompt)]), np.asarray([adapter_id]),
                                  T, None, 0)
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = {"cache": cache1, "tokens": prompt, "adapter": int(adapter_id)}
        return pid

    def unregister_prefix(self, pid: int) -> None:
        """Free a registered prefix's KV."""
        self._prefixes.pop(pid, None)

    def _check_adapters(self, adapter_ids) -> None:
        for a in adapter_ids:
            if not 0 <= a < self._n_adapters:
                raise ValueError(f"adapter_id {a} out of range [0, {self._n_adapters})")

    def add_request(self, prompt_ids: Sequence[int], max_new_tokens: Optional[int] = None,
                    adapter_id: int = 0) -> int:
        """Prefill a prompt into a free slot; returns the slot id."""
        return self.add_requests([prompt_ids], max_new_tokens, [adapter_id])[0]

    def _prefill(self, toks: np.ndarray, lens: np.ndarray, aid: np.ndarray, chunk: int,
                 pre: Optional[Dict], plen: int):
        """Prefill a padded batch (Kb, Tc) in chunks of ``chunk`` tokens at
        absolute offsets ``plen + off`` into a scratch cache that starts
        empty or as a fresh (L, Kb, ...) copy of the prefix's KV (the
        stored prefix is never written). Returns each row's next-token
        logits, from the chunk that holds its last token, and the cache."""
        Kb, Tc = toks.shape
        dev = self.device
        if pre is None:
            cacheK = self._init_cache(self._kv_cfg, Kb, dev)
        else:
            cacheK = {k: v.expand(v.shape[0], Kb, *v.shape[2:]).clone(
                memory_format=torch.contiguous_format) for k, v in pre["cache"].items()}
        rows = torch.arange(Kb, device=dev)
        last = None
        pparams = self._prefill_params()
        for off in range(0, Tc, chunk):
            pos = (plen + off + torch.arange(chunk, device=dev)).expand(Kb, chunk)
            logits, cacheK = self._forward(
                pparams, self._pf_cfg, torch.as_tensor(toks[:, off:off + chunk], device=dev),
                cacheK, pos, aid)
            idx = np.clip(lens - 1 - off, 0, chunk - 1)
            hit = torch.as_tensor((lens - 1 >= off) & (lens - 1 < off + chunk), device=dev)
            at = logits[rows, torch.as_tensor(idx, device=dev)]
            last = at if last is None else torch.where(hit[:, None], at, last)
            del logits
        return last, cacheK

    @torch.no_grad()
    def add_requests(self, prompts: Sequence[Sequence[int]], max_new_tokens: Optional[int] = None,
                     adapter_ids: Optional[Sequence[int]] = None, prefix: Optional[int] = None
                     ) -> List[int]:
        """Prefill several prompts as one padded batch, each after the
        registered prefix ``prefix`` if given; returns the slots."""
        slots = self.free_slots()
        if len(prompts) > len(slots):
            raise RuntimeError("not enough free slots; call step() until they free")
        if not prompts:
            return []
        budget = self.ecfg.max_new_tokens if max_new_tokens is None else max_new_tokens
        if budget < 1:
            raise ValueError("max_new_tokens must be >= 1")
        pre = self._prefixes[prefix] if prefix is not None else None
        plen = len(pre["tokens"]) if pre is not None else 0
        # omitted adapter_ids mean adapter 0, checked against the prefix's
        # adapter too (its KV holds that adapter's deltas)
        eff_ids = list(adapter_ids) if adapter_ids is not None else [0] * len(prompts)
        self._check_adapters(eff_ids)
        if pre is not None and any(a != pre["adapter"] for a in eff_ids):
            raise ValueError(f"prefix was registered with adapter {pre['adapter']}; "
                             "requests using it must match")
        for prompt in prompts:
            if plen + len(prompt) > self.mcfg.max_seq_len - 1:
                raise ValueError("prompt longer than max_seq_len")
        max_len = max(len(p) for p in prompts)
        T = min(max(_bucket(max_len, self.ecfg.prefill_buckets), max_len),
                self.mcfg.max_seq_len - plen)
        K = len(prompts)
        Kb = _pow2_bucket(K, self.ecfg.max_batch)
        lens = np.ones((Kb,), np.int64)  # dummy rows: len 1, adapter 0, never inserted
        aid = np.zeros((Kb,), np.int64)
        aid[:K] = eff_ids
        chunk = self.ecfg.prefill_chunk
        # chunking pads T up to a chunk multiple; a prompt whose padded
        # length overruns the cache takes one whole chunk, as the JAX engine
        # does (a clamped write would overwrite earlier KV)
        if not (0 < chunk < T and plen + -(-T // chunk) * chunk <= self.mcfg.max_seq_len):
            chunk = T
        toks = np.zeros((Kb, -(-T // chunk) * chunk), np.int32)
        for i, prompt in enumerate(prompts):
            toks[i, : len(prompt)] = prompt
            lens[i] = len(prompt)
        last, cacheK = self._prefill(toks, lens, aid, chunk, pre, plen)
        nxt = self._sample(last)

        if self._alloc is None:
            # each prompt's scratch row, whole, into its slot of every leaf
            for i in range(len(prompts)):
                for key, leaf in self.cache.items():
                    leaf[:, slots[i]] = cacheK[key][:, i]
        else:
            self._ingest(cacheK, [plen + len(p) for p in prompts], slots)
        del cacheK

        head = pre["tokens"] if pre is not None else []
        out_slots: List[int] = []
        for i, prompt in enumerate(prompts):
            slot = slots[i]
            tok = int(nxt[i])
            self.slot_tokens[slot] = head + list(prompt) + [tok]
            self.slot_adapter[slot] = aid[i]
            self.seq_lens[slot] = plen + len(prompt)
            self._last_tokens[slot] = tok
            self.slot_budget[slot] = budget - 1
            self.active[slot] = not (tok == self.ecfg.eos_token or self.slot_budget[slot] <= 0)
            out_slots.append(slot)
        return out_slots

    def _ingest(self, cacheK: Dict, n_tokens, slots) -> None:
        """Paged mode: allocate the pages of each prompt's ``n_tokens``
        (its prefix included) and copy its scratch rows into them."""
        Kb = cacheK["k"].shape[1]
        page_ids = np.zeros((Kb, self._alloc.max_pages), np.int32)
        used = np.zeros((Kb,), np.int32)
        valid = np.zeros((Kb,), bool)
        got: List[int] = []
        try:
            for i, n in enumerate(n_tokens):
                pages = self._alloc.alloc_slot(slots[i], n)
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
        logits, _ = self._forward(self.params, cfg, tokens, cache, positions, self.slot_adapter)
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

    def generate_speculative(self, prompts: Sequence[Sequence[int]], max_new_tokens: int,
                             draft_params: Dict, draft_cfg: LlamaConfig, gamma: int = 4,
                             temperature: float = 0.0, seed: int = 0,
                             draft_forward=None) -> List[List[int]]:
        """Speculative generation of the whole batch against this engine's
        model as the target (``speculative_generate_jit``): ragged prompts
        right-padded with per-row cursors, so each row gets its own
        prompt's generation; the batch commits in lockstep. Leaves the slot
        pool and cache alone. EOS truncation as in generate() (the EOS
        token kept, nothing after it). The round's statistics are kept in
        ``last_speculative_stats``. The target runs through the engine's
        forward, and the draft through ``draft_forward`` or the same one.
        Under a mesh both run tensor-parallel: pass ``draft_params`` sharded
        with ``shard_llama_params(draft_cfg)`` on the same mesh."""
        from .speculative import speculative_generate_jit

        if self._lora is not None:
            raise NotImplementedError("speculative decoding does not apply the engine's lora "
                                      "adapters: it would serve the base model")
        lens = [len(p) for p in prompts]
        if min(lens) < 1:
            raise ValueError("generate_speculative needs non-empty prompts")
        toks = np.zeros((len(prompts), max(lens)), np.int64)
        for i, pr in enumerate(prompts):
            toks[i, : lens[i]] = pr
        out, stats = speculative_generate_jit(
            self.params, self.mcfg, draft_params, draft_cfg,
            torch.as_tensor(toks, device=self.device), max_new_tokens, gamma=gamma,
            temperature=temperature, seed=seed,
            target_forward=self._fwd, draft_forward=draft_forward or self._fwd,
            lengths=torch.as_tensor(lens, device=self.device), mesh=self.mesh,
            tp_axis=self._tp_axis)
        self.last_speculative_stats = stats
        rows = out.tolist()
        eos = self.ecfg.eos_token
        if eos >= 0:
            rows = [r[: r.index(eos) + 1] if eos in r else r for r in rows]
        return rows

    # ------------------------------------------------------------- recovery
    def snapshot(self) -> Dict:
        """The serving state: a copy of the KV cache (the engine writes its
        cache in place) and the host-side scheduler state, the sampler's
        included, so that a restore resumes bit for bit."""
        snap = {
            "cache": {k: v.clone() for k, v in self.cache.items()},
            "seq_lens": self.seq_lens.copy(),
            "active": self.active.copy(),
            "slot_tokens": [list(t) for t in self.slot_tokens],
            "slot_budget": self.slot_budget.copy(),
            "slot_adapter": self.slot_adapter.copy(),
            "last_tokens": self._last_tokens.copy(),
            "rng": self._gen.get_state(),
        }
        if self._alloc is not None:  # the page tables ride the snapshot
            snap["page_tables"] = [list(self._alloc.tables.get(b, []))
                                   for b in range(self.ecfg.max_batch)]
        return snap

    def durable_snapshot(self) -> Dict:
        """snapshot() with every field a fixed-shape tensor, for
        ``torch.save``; ``torch.load`` reads it back with its default
        ``weights_only=True``."""
        snap = self.snapshot()
        # sized from the slots' contents: a per-call max_new_tokens may
        # exceed ecfg.max_new_tokens
        S = max(self.mcfg.max_seq_len + self.ecfg.max_new_tokens,
                max((len(t) for t in snap["slot_tokens"]), default=0) + 1)
        toks = np.zeros((self.ecfg.max_batch, S), np.int32)
        lens = np.zeros((self.ecfg.max_batch,), np.int32)
        for i, t in enumerate(snap.pop("slot_tokens")):
            toks[i, : len(t)] = t
            lens[i] = len(t)
        snap["slot_tokens_padded"] = toks
        snap["slot_token_lens"] = lens
        if "page_tables" in snap:
            tabs = snap.pop("page_tables")
            pt = np.zeros((self.ecfg.max_batch, self._alloc.max_pages), np.int32)
            pl = np.zeros((self.ecfg.max_batch,), np.int32)
            for i, t in enumerate(tabs):
                pt[i, : len(t)] = t
                pl[i] = len(t)
            snap["page_tables_padded"] = pt
            snap["page_table_lens"] = pl
        return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in snap.items()}

    def restore_durable(self, snap: Dict) -> None:
        """restore() from a durable_snapshot()."""
        snap = dict(snap)
        toks = np.asarray(snap.pop("slot_tokens_padded"))
        lens = np.asarray(snap.pop("slot_token_lens"))
        snap["slot_tokens"] = [[int(x) for x in row[:n]] for row, n in zip(toks, lens)]
        if "page_tables_padded" in snap:
            pt = np.asarray(snap.pop("page_tables_padded"))
            pl = np.asarray(snap.pop("page_table_lens"))
            snap["page_tables"] = [[int(x) for x in row[:n]] for row, n in zip(pt, pl)]
        self.restore(snap)

    def restore(self, snap: Dict) -> None:
        """Resume decoding from a snapshot of an engine of the same model
        and engine config: in-flight requests continue from their exact
        positions. The snapshot's cache is copied, so it can be restored
        again."""
        if self._alloc is not None and "page_tables" not in snap:
            raise ValueError("snapshot has no page tables: it was taken by a non-paged engine "
                             "and cannot restore into paged mode")
        self.cache = {k: torch.as_tensor(v).to(self.device, copy=True)
                      for k, v in snap["cache"].items()}
        self.seq_lens = np.asarray(snap["seq_lens"], np.int32).copy()
        self.active = np.asarray(snap["active"], bool).copy()
        self.slot_tokens = [list(t) for t in snap["slot_tokens"]]
        self.slot_budget = np.asarray(snap["slot_budget"], np.int32).copy()
        if "slot_adapter" in snap:
            self.slot_adapter = np.asarray(snap["slot_adapter"], np.int32).copy()
        else:
            # older snapshots were taken with every slot on adapter 0
            self.slot_adapter = np.zeros_like(self.slot_adapter)
        self._last_tokens = np.asarray(snap["last_tokens"], np.int32).copy()
        if self._alloc is not None:
            self._alloc.tables = {b: [int(p) for p in t]
                                  for b, t in enumerate(snap["page_tables"]) if len(t)}
            held = {p for t in self._alloc.tables.values() for p in t}
            self._alloc._free = [p for p in range(1, self._alloc.num_pages) if p not in held]
        if "rng" in snap:  # sampled decoding resumes bit for bit too
            self._gen.set_state(snap["rng"])
