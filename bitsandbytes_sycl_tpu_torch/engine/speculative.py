"""Speculative decoding: a cheap draft model proposes gamma tokens, the
target verifies them in one cached forward of gamma + 1 rows (Leviathan et
al., arxiv 2211.17192; greedy acceptance is exactly lossless).

The port of the JAX package's ``engine/speculative.py``. Both models use
the absolute-position KV cache, so rejected draft positions leave stale
entries that the next accepted tokens overwrite before the causal mask can
show them: no cache rollback. The verify step (T = gamma + 1) and the
draft's two-token ingest run where the attention kernels decline T < 8,
through the model's dequantize-then-attend route, as in the JAX package;
the draft's single-token steps run on the decode kernels. A quantization
of the same checkpoint drafts for free, e.g. NF4 for an LLM.int8 target.

``speculative_generate`` is the host loop; ``speculative_generate_jit``
keeps the JAX package's single-program loop semantics (a fixed two-token
draft ingest, every candidate written to the output, the cursors advanced
by the least acceptance + 1, per-row cursors for ragged prompts) as a
Python loop over device tensors. Both run on the device of ``prompts``
when it is a tensor, else on ``device`` (CUDA unless given another).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.llama import LlamaConfig, init_kv_cache, llama_forward
from ..ops.common import resolve_device

__all__ = ["speculative_generate", "speculative_generate_jit", "check_tp_draft"]


def _greedy(logits: torch.Tensor) -> np.ndarray:
    return logits.argmax(dim=-1).cpu().numpy().astype(np.int32)


def _probs(logits, temperature):
    l = np.asarray(logits, np.float64) / temperature  # noqa: E741
    l -= l.max(axis=-1, keepdims=True)
    e = np.exp(l)
    return e / e.sum(axis=-1, keepdims=True)


def _accept_and_correct(d_tokens, q, p, rng):
    """Speculative-sampling acceptance in numpy (Leviathan et al. §2.3):
    token j accepts with prob min(1, p_j(d_j)/q_j(d_j)); the first
    rejection resamples from norm(relu(p_j - q_j)); full acceptance draws
    the bonus token from p_gamma. Preserves the target distribution.

    d_tokens (B, g) draft proposals; q (B, g, V) draft distributions;
    p (B, g+1, V) target distributions. Returns (acc (B,), fix (B,)):
    acc[b] accepted count, fix[b] the correction/bonus token.
    """
    B, g = d_tokens.shape
    acc = np.zeros((B,), np.int64)
    fix = np.zeros((B,), np.int64)
    for b in range(B):
        j = 0
        while j < g:
            d = d_tokens[b, j]
            ratio = p[b, j, d] / max(q[b, j, d], 1e-30)
            if rng.random() < ratio:
                j += 1
                continue
            resid = np.maximum(p[b, j] - q[b, j], 0.0)
            tot = resid.sum()
            if tot <= 0:  # p <= q everywhere it matters: fall back to p
                resid, tot = p[b, j], p[b, j].sum()
            fix[b] = rng.choice(len(resid), p=resid / tot)
            break
        acc[b] = j
        if j == g:  # every proposal accepted: bonus token from p_gamma
            fix[b] = rng.choice(p.shape[-1], p=p[b, g] / p[b, g].sum())
    return acc, fix


def _device_of(prompts, device) -> torch.device:
    if device is None and isinstance(prompts, torch.Tensor):
        return prompts.device
    return resolve_device(device)


def check_tp_draft(draft_cfg: LlamaConfig, tp: int) -> None:
    """The draft of a tensor-parallel engine runs TP over the same mesh
    dim: the engine's divisibility contract, checked before any call."""
    if draft_cfg.num_heads % tp or draft_cfg.num_kv_heads % tp or \
            draft_cfg.intermediate_size % tp:
        raise ValueError(f"draft config not divisible by TP={tp} "
                         "(heads/kv_heads/intermediate_size)")


def _check_need(target_cfg, draft_cfg, need: int) -> None:
    # the draft writes KV as far as the target does; a too-short cache
    # would clamp writes onto earlier positions with no error
    for name, cfg in (("target", target_cfg), ("draft", draft_cfg)):
        if cfg.max_seq_len < need:
            raise ValueError(f"{name} max_seq_len {cfg.max_seq_len} < required {need} "
                             "(prompt + max_new_tokens + gamma + 1)")


@torch.no_grad()
def speculative_generate(
    target_params: Dict,
    target_cfg: LlamaConfig,
    draft_params: Dict,
    draft_cfg: LlamaConfig,
    prompts,  # (B, T) int, a common-length prompt batch
    max_new_tokens: int,
    gamma: int = 4,
    target_forward: Callable = llama_forward,
    draft_forward: Callable = llama_forward,
    temperature: float = 0.0,
    seed: int = 0,
    device=None,
) -> Tuple[np.ndarray, Dict]:
    """Speculative decode on the host loop: returns (tokens (B,
    max_new_tokens) numpy, {"target_calls", "accept_rate"}).

    temperature <= 0: greedy acceptance, the output of greedy decoding
    with the target alone. temperature > 0: speculative sampling
    (``_accept_and_correct`` on a ``np.random.default_rng(seed)`` stream),
    distributed as temperature sampling from the target alone.
    """
    dev = _device_of(prompts, device)
    prompts = torch.as_tensor(prompts, device=dev).long()
    B, T = prompts.shape
    _check_need(target_cfg, draft_cfg, T + max_new_tokens + gamma + 1)
    sampling = temperature > 0.0
    host_rng = np.random.default_rng(seed)

    t_cache = init_kv_cache(target_cfg, B, dev)
    d_cache = init_kv_cache(draft_cfg, B, dev)
    pos = torch.arange(T, device=dev).expand(B, T)

    def tfwd(tokens, cache, positions):
        return target_forward(target_params, target_cfg, tokens, cache, positions)

    def dfwd(tokens, cache, positions):
        return draft_forward(draft_params, draft_cfg, tokens, cache, positions)

    def dev_i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    # prefill both models; the target's last logits give the first token
    logits, t_cache = tfwd(prompts, t_cache, pos)
    _, d_cache = dfwd(prompts, d_cache, pos)
    if sampling:
        p0 = _probs(logits[:, -1].float().cpu().numpy(), temperature)
        last = np.asarray([host_rng.choice(p0.shape[-1], p=p0[b] / p0[b].sum())
                           for b in range(B)], np.int32)
    else:
        last = _greedy(logits[:, -1])  # (B,)

    out = np.zeros((B, max_new_tokens), np.int32)
    out[:, 0] = last
    n_done = 1
    cur = np.full((B,), T, np.int32)  # position of `last` (the next write)
    target_calls = 1
    proposed = accepted = 0
    # tokens the draft ingests before proposing: `last` (rewriting the
    # stale or corrected entry at its position); after a fully accepted
    # round also the draft's own last proposal, whose KV was never written
    pending = last[:, None]  # (B, L) ending at position `cur`

    while n_done < max_new_tokens:
        # the draft ingests the pending tokens, then proposes gamma tokens
        d_tokens = np.zeros((B, gamma), np.int32)
        q_rows = []  # sampling: the draft's distribution per proposal
        L = pending.shape[1]
        dl, d_cache = dfwd(dev_i(pending), d_cache,
                           dev_i(cur[:, None] + np.arange(-L + 1, 1)[None, :]))

        def propose(step_logits):
            if not sampling:
                return _greedy(step_logits)
            q = _probs(step_logits.float().cpu().numpy(), temperature)
            q_rows.append(q)
            return np.asarray([host_rng.choice(q.shape[-1], p=q[b] / q[b].sum())
                               for b in range(B)], np.int32)

        d_in = propose(dl[:, -1])
        d_tokens[:, 0] = d_in
        for j in range(1, gamma):
            dl, d_cache = dfwd(dev_i(d_in[:, None]), d_cache, dev_i((cur + j)[:, None]))
            d_in = propose(dl[:, 0])
            d_tokens[:, j] = d_in

        # the target verifies [last, d_1..d_gamma] in one cached forward
        ver_tokens = np.concatenate([last[:, None], d_tokens], axis=1)  # (B, g+1)
        ver_pos = cur[:, None] + np.arange(gamma + 1)[None, :]
        vl, t_cache = tfwd(dev_i(ver_tokens), t_cache, dev_i(ver_pos))
        target_calls += 1

        # per-sequence acceptance and the correction/bonus token
        if sampling:
            p_all = _probs(vl.float().cpu().numpy(), temperature)  # (B, g+1, V)
            acc, fix = _accept_and_correct(d_tokens, np.stack(q_rows, axis=1), p_all, host_rng)
        else:
            tgt = _greedy(vl)  # tgt[:, i] follows prefix..ver[i]
            match = d_tokens == tgt[:, :gamma]
            acc = np.where(match.all(axis=1), gamma, match.argmin(axis=1))  # (B,)
            fix = tgt[np.arange(B), acc]
        proposed += int(B * gamma)
        accepted += int(acc.sum())

        # the batch commits in lockstep: the least acceptance + 1 tokens for
        # every sequence, its own verified proposals then its correction
        step = int(acc.min()) + 1
        for b in range(B):
            toks = list(d_tokens[b, : acc[b]]) + [int(fix[b])]
            take = min(step, max_new_tokens - n_done)
            out[b, n_done: n_done + take] = toks[:take]
        last = out[:, min(n_done + step, max_new_tokens) - 1].copy()
        if step == gamma + 1:
            # fully accepted: d_gamma's KV is missing from the draft cache
            pending = np.stack([d_tokens[:, gamma - 1], last], axis=1)
        else:
            pending = last[:, None]
        cur = cur + step
        n_done += step

    return out, {"target_calls": target_calls, "accept_rate": accepted / max(proposed, 1)}


@torch.no_grad()
def speculative_generate_jit(
    target_params: Dict,
    target_cfg: LlamaConfig,
    draft_params: Dict,
    draft_cfg: LlamaConfig,
    prompts,  # (B, T) int, right-padded past each row's length
    max_new_tokens: int,
    gamma: int = 4,
    target_forward: Callable = llama_forward,
    draft_forward: Callable = llama_forward,
    temperature: float = 0.0,
    seed: int = 0,
    lengths=None,  # (B,) true prompt lengths (ragged)
    device=None,
    mesh=None,
    tp_axis: str = "model",
) -> Tuple[torch.Tensor, Dict]:
    """Speculative decode with the JAX package's single-program loop
    semantics: every round ingests a fixed two-token chunk [prev at cur-1,
    last at cur] into the draft (rewriting a correct position gives the
    same KV), drafts gamma tokens, verifies gamma + 1 at cur + arange(gamma
    + 1), writes all gamma + 1 candidates into the output and advances
    every row's cursor by the least acceptance + 1 (the uncommitted tail is
    overwritten by the next round). temperature <= 0: the target's own
    greedy tokens; > 0: sampling (``_accept_and_correct_torch``, the
    draft's proposals and the first token drawn from a ``torch.Generator``
    seeded with ``seed`` on the device).

    Ragged batches: ``lengths`` (B,) with prompts right-padded. Pad slots
    sit past the row's cursor and the absolute-position mask hides them
    until real tokens overwrite them, so each row gets its own prompt's
    generation.

    Tensor parallelism (``mesh``): the forwards are TP ones (the engine's,
    ``parallel.llama_forward_tp`` over ``tp_axis``) on this rank's shards
    of both models, and the two caches hold the rank's kv heads. The
    logits are the same bits on every rank, so every rank accepts the
    same tokens and the loop stays in lockstep.

    Returns (tokens (B, max_new_tokens) on the device, {"rounds",
    "target_calls", "accept_rate"}).
    """
    dev = _device_of(prompts, device)
    prompts = torch.as_tensor(prompts, device=dev).long()
    B, T = prompts.shape
    _check_need(target_cfg, draft_cfg, T + max_new_tokens + gamma + 2)
    sampling = temperature > 0.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = (torch.full((B,), T, dtype=torch.long, device=dev) if lengths is None
               else torch.as_tensor(lengths, device=dev).long())
    rows = torch.arange(B, device=dev)

    def sample(logits):
        if not sampling:
            return logits.argmax(dim=-1), None
        q = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(q, 1, generator=gen)[:, 0], q

    t_kv, d_kv = target_cfg, draft_cfg
    if mesh is not None:
        from ..parallel.llama_tp import local_config
        from ..parallel.mesh import axis_size

        tp = axis_size(mesh, tp_axis)
        check_tp_draft(draft_cfg, tp)
        t_kv, d_kv = local_config(target_cfg, tp), local_config(draft_cfg, tp)
    t_cache = init_kv_cache(t_kv, B, dev)
    d_cache = init_kv_cache(d_kv, B, dev)
    pos = torch.arange(T, device=dev).expand(B, T)
    logits, t_cache = target_forward(target_params, target_cfg, prompts, t_cache, pos)
    _, d_cache = draft_forward(draft_params, draft_cfg, prompts, d_cache, pos)
    first, _ = sample(logits[rows, lengths - 1])  # each row's last real slot

    out = torch.zeros((B, max_new_tokens + gamma + 2), dtype=torch.long, device=dev)
    out[:, 0] = first
    cur, last, prev = lengths.clone(), first, prompts[rows, lengths - 1]
    n_done, rounds = 1, 0
    accepted = torch.zeros((), dtype=torch.long, device=dev)
    while n_done < max_new_tokens:
        # the draft ingests [prev at cur-1 (the same KV again), last at cur]
        dl, d_cache = draft_forward(draft_params, draft_cfg, torch.stack([prev, last], dim=1),
                                    d_cache, torch.stack([cur - 1, cur], dim=1))
        d, q0 = sample(dl[:, -1])
        d_toks, q_rows = [d], [q0]
        for j in range(1, gamma):
            dl, d_cache = draft_forward(draft_params, draft_cfg, d[:, None], d_cache,
                                        (cur + j)[:, None])
            d, qj = sample(dl[:, 0])
            d_toks.append(d)
            q_rows.append(qj)
        d_tokens = torch.stack(d_toks, dim=1)  # (B, gamma)

        ver = torch.cat([last[:, None], d_tokens], dim=1)
        vpos = cur[:, None] + torch.arange(gamma + 1, device=dev)[None, :]
        vl, t_cache = target_forward(target_params, target_cfg, ver, t_cache, vpos)
        if sampling:
            p_all = torch.softmax(vl.float() / temperature, dim=-1)
            acc, fix = _accept_and_correct_torch(d_tokens, torch.stack(q_rows, dim=1), p_all, gen)
        else:
            tgt = vl.argmax(dim=-1)  # (B, gamma + 1)
            acc = torch.cumprod((d_tokens == tgt[:, :gamma]).long(), dim=1).sum(dim=1)  # (B,)
            fix = tgt[rows, acc]
        accepted += acc.sum()
        step = int(acc.min()) + 1

        # the candidates: d_1..d_gamma with the correction spliced in at acc
        cand = torch.cat([d_tokens, d_tokens[:, -1:]], dim=1)  # (B, gamma + 1)
        cand[rows, acc] = fix
        out[:, n_done: n_done + gamma + 1] = cand
        prev = cand[:, step - 2] if step >= 2 else last
        last = cand[:, step - 1]
        cur = cur + step
        n_done += step
        rounds += 1
    return out[:, :max_new_tokens], {
        "rounds": rounds, "target_calls": rounds + 1,
        "accept_rate": int(accepted) / max(B * gamma * rounds, 1)}


def _accept_and_correct_torch(d_tokens, q, p, gen: torch.Generator):
    """``_accept_and_correct`` on device tensors with a torch.Generator
    (the JAX package's ``_accept_and_correct_jax``): accept d_j while u_j <
    p_j(d_j) / q_j(d_j); the first rejection resamples from norm(relu(p_j -
    q_j)), full acceptance draws the bonus from p_gamma. d_tokens (B, g),
    q (B, g, V), p (B, g+1, V). Returns (acc (B,), fix (B,))."""
    B, g = d_tokens.shape
    u = torch.rand((B, g), generator=gen, device=d_tokens.device)
    idx = d_tokens[..., None]
    p_at = torch.gather(p[:, :g], -1, idx)[..., 0]
    q_at = torch.gather(q, -1, idx)[..., 0]
    accept = u < p_at / torch.clamp(q_at, min=1e-30)  # (B, g)
    acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # (B,)

    # the residual distribution at the rejection point (or p_gamma's bonus)
    rows = torch.arange(B, device=d_tokens.device)
    p_row = p[rows, acc]  # (B, V)
    q_row = q[rows, torch.clamp(acc, max=g - 1)]
    resid = torch.where((acc >= g)[:, None], p_row, torch.clamp(p_row - q_row, min=0.0))
    # a degenerate residual (p <= q everywhere): fall back to p_row
    resid = torch.where(resid.sum(-1, keepdim=True) <= 0.0, p_row, resid)
    fix = torch.multinomial(resid, 1, generator=gen)[:, 0]
    return acc, fix
