"""Pipeline parallelism: a GPipe microbatch pipeline over a "stage" mesh
dim, the JAX package's ``parallel/pipeline.py`` on ``torch.distributed``.

The layers are split into S contiguous stages and each rank keeps its own
stage's layers (``stack_stage_params``); embed, final norm and lm_head are
replicated. The classic (n_micro + S - 1)-tick schedule runs on every
rank: at tick t stage s runs microbatch t - s through its layers (no work
in its bubble ticks) and passes the boundary activation (mb, T, hidden) to
stage s + 1 by a point-to-point transfer, the only traffic between
stages. The last stage's outputs are broadcast so that every rank returns
the logits (the JAX package sums them with zeros from the other stages,
which gives the same bits).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..models.llama import (LlamaConfig, _attention, _mlp_act, _rms_norm, _rope, apply_linear,
                            init_kv_cache, write_and_attend)
from .llama_tp import _ROW, _shard_family, llama_param_specs, local_config
from .mesh import _p2p, axis_group, axis_rank, axis_size, broadcast

__all__ = [
    "stack_stage_params",
    "llama_forward_pp",
    "init_stage_kv_cache",
    "llama_forward_pp_decode",
]


def stack_stage_params(params: Dict, cfg: LlamaConfig, n_stages: int, mesh, axis: str = "stage",
                       tp_axis: Optional[str] = None):
    """This rank's stage: (its contiguous layers [s * L/S, (s + 1) * L/S),
    the replicated rest: embed, final_norm, lm_head). With ``tp_axis`` the
    stage's layers are also cut Megatron-style over that mesh dim
    (``llama_tp``'s specs), for ``llama_forward_pp_decode(tp_axis=...)``."""
    L = cfg.num_layers
    if L % n_stages:
        raise ValueError(f"num_layers {L} % n_stages {n_stages} != 0")
    if axis_size(mesh, axis) != n_stages:
        raise ValueError(f"n_stages {n_stages} != mesh dim {axis!r} ({axis_size(mesh, axis)})")
    per = L // n_stages
    s = axis_rank(mesh, axis)
    layers = params["layers"][s * per:(s + 1) * per]
    if tp_axis is not None:
        layers = _shard_family({"layers": layers}, llama_param_specs, cfg, mesh, tp_axis,
                               _ROW)["layers"]
    rest = {k: v for k, v in params.items() if k != "layers"}
    return layers, rest


def _embed(embed, toks, cfg):
    """Token embedding with Gemma's sqrt(hidden) scaling, as llama_forward."""
    x = embed[toks.long()].to(cfg.dtype)
    if getattr(cfg, "scale_embeddings", False):
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype, device=x.device)
    return x


def _head(x, rest: Dict, cfg) -> torch.Tensor:
    x = _rms_norm(x, rest["final_norm"], cfg.rms_eps, getattr(cfg, "norm_offset", False))
    if "lm_head" in rest:
        return apply_linear(x, rest["lm_head"], cfg).float()
    return (x.float() @ rest["embed"].to(cfg.dtype).float().T).to(cfg.dtype).float()


def _run_single_layer(layer, cfg1: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """One decoder layer on embedded activations (B, T, H), cacheless
    causal attention (the JAX package's layer body of the pipeline)."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))[None].expand(B, T, T)
    off = getattr(cfg1, "norm_offset", False)
    h = _rms_norm(x, layer["input_norm"], cfg1.rms_eps, off)
    q = apply_linear(h, layer["q_proj"], cfg1).reshape(B, T, cfg1.num_heads, cfg1.hd)
    k = apply_linear(h, layer["k_proj"], cfg1).reshape(B, T, cfg1.num_kv_heads, cfg1.hd)
    v = apply_linear(h, layer["v_proj"], cfg1).reshape(B, T, cfg1.num_kv_heads, cfg1.hd)
    q = _rope(q, positions, cfg1.rope_theta)
    k = _rope(k, positions, cfg1.rope_theta)
    attn = _attention(q, k, v, mask, cfg1.dtype).reshape(B, T, cfg1.num_heads * cfg1.hd)
    x = x + apply_linear(attn, layer["o_proj"], cfg1)
    h = _rms_norm(x, layer["post_attn_norm"], cfg1.rms_eps, off)
    gate = apply_linear(h, layer["gate_proj"], cfg1)
    up = apply_linear(h, layer["up_proj"], cfg1)
    return x + apply_linear(_mlp_act(cfg1, gate.float()).to(cfg1.dtype) * up,
                            layer["down_proj"], cfg1)


def _run_single_layer_cached(layer, cfg: LlamaConfig, x, cache1, positions, psum_axis=None):
    """One decoder layer on embedded activations with a single-layer view
    (leaves (1, B, ...)) of the stage's KV cache, written in place through
    the shared write_and_attend; ``psum_axis`` (the process group of a
    tensor-parallel dim inside the stage) all-reduces the o_proj and
    down_proj partial sums."""
    from .mesh import psum

    B, T, _ = x.shape
    off = getattr(cfg, "norm_offset", False)
    h = _rms_norm(x, layer["input_norm"], cfg.rms_eps, off)
    q = apply_linear(h, layer["q_proj"], cfg).reshape(B, T, cfg.num_heads, cfg.hd)
    k = apply_linear(h, layer["k_proj"], cfg).reshape(B, T, cfg.num_kv_heads, cfg.hd)
    v = apply_linear(h, layer["v_proj"], cfg).reshape(B, T, cfg.num_kv_heads, cfg.hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    attn, cache1 = write_and_attend(cache1, 0, q, k, v, positions, cfg)
    attn = attn.to(cfg.dtype).reshape(B, T, cfg.num_heads * cfg.hd)
    o = apply_linear(attn, layer["o_proj"], cfg)
    if psum_axis is not None:
        o = psum(o, psum_axis)
    x = x + o
    h = _rms_norm(x, layer["post_attn_norm"], cfg.rms_eps, off)
    gate = apply_linear(h, layer["gate_proj"], cfg)
    up = apply_linear(h, layer["up_proj"], cfg)
    d = apply_linear(_mlp_act(cfg, gate.float()).to(cfg.dtype) * up, layer["down_proj"], cfg)
    if psum_axis is not None:
        d = psum(d, psum_axis)
    return x + d, cache1


def _gpipe(run, n_micro: int, mb: int, T: int, cfg, mesh, axis: str, embed_mb, device):
    """The (n_micro + S - 1)-tick schedule on this rank: ``run(x, m)`` runs
    microbatch m through the stage; returns the last stage's outputs
    (n_micro, mb, T, hidden), broadcast to every rank of the stage dim."""
    S, sid, group = axis_size(mesh, axis), axis_rank(mesh, axis), axis_group(mesh, axis)
    shape = (mb, T, cfg.hidden_size)
    outs = torch.zeros((n_micro,) + shape, dtype=cfg.dtype, device=device)
    buf = None
    for t in range(n_micro + S - 1):
        m = t - sid
        sends = []
        if 0 <= m < n_micro:
            y = run(embed_mb(m) if sid == 0 else buf, m)
            if sid == S - 1:
                outs[m] = y
            else:
                sends = [(y.contiguous(), sid + 1)]
        # the boundary activation of the next tick: microbatch m + 1
        recvs = []
        if sid > 0 and 0 <= m + 1 < n_micro:
            buf = torch.empty(shape, dtype=cfg.dtype, device=device)
            recvs = [(buf, sid - 1)]
        _p2p(sends, recvs, group)
    if S > 1:
        broadcast(outs, group, src=S - 1)
    return outs


def llama_forward_pp(
    stage_layers: List[Dict],
    rest: Dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # (B, T); B % n_micro == 0
    mesh,
    n_micro: int,
    axis: str = "stage",
) -> torch.Tensor:
    """Cacheless pipelined forward (prefill or training style): returns the
    logits (B, T, vocab) f32 on every rank."""
    B, T = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} % n_micro {n_micro} != 0")
    mb = B // n_micro
    cfg1 = dataclasses.replace(cfg, num_layers=1)

    def run(x, m):
        for layer in stage_layers:
            x = _run_single_layer(layer, cfg1, x)
        return x

    outs = _gpipe(run, n_micro, mb, T, cfg, mesh, axis,
                  lambda m: _embed(rest["embed"], tokens[m * mb:(m + 1) * mb], cfg),
                  tokens.device)
    return _head(outs.reshape(B, T, cfg.hidden_size), rest, cfg)


def init_stage_kv_cache(cfg: LlamaConfig, batch: int, n_stages: int, mesh, axis: str = "stage",
                        tp_axis: Optional[str] = None) -> Dict:
    """This rank's stage of the KV cache: its own layers' (L/S leading),
    and with ``tp_axis`` its kv heads. The cache never moves between
    ranks; only boundary activations do."""
    c = dataclasses.replace(cfg, num_layers=cfg.num_layers // n_stages)
    if tp_axis is not None:
        c = local_config(c, axis_size(mesh, tp_axis))
    return init_kv_cache(c, batch, device=mesh.device_type)


def llama_forward_pp_decode(
    stage_layers: List[Dict],
    rest: Dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # (B, T): T = 1 decode, T = prompt prefill
    cache: Dict,  # from init_stage_kv_cache
    positions: torch.Tensor,  # (B, T) absolute positions
    mesh,
    n_micro: int = 1,
    axis: str = "stage",
    tp_axis: Optional[str] = None,
):
    """Pipelined cached forward: (logits (B, T, vocab) f32 on every rank,
    the rank's stage cache, updated in place). Prefill (positions 0..T-1)
    and decode (T = 1) alike. With ``tp_axis`` each stage's layers run
    Megatron TP over that mesh dim (params from
    ``stack_stage_params(tp_axis=...)``, cache from
    ``init_stage_kv_cache(tp_axis=...)``)."""
    B, T = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} % n_micro {n_micro} != 0")
    mb = B // n_micro
    per = cfg.num_layers // axis_size(mesh, axis)
    cfg1 = dataclasses.replace(cfg, num_layers=per)
    group = None
    if tp_axis is not None:
        cfg1 = local_config(cfg1, axis_size(mesh, tp_axis))
        group = axis_group(mesh, tp_axis)

    def run(x, m):
        rows = slice(m * mb, (m + 1) * mb)
        for li, layer in enumerate(stage_layers):
            # layer li, this microbatch's rows: a contiguous view, written in place
            cache1 = {k: c[li:li + 1, rows] for k, c in cache.items()}
            x, _ = _run_single_layer_cached(layer, cfg1, x, cache1, positions[rows], group)
        return x

    outs = _gpipe(run, n_micro, mb, T, cfg, mesh, axis,
                  lambda m: _embed(rest["embed"], tokens[m * mb:(m + 1) * mb], cfg),
                  tokens.device)
    return _head(outs.reshape(B, T, cfg.hidden_size), rest, cfg), cache
