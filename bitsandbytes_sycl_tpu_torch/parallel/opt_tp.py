"""Tensor-parallel OPT / GPT-2 / BLOOM forward over a "model" mesh dim, the
JAX package's ``parallel/opt_tp.py`` on ``torch.distributed``: llama_tp's
scheme on the sequential pre-LN block (``models/opt.py``):

- q/k/v/fc1: column-parallel, their biases shard with the output channels;
- out_proj/fc2: row-parallel, one all-reduce per sub-block per layer;
  out_bias and fc2_b stay replicated and go in once, after the sums;
- int8 KV cache sharded over the head dim; wte/wpe/LayerNorms/lm_head and
  OPT-350M's project_in/out replicated;
- ALiBi (BLOOM): the slope sequence is global, so each rank takes its
  contiguous block of it (``alibi_total_heads``, ``alibi_axis``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.opt import OPTConfig, opt_forward
from .llama_tp import _REP, _map, _proj_spec, _shard_family, local_config
from .mesh import axis_group, axis_size

__all__ = ["opt_param_specs", "shard_opt_params", "opt_forward_tp"]

_COL = ("q_proj", "k_proj", "v_proj", "fc1")
_ROW = ("out_proj", "fc2")


def opt_param_specs(params: Dict, cfg: OPTConfig, axis: str = "model") -> Dict:
    specs = {k: _map(lambda _: _REP, v) for k, v in params.items() if k != "layers"}
    specs["layers"] = []
    for layer in params["layers"]:
        ls = {}
        for name, w in layer.items():
            if name in _COL or name in _ROW:
                ls[name] = _proj_spec(name, w, axis, col=_COL, row=_ROW)
            elif name in ("q_bias", "k_bias", "v_bias", "fc1_b"):
                # with the column-parallel output channels; out_bias and
                # fc2_b stay replicated (added once, after the sums)
                ls[name] = (axis,)
            else:
                ls[name] = _REP
        specs["layers"].append(ls)
    return specs


def shard_opt_params(params: Dict, cfg: OPTConfig, mesh, axis: str = "model") -> Dict:
    """This rank's local params (row weights retiled, leaves cut by
    ``opt_param_specs``)."""
    return _shard_family(params, opt_param_specs, cfg, mesh, axis, _ROW)


def opt_forward_tp(
    params: Dict,
    cfg: OPTConfig,
    tokens: torch.Tensor,
    cache: Optional[Dict],
    positions: torch.Tensor,
    mesh,
    axis: str = "model",
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """TP forward of this rank: local params (``shard_opt_params``), the
    rank's head shard of the cache. Returns the replicated logits and the
    rank's updated cache."""
    tp = axis_size(mesh, axis)
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"TP={tp} must divide num_heads({cfg.num_heads})")
    group = axis_group(mesh, axis)
    alibi = getattr(cfg, "alibi", False)
    cfg_local = dataclasses.replace(
        local_config(cfg, tp), kv_heads=cfg.num_kv_heads // tp,
        alibi_total_heads=cfg.num_heads if alibi else None,
        alibi_axis=group if alibi else None)
    return opt_forward(params, cfg_local, tokens, cache, positions, psum_axis=group)
