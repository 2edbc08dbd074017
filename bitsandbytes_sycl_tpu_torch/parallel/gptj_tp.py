"""Tensor-parallel GPT-J forward over a "model" mesh dim, the JAX package's
``parallel/gptj_tp.py`` on ``torch.distributed``: llama_tp's scheme on the
GPT-J block (parallel attention and MLP off one LayerNorm):

- q/k/v/fc_in: column-parallel; fc_in's bias (and Phi's q/k/v biases)
  shard with the output channels;
- out_proj/fc_out: row-parallel, one all-reduce per branch per layer, the
  biases added once after the sums (``models.gptj`` ``psum_axis``);
- int8 KV cache sharded over the head dim; wte, LayerNorms and lm_head
  replicated.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.gptj import GPTJConfig, gptj_forward
from .llama_tp import _REP, _map, _proj_spec, _shard_family, local_config
from .mesh import axis_group, axis_size

__all__ = ["gptj_param_specs", "shard_gptj_params", "gptj_forward_tp"]

_COL = ("q_proj", "k_proj", "v_proj", "fc_in")
_ROW = ("out_proj", "fc_out")


def gptj_param_specs(params: Dict, cfg: GPTJConfig, axis: str = "model") -> Dict:
    # top-level entries (wte, ln_f, lm_head) replicate leaf by leaf
    specs = {k: _map(lambda _: _REP, v) for k, v in params.items() if k != "layers"}
    specs["layers"] = []
    for layer in params["layers"]:
        ls = {}
        for name, w in layer.items():
            if name in _COL or name in _ROW:
                ls[name] = _proj_spec(name, w, axis, col=_COL, row=_ROW)
            elif name in ("fc_in_b", "q_bias", "k_bias", "v_bias"):
                # with the column-parallel output channels; out_bias and
                # fc_out_b stay replicated (added once, after the sums)
                ls[name] = (axis,)
            else:
                ls[name] = _REP
        specs["layers"].append(ls)
    return specs


def shard_gptj_params(params: Dict, cfg: GPTJConfig, mesh, axis: str = "model") -> Dict:
    """This rank's local params (row weights retiled, leaves cut by
    ``gptj_param_specs``)."""
    return _shard_family(params, gptj_param_specs, cfg, mesh, axis, _ROW)


def gptj_forward_tp(
    params: Dict,
    cfg: GPTJConfig,
    tokens: torch.Tensor,
    cache: Optional[Dict],
    positions: torch.Tensor,
    mesh,
    axis: str = "model",
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """TP forward of this rank: local params (``shard_gptj_params``), the
    rank's head shard of the cache (``llama_tp.kv_cache_specs``). Returns
    the replicated logits and the rank's updated cache."""
    tp = axis_size(mesh, axis)
    if cfg.num_heads % tp:
        raise ValueError(f"TP={tp} must divide num_heads({cfg.num_heads})")
    return gptj_forward(params, local_config(cfg, tp), tokens, cache, positions,
                        psum_axis=axis_group(mesh, axis))
