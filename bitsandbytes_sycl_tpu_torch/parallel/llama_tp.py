"""Tensor-parallel quantized Llama forward over a "model" mesh dim, the JAX
package's ``parallel/llama_tp.py`` on ``torch.distributed``.

Megatron-style TP with the quantized weights sharded congruently with
their scales:

- q/k/v/gate/up: column-parallel (output heads / ffn channels sharded);
- o/down: row-parallel (input sharded), the partial sums all-reduced once
  per projection (``models.llama.llama_forward(psum_axis=...)``);
- int8 KV cache and page pool: sharded over the kv-head dim, so attention
  is local; the page table and write slots are replicated;
- embed / norms / lm_head: replicated (the logits are the same bits on
  every rank);
- Mixtral's stacked experts: sharded on their leading (expert) dim, each
  expert whole (expert parallelism); the router is replicated.

Each rank holds its local tree (``shard_llama_params``), with every
``QLinearWeight``'s shape rebuilt from its local leaves, and runs
``llama_forward`` under its local config (``local_config``). Specs are the
JAX ``PartitionSpec``s as plain data: a tuple of mesh-dim names (None: not
split), one per leading dim of the leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.llama import LlamaConfig, llama_forward
from ..ops.common import QLinearWeight
from .mesh import (_local_qw, axis_group, axis_size, qweight_pspec, retile_qweight_row_tp,
                   shard_tensor)

__all__ = [
    "llama_param_specs", "shard_llama_params", "kv_cache_specs",
    "llama_forward_tp", "lora_param_specs", "shard_lora_params", "local_config",
]

# projection -> TP sharding direction
_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("o_proj", "down_proj")
_REP = ()  # replicated


def _map(fn, tree):
    """fn over every tensor leaf of a tree of dicts, lists and
    QLinearWeights (a QLinearWeight's None sidecars stay None)."""
    if isinstance(tree, QLinearWeight):
        return dataclasses.replace(tree, **{
            k: fn(getattr(tree, k)) for k in ("packed", "absmax", "absmax_scale",
                                              "absmax_offset") if getattr(tree, k) is not None})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _proj_spec(name: str, w, axis: str, col=_COL, row=_ROW):
    """Sharding spec of one projection, shared by every decoder family
    (gptj_tp and opt_tp pass their own col/row name sets)."""
    if isinstance(w, QLinearWeight):
        if name in col:
            return qweight_pspec(w, "col", axis)
        if name in row:
            return qweight_pspec(w, "row", axis)
        return _map(lambda _: _REP, w)
    if isinstance(w, dict) and "CB" in w:
        if name in col:
            spec = {"CB": (axis, None), "SCB": (axis,)}
            if "outliers" in w:
                # sidecar: x replicated under col-parallel; subB (budget, N)
                # shards on N with the weight rows
                spec["outliers"] = {"idx": _REP, "keep": _REP, "subB": (None, axis)}
            return spec
        if name in row:
            # per-output-row scales stay replicated when K is sharded
            # (outliers were dropped by _prep_row_weight for row weights)
            return {"CB": (None, axis), "SCB": _REP}
        return _map(lambda _: _REP, w)
    # unquantized weight (N, K)
    if name in col:
        return (axis, None)
    if name in row:
        return (None, axis)
    return _REP


def _prep_row_weight(name: str, w, row, tp: int):
    """Row-parallel preparation shared across families: planar 4-bit
    weights need contiguous-K retiling; the static outlier sidecars
    (global-K indices) of int8 weights are dropped."""
    if name in row and isinstance(w, QLinearWeight) and tp > 1:
        return retile_qweight_row_tp(w, tp)
    if name in row and isinstance(w, dict) and "outliers" in w:
        return {k: v for k, v in w.items() if k != "outliers"}
    return w


def _shard_tree(tree, specs, mesh, axis: str):
    """This rank's local tree: each tensor leaf cut by its spec along the
    mesh dim ``axis``; QLinearWeights get their shape from the local
    leaves."""
    if isinstance(tree, QLinearWeight):
        leaves = {k: shard_tensor(getattr(tree, k), getattr(specs, k), mesh, axis)
                  for k in ("packed", "absmax", "absmax_scale", "absmax_offset")
                  if getattr(tree, k) is not None}
        return _local_qw(tree, **leaves)
    if isinstance(tree, dict):
        return {k: _shard_tree(v, specs[k], mesh, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shard_tree(v, s, mesh, axis) for v, s in zip(tree, specs)]
    if isinstance(tree, torch.Tensor):
        return shard_tensor(tree, specs, mesh, axis)
    return tree


def llama_param_specs(params: Dict, cfg: LlamaConfig, axis: str = "model") -> Dict:
    """The spec tree matching the param tree."""
    specs = {"embed": _REP, "final_norm": _REP, "layers": []}
    for layer in params["layers"]:
        ls = {}
        for name, w in layer.items():
            if name == "experts":
                # expert parallelism: the stacked expert weights shard on
                # their leading (expert) dim; each expert stays whole
                ls[name] = _map(lambda _: (axis,), w)
            elif name.endswith("_proj"):
                ls[name] = _proj_spec(name, w, axis)
            elif name in ("q_bias", "k_bias", "v_bias"):
                # qkv biases shard with their column-parallel projections
                ls[name] = (axis,)
            else:
                ls[name] = _REP  # norms and the MoE router stay replicated
        specs["layers"].append(ls)
    if "lm_head" in params:
        specs["lm_head"] = _map(lambda _: _REP, params["lm_head"])
    return specs


def _shard_family(params: Dict, specs_fn, cfg, mesh, axis: str, row) -> Dict:
    tp = axis_size(mesh, axis)
    params = dict(params)
    params["layers"] = [
        {name: _prep_row_weight(name, w, row, tp) for name, w in layer.items()}
        for layer in params["layers"]
    ]
    return _shard_tree(params, specs_fn(params, cfg, axis), mesh, axis)


def shard_llama_params(params: Dict, cfg: LlamaConfig, mesh, axis: str = "model") -> Dict:
    """This rank's local params: row weights retiled, then every leaf cut
    by ``llama_param_specs``. Every rank calls it on the same whole tree."""
    return _shard_family(params, llama_param_specs, cfg, mesh, axis, _ROW)


def lora_param_specs(lora, axis: str = "model", col=_COL, row=_ROW):
    """Specs of a (possibly stacked) adapter list, congruent with the base
    projections so that the deltas ride the TP math: column-parallel
    targets shard B on the output dim (the delta is local to the shard);
    row-parallel targets shard A on the input dim (the partial x @ A^T
    sums through the layer's all-reduce: psum(B @ xa_partial) = B @
    sum(xa)). A leading adapter-stack dim (stack_lora) is never split."""
    def spec_for(name, ab):
        nd = ab["A"].dim()  # 2: one adapter, 3: stacked
        if name in col:
            a_spec, b_spec = _REP, ((axis, None) if nd == 2 else (None, axis, None))
        elif name in row:
            a_spec, b_spec = ((None, axis) if nd == 2 else (None, None, axis)), _REP
        else:
            a_spec = b_spec = _REP
        return {"A": a_spec, "B": b_spec, "scale": _REP}

    return [{name: spec_for(name, ab) for name, ab in layer.items()} for layer in lora]


def shard_lora_params(lora, mesh, axis: str = "model", col=_COL, row=_ROW):
    """This rank's adapters, congruent with the base weights
    (``lora_param_specs``)."""
    return _shard_tree(lora, lora_param_specs(lora, axis, col, row), mesh, axis)


def kv_cache_specs(cfg: LlamaConfig, axis: str = "model", paged: bool = False) -> Dict:
    """The cache (and page pool) sharded over the kv-head dim (dim 2 of
    every leaf); with ``paged``, the page table and write slots,
    replicated (every rank writes its head shard of the same page)."""
    specs = {"k": (None, None, axis), "v": (None, None, axis)}
    if cfg.kv_quant:
        specs.update(k_scale=(None, None, axis), v_scale=(None, None, axis))
    if paged:
        specs.update(page_table=_REP, write_page=_REP, write_off=_REP)
    return specs


def local_config(cfg, tp: int):
    """A rank's config under TP = tp: heads, kv heads and (Llama) the
    intermediate size divided by tp, head_dim pinned to the global one.
    GPT-J's and OPT's configs carry the kv-head count in ``kv_heads``."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    kw = dict(num_heads=cfg.num_heads // tp, head_dim=cfg.hd)
    if "num_kv_heads" in fields:
        kw["num_kv_heads"] = cfg.num_kv_heads // tp
    if "intermediate_size" in fields:
        kw["intermediate_size"] = cfg.intermediate_size // tp
    if "kv_heads" in fields and cfg.kv_heads is not None:
        kw["kv_heads"] = cfg.kv_heads // tp
    return dataclasses.replace(cfg, **kw)


def _check_divisible(cfg, tp: int) -> None:
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(
            f"TP={tp} must divide num_heads({cfg.num_heads}), "
            f"num_kv_heads({cfg.num_kv_heads}) and intermediate_size"
            f"({cfg.intermediate_size})"
        )
    if getattr(cfg, "num_experts", 1) > 1 and cfg.num_experts % tp:
        raise ValueError(f"EP={tp} must divide num_experts({cfg.num_experts})")


def llama_forward_tp(
    params: Dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    cache: Optional[Dict],
    positions: torch.Tensor,
    mesh,
    axis: str = "model",
    lora=None,
    lora_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """TP forward of this rank: ``params`` its local tree
    (``shard_llama_params``), ``cache`` its kv-head shard (a cache of
    ``local_config(cfg, tp)``; the paged pool's table and write slots
    whole), tokens and positions replicated; ``lora`` this rank's adapters
    (``shard_lora_params``). Returns the replicated logits (the same bits
    on every rank) and the rank's updated cache."""
    tp = axis_size(mesh, axis)
    _check_divisible(cfg, tp)
    return llama_forward(params, local_config(cfg, tp), tokens, cache, positions,
                         psum_axis=axis_group(mesh, axis), lora=lora, lora_ids=lora_ids)
