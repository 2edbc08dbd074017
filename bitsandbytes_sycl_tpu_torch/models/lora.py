"""QLoRA: low-rank adapters over frozen quantized weights, the port of the
JAX package's ``models/lora.py``.

The base model stays 4-bit (``QLinearWeight``s, no gradient); adapters are
a per-layer list of ``{proj_name: {"A" (r, in), "B" (out, r), "scale"}}``
threaded through ``llama_forward(lora=...)``. Every leaf, ``scale``
included, requires grad, as the JAX package differentiates the whole
adapter tree; ``lora_leaves`` lists them in the JAX package's tree order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.common import resolve_device
from .llama import LlamaConfig, _fp_layer_shapes, llama_forward

__all__ = ["init_lora", "qlora_loss_fn", "merge_lora", "stack_lora", "lora_leaves", "ALL_TARGETS"]

_DEFAULT_TARGETS = ("q_proj", "v_proj")
ALL_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def init_lora(
    cfg: LlamaConfig,
    seed: int = 0,
    rank: int = 8,
    alpha: float = 16.0,
    targets: Sequence[str] = _DEFAULT_TARGETS,
    device=None,
) -> List[Dict]:
    """Per-layer adapters on ``device`` (CUDA unless given another): A ~
    N(0, 1/r) from a seeded torch.Generator, B = 0, scale = alpha / r, so
    the delta starts at zero. Every leaf requires grad."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = _fp_layer_shapes(cfg)
    out = []
    for _ in range(cfg.num_layers):
        layer = {}
        for t in targets:
            n, kin = shapes[t]
            a = torch.randn((rank, kin), generator=gen, device=dev, dtype=torch.float32)
            layer[t] = {
                "A": (a / np.float32(np.sqrt(rank))).requires_grad_(),
                "B": torch.zeros((n, rank), dtype=torch.float32, device=dev, requires_grad=True),
                "scale": torch.tensor(alpha / rank, dtype=torch.float32, device=dev,
                                      requires_grad=True),
            }
        out.append(layer)
    return out


def lora_leaves(lora: List[Dict]) -> List[torch.Tensor]:
    """The adapter leaves in the JAX package's tree order (layers in order,
    dict keys sorted): the order an optimizer over them steps, and the
    order ``convert.optim_state_from_jax`` reads."""
    return [lora[li][t][k] for li in range(len(lora)) for t in sorted(lora[li])
            for k in sorted(lora[li][t])]


def qlora_loss_fn(params: Dict, cfg: LlamaConfig):
    """loss(lora, tokens): causal LM cross-entropy of the adapted model on
    tokens (B, T + 1), the quantized base frozen."""

    def loss(lora, tokens):
        logits, _ = llama_forward(params, cfg, tokens[:, :-1], lora=lora)
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
        return -ll.mean()

    return loss


def merge_lora(fp_params: Dict, lora: List[Dict]) -> Dict:
    """Fold adapters into full-precision weights: W' = W + scale * B @ A
    (the quantized tree is frozen storage)."""
    out = {k: v for k, v in fp_params.items() if k != "layers"}
    out["layers"] = []
    for layer, lr in zip(fp_params["layers"], lora):
        new = dict(layer)
        for t, ab in lr.items():
            new[t] = layer[t].float() + (ab["B"] @ ab["A"]) * ab["scale"]
        out["layers"].append(new)
    return out


def stack_lora(adapters: Sequence[List[Dict]]) -> List[Dict]:
    """Stack N adapter trees into the batched form llama_forward serves with
    per-sequence ``lora_ids``: A (n, r, K), B (n, N, r), scale (n,)."""
    n_layers = len(adapters[0])
    for a in adapters[1:]:
        if len(a) != n_layers or any(set(a[li]) != set(adapters[0][li]) for li in range(n_layers)):
            raise ValueError(
                "stack_lora needs identical layer counts and target sets across adapters "
                "(otherwise some deltas would be dropped)")
    return [
        {name: {k: torch.stack([a[li][name][k] for a in adapters])
                for k in ("A", "B", "scale")}
         for name in adapters[0][li]}
        for li in range(n_layers)
    ]
