"""GPT-J family decoder with quantized weights, in PyTorch: the substrate
of GPT-J, Phi, GPT-NeoX and Falcon.

A parallel block: attention and the MLP both read one LayerNorm of the
layer input (GPT-NeoX and Falcon-40B's MLP its own second LayerNorm, when
a layer holds ``ln2_w``), and both add to the residual. Rotary embeddings
on the first ``rotary_dim`` dims, interleaved pairs (2i, 2i + 1) for GPT-J
(``rope_style="gptj"``) or halves for NeoX, Phi and Falcon (``"neox"``);
biases on the MLP and the head, and with ``attn_bias`` on q/k/v and the
attention output (Phi, NeoX); ``kv_heads`` < ``num_heads`` gives Falcon's
multi-query attention. The quantized linears, the KV caches, kernels C, D
and H and the dequantize-then-attend routes are Llama's
(``models/llama.py``), which read this config through its ``hd`` and
``num_kv_heads`` shims.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as Fnn

from ..ops.common import resolve_device
from .llama import (_attention, _lora_for, _quantize_linear, _rope, apply_linear, init_kv_cache,
                    write_and_attend)

__all__ = ["GPTJConfig", "init_gptj_params", "gptj_forward", "init_gptj_kv_cache"]


@dataclasses.dataclass(frozen=True)
class GPTJConfig:
    """The JAX package's GPTJConfig, field for field (GPT-J-6B defaults)."""

    vocab_size: int = 50400
    hidden_size: int = 4096
    num_layers: int = 28
    num_heads: int = 16
    head_dim: Optional[int] = None
    rotary_dim: int = 64
    max_seq_len: int = 2048
    ln_eps: float = 1e-5
    rope_style: str = "gptj"  # "gptj": interleaved pairs; "neox": halves
    rope_theta: float = 10000.0
    act: str = "gelu_tanh"  # or "gelu" (exact erf, GPT-NeoX)
    attn_bias: bool = False
    kv_heads: Optional[int] = None  # None: num_heads
    dtype: Any = torch.bfloat16
    quant: str = "nf4"
    blocksize: int = 64
    compress_stats: bool = False
    a8_decode: bool = True
    absmax_dtype: str = "bfloat16"
    llm_int8_threshold: float = 6.0
    kv_quant: bool = True
    kv_bits: int = 8
    pages_hint: Optional[int] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.kv_heads or self.num_heads

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=2,
                 rotary_dim=32, max_seq_len=128)
        d.update(kw)
        return cls(**d)


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in f32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def _rope_interleaved(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int,
                      theta: float = 10000.0) -> torch.Tensor:
    """GPT-J rotary: the pairs (0, 1), (2, 3), ... of the first
    ``rotary_dim`` dims rotate; the rest pass through."""
    B, T, H, _ = x.shape
    r = rotary_dim
    xr, xp = x[..., :r].float(), x[..., r:]
    freqs = 1.0 / (theta ** (torch.arange(0, r, 2, dtype=torch.float32, device=x.device) / r))
    ang = positions.float()[:, :, None] * freqs[None, None, :]  # (B, T, r/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    ro = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(B, T, H, r)
    return torch.cat([ro.to(x.dtype), xp], dim=-1)


def _rope_neox_partial(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int,
                       theta: float = 10000.0) -> torch.Tensor:
    """NeoX/Phi rotary: Llama's half-split rotation of the first
    ``rotary_dim`` dims; the rest pass through."""
    return torch.cat([_rope(x[..., :rotary_dim], positions, theta), x[..., rotary_dim:]], dim=-1)


def init_gptj_kv_cache(cfg: GPTJConfig, batch: int, device=None) -> Dict:
    """Llama's cache layout (K transposed), on CUDA unless ``device`` says
    otherwise."""
    return init_kv_cache(cfg, batch, device)


@torch.no_grad()
def init_gptj_params(cfg: GPTJConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from a seeded torch.Generator on ``device`` (CUDA
    unless given another), scaled as the JAX package's init_gptj_params
    (1/sqrt(K); wte and lm_head 0.02), quantized one weight at a time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def dense(shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[1]))
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    def vec(n, fill):
        return torch.full((n,), fill, dtype=torch.float32, device=dev)

    h, ff = cfg.hidden_size, 4 * cfg.hidden_size
    qdim, kvdim = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "ln_w": vec(h, 1.0),
            "ln_b": vec(h, 0.0),
            "q_proj": _quantize_linear(dense((qdim, h)), cfg),
            "k_proj": _quantize_linear(dense((kvdim, h)), cfg),
            "v_proj": _quantize_linear(dense((kvdim, h)), cfg),
            "out_proj": _quantize_linear(dense((h, qdim)), cfg),
            "fc_in": _quantize_linear(dense((ff, h)), cfg),
            "fc_in_b": vec(ff, 0.0),
            "fc_out": _quantize_linear(dense((h, ff)), cfg),
            "fc_out_b": vec(h, 0.0),
        }
        if cfg.attn_bias:  # Phi's biased q/k/v and dense
            for name, n in (("q_bias", qdim), ("k_bias", kvdim), ("v_bias", kvdim),
                            ("out_bias", h)):
                layer[name] = dense((n,), 0.02)
        layers.append(layer)
    return {
        "wte": dense((cfg.vocab_size, h), 0.02).to(cfg.dtype),
        "layers": layers,
        "ln_f_w": vec(h, 1.0),
        "ln_f_b": vec(h, 0.0),
        "lm_head": _quantize_linear(dense((cfg.vocab_size, h), 0.02), cfg),
        "lm_head_b": vec(cfg.vocab_size, 0.0),
    }


def gptj_forward(
    params: Dict,
    cfg: GPTJConfig,
    tokens: torch.Tensor,  # (B, T)
    cache: Optional[Dict] = None,
    positions: Optional[torch.Tensor] = None,
    seq_lens: Optional[torch.Tensor] = None,  # unused, as in the JAX package
    psum_axis=None,
    lora: Optional[list] = None,
    lora_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """llama_forward's contract: (logits (B, T, vocab) f32, cache), the
    cache updated in place. Adapters target q/k/v/out_proj, fc_in and
    fc_out by key name. ``psum_axis``: the process group of the
    tensor-parallel dim (``parallel.gptj_forward_tp``); the row-parallel
    out_proj and fc_out partial sums are all-reduced, one each per layer,
    and their biases added once, after the sums."""
    if psum_axis is not None:
        from ..parallel.mesh import psum
    B, T = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(T, device=dev).expand(B, T)
    ids_bt = None if lora_ids is None else lora_ids.reshape(B, 1).expand(B, T)
    x = params["wte"][tokens.long()].to(cfg.dtype)
    mask = None
    if cache is None:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))[None].expand(B, T, T)
    rope = _rope_neox_partial if getattr(cfg, "rope_style", "gptj") == "neox" else _rope_interleaved
    exact_gelu = getattr(cfg, "act", "gelu_tanh") != "gelu_tanh"
    for li, layer in enumerate(params["layers"]):
        h = _ln(x, layer["ln_w"], layer["ln_b"], cfg.ln_eps)
        # GPT-NeoX (and Falcon-40B): the MLP reads its own LayerNorm
        h_mlp = _ln(x, layer["ln2_w"], layer["ln2_b"], cfg.ln_eps) if "ln2_w" in layer else h
        q = apply_linear(h, layer["q_proj"], cfg, _lora_for(lora, li, "q_proj"), ids_bt)
        k = apply_linear(h, layer["k_proj"], cfg, _lora_for(lora, li, "k_proj"), ids_bt)
        v = apply_linear(h, layer["v_proj"], cfg, _lora_for(lora, li, "v_proj"), ids_bt)
        if "q_bias" in layer:
            q = q + layer["q_bias"].to(q.dtype)
            k = k + layer["k_bias"].to(k.dtype)
            v = v + layer["v_bias"].to(v.dtype)
        q = rope(q.reshape(B, T, cfg.num_heads, cfg.hd), positions, cfg.rotary_dim, cfg.rope_theta)
        k = rope(k.reshape(B, T, cfg.num_kv_heads, cfg.hd), positions, cfg.rotary_dim,
                 cfg.rope_theta)
        v = v.reshape(B, T, cfg.num_kv_heads, cfg.hd)
        if cache is not None:
            attn, cache = write_and_attend(cache, li, q, k, v, positions, cfg)
        else:
            attn = _attention(q, k, v, mask, cfg.dtype)
        attn = attn.to(cfg.dtype).reshape(B, T, -1)
        attn_out = apply_linear(attn, layer["out_proj"], cfg, _lora_for(lora, li, "out_proj"),
                                ids_bt)
        ff = apply_linear(h_mlp, layer["fc_in"], cfg, _lora_for(lora, li, "fc_in"), ids_bt) \
            + layer["fc_in_b"].to(cfg.dtype)
        ff = Fnn.gelu(ff.float(), approximate="none" if exact_gelu else "tanh").to(cfg.dtype)
        ff = apply_linear(ff, layer["fc_out"], cfg, _lora_for(lora, li, "fc_out"), ids_bt)
        if psum_axis is not None:  # row-parallel partial sums; the biases go in after
            attn_out = psum(attn_out, psum_axis)
            ff = psum(ff, psum_axis)
        if "out_bias" in layer:
            attn_out = attn_out + layer["out_bias"].to(cfg.dtype)
        ff = ff + layer["fc_out_b"].to(cfg.dtype)
        x = x + attn_out + ff
    x = _ln(x, params["ln_f_w"], params["ln_f_b"], cfg.ln_eps)
    logits = apply_linear(x, params["lm_head"], cfg).float() + params["lm_head_b"].float()
    return logits, cache
