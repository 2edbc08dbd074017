"""OPT family decoder with quantized weights, in PyTorch: the substrate of
OPT, GPT-2 and BLOOM.

A sequential pre-LN block (x += attn(LN1(x)); x += mlp(LN2(x))) with
LayerNorm, biases on every projection, a 2-layer MLP (ReLU for OPT, GELU
for GPT-2 and BLOOM) and learned absolute positions at ``pos_offset``
(OPT's 2, GPT-2's 0), or with ``alibi`` (BLOOM) no position table, a
LayerNorm on the embeddings and the ALiBi bias in attention: per-head
slopes to kernels C, D and H, a bias in the ``_attention`` routes.
OPT-350M's narrower embeddings come with ``project_in``/``project_out``.
The quantized linears, the caches and the attention routes are Llama's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as Fnn

from ..ops.common import resolve_device
from .gptj import GPTJConfig, _ln
from .llama import (_alibi_bias, _attention, _lora_for, _quantize_linear, apply_linear,
                    init_kv_cache, write_and_attend)

__all__ = ["OPTConfig", "init_opt_params", "opt_forward", "init_opt_kv_cache",
           "load_opt_from_hf"]


@dataclasses.dataclass(frozen=True)
class OPTConfig(GPTJConfig):
    """GPTJConfig's fields (the rotary ones unused) and OPT's own, field
    for field the JAX package's; OPT-6.7B defaults. ``alibi_total_heads``
    and ``alibi_axis`` (the tensor-parallel dim's process group) are set by
    ``parallel.opt_forward_tp`` alone."""

    act: str = "relu"
    ffn_dim: Optional[int] = None  # None: 4 * hidden_size
    word_embed_proj_dim: Optional[int] = None  # OPT-350M
    pos_offset: int = 2  # OPT's learned-position offset; GPT-2 uses 0
    alibi: bool = False  # BLOOM: ALiBi in place of position embeddings
    alibi_total_heads: Optional[int] = None
    alibi_axis: Optional[Any] = None

    @property
    def ffn(self) -> int:
        return self.ffn_dim or 4 * self.hidden_size

    @property
    def embed_dim(self) -> int:
        return self.word_embed_proj_dim or self.hidden_size

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
                 max_seq_len=128, ffn_dim=512)
        d.update(kw)
        return cls(**d)


@torch.no_grad()
def init_opt_params(cfg: OPTConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from a seeded torch.Generator on ``device`` (CUDA
    unless given another), scaled as the JAX package's init_opt_params;
    a learned position table of max_seq_len + pos_offset rows, or with
    ALiBi the embedding LayerNorm."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def dense(shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[1]))
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    def vec(n, fill):
        return torch.full((n,), fill, dtype=torch.float32, device=dev)

    h, ff, w = cfg.hidden_size, cfg.ffn, cfg.embed_dim
    qd, kvd = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "ln1_w": vec(h, 1.0), "ln1_b": vec(h, 0.0),
            "q_proj": _quantize_linear(dense((qd, h)), cfg), "q_bias": vec(qd, 0.0),
            "k_proj": _quantize_linear(dense((kvd, h)), cfg), "k_bias": vec(kvd, 0.0),
            "v_proj": _quantize_linear(dense((kvd, h)), cfg), "v_bias": vec(kvd, 0.0),
            "out_proj": _quantize_linear(dense((h, qd)), cfg), "out_bias": vec(h, 0.0),
            "ln2_w": vec(h, 1.0), "ln2_b": vec(h, 0.0),
            "fc1": _quantize_linear(dense((ff, h)), cfg), "fc1_b": vec(ff, 0.0),
            "fc2": _quantize_linear(dense((h, ff)), cfg), "fc2_b": vec(h, 0.0),
        })
    params = {
        "wte": dense((cfg.vocab_size, w), 0.02).to(cfg.dtype),
        "layers": layers,
        "ln_f_w": vec(h, 1.0),
        "ln_f_b": vec(h, 0.0),
        "lm_head": _quantize_linear(dense((cfg.vocab_size, w), 0.02), cfg),
    }
    if not cfg.alibi:
        params["wpe"] = dense((cfg.max_seq_len + cfg.pos_offset, h), 0.02).to(cfg.dtype)
    else:
        params["wln_w"], params["wln_b"] = vec(h, 1.0), vec(h, 0.0)  # BLOOM's embedding LN
    if w != h:
        params["project_in"] = _quantize_linear(dense((h, w)), cfg)
        params["project_out"] = _quantize_linear(dense((w, h)), cfg)
    return params


def opt_forward(
    params: Dict,
    cfg: OPTConfig,
    tokens: torch.Tensor,  # (B, T)
    cache: Optional[Dict] = None,
    positions: Optional[torch.Tensor] = None,
    seq_lens: Optional[torch.Tensor] = None,  # unused, as in the JAX package
    psum_axis=None,
    lora: Optional[list] = None,
    lora_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """llama_forward's contract: (logits (B, T, vocab) f32, cache), the
    cache updated in place. Adapters target q/k/v/out_proj, fc1 and fc2 by
    key name. ``psum_axis``: the process group of the tensor-parallel dim
    (``parallel.opt_forward_tp``); the row-parallel out_proj and fc2
    partial sums are all-reduced, one each per layer, and out_bias and
    fc2_b added once, after the sums."""
    if psum_axis is not None:
        from ..parallel.mesh import psum
    B, T = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(T, device=dev).expand(B, T)
    ids_bt = None if lora_ids is None else lora_ids.reshape(B, 1).expand(B, T)
    x = params["wte"][tokens.long()].to(cfg.dtype)
    if "wln_w" in params:  # BLOOM: LayerNorm straight after the embedding
        x = _ln(x, params["wln_w"], params["wln_b"], cfg.ln_eps)
    if "project_in" in params:
        x = apply_linear(x, params["project_in"], cfg)
    if "wpe" in params:
        x = x + params["wpe"][positions.long() + cfg.pos_offset].to(cfg.dtype)
    mask = bias = None
    if cache is None:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))[None].expand(B, T, T)
        if cfg.alibi:
            bias = _alibi_bias(cfg, positions, T)
    act = getattr(cfg, "act", "relu")
    for li, layer in enumerate(params["layers"]):
        h = _ln(x, layer["ln1_w"], layer["ln1_b"], cfg.ln_eps)
        q = apply_linear(h, layer["q_proj"], cfg, _lora_for(lora, li, "q_proj"), ids_bt) \
            + layer["q_bias"].to(cfg.dtype)
        k = apply_linear(h, layer["k_proj"], cfg, _lora_for(lora, li, "k_proj"), ids_bt) \
            + layer["k_bias"].to(cfg.dtype)
        v = apply_linear(h, layer["v_proj"], cfg, _lora_for(lora, li, "v_proj"), ids_bt) \
            + layer["v_bias"].to(cfg.dtype)
        q = q.reshape(B, T, cfg.num_heads, cfg.hd)
        k = k.reshape(B, T, cfg.num_kv_heads, cfg.hd)
        v = v.reshape(B, T, cfg.num_kv_heads, cfg.hd)
        if cache is not None:
            attn, cache = write_and_attend(cache, li, q, k, v, positions, cfg)
        else:
            attn = _attention(q, k, v, mask, cfg.dtype, bias=bias)
        attn = attn.to(cfg.dtype).reshape(B, T, -1)
        attn_out = apply_linear(attn, layer["out_proj"], cfg, _lora_for(lora, li, "out_proj"),
                                ids_bt)
        if psum_axis is not None:
            attn_out = psum(attn_out, psum_axis)
        x = x + attn_out + layer["out_bias"].to(cfg.dtype)
        h = _ln(x, layer["ln2_w"], layer["ln2_b"], cfg.ln_eps)
        ff = apply_linear(h, layer["fc1"], cfg, _lora_for(lora, li, "fc1"), ids_bt) \
            + layer["fc1_b"].to(cfg.dtype)
        if act == "relu":
            ff = torch.relu(ff)
        else:
            ff = Fnn.gelu(ff.float(), approximate="tanh" if act == "gelu_tanh" else "none"
                          ).to(cfg.dtype)
        ff = apply_linear(ff, layer["fc2"], cfg, _lora_for(lora, li, "fc2"), ids_bt)
        if psum_axis is not None:
            ff = psum(ff, psum_axis)
        x = x + ff + layer["fc2_b"].to(cfg.dtype)
    x = _ln(x, params["ln_f_w"], params["ln_f_b"], cfg.ln_eps)
    if "project_out" in params:
        x = apply_linear(x, params["project_out"], cfg)
    logits = apply_linear(x, params["lm_head"], cfg).float()
    return logits, cache


def init_opt_kv_cache(cfg: OPTConfig, batch: int, device=None) -> Dict:
    """Llama's cache layout, on CUDA unless ``device`` says otherwise."""
    return init_kv_cache(cfg, batch, device)


def load_opt_from_hf(model_dir: str, cfg=None, quant: str = "nf4", device=None):
    """A HuggingFace OPT checkpoint directory (OPTForCausalLM names,
    ``model.decoder.*``) -> (cfg, params), quantized on ``device``.
    Pre-LayerNorm checkpoints only (every mainline size); the positions
    table keeps HF's +2 offset rows; lm_head is tied to the embedding
    unless the checkpoint ships one; OPT-350M's project_in/out load where
    ``word_embed_proj_dim`` differs from the hidden size."""
    from ..checkpoints import _getter, _read_config, _read_hf_tensors

    dev = resolve_device(device)
    built = _config_from_hf(_read_config(model_dir), quant)  # refuses unsupported variants
    cfg = built if cfg is None else cfg
    tensors = _read_hf_tensors(model_dir)
    pfx = "model.decoder." if any(k.startswith("model.decoder.") for k in tensors) else "decoder."
    get_any = _getter(tensors, dev)

    def get(name):
        return get_any(pfx + name)

    def q(name):
        return _quantize_linear(get(name), cfg)

    layers = []
    for li in range(cfg.num_layers):
        pre = f"layers.{li}."
        layers.append({
            "ln1_w": get(pre + "self_attn_layer_norm.weight"),
            "ln1_b": get(pre + "self_attn_layer_norm.bias"),
            "q_proj": q(pre + "self_attn.q_proj.weight"),
            "q_bias": get(pre + "self_attn.q_proj.bias"),
            "k_proj": q(pre + "self_attn.k_proj.weight"),
            "k_bias": get(pre + "self_attn.k_proj.bias"),
            "v_proj": q(pre + "self_attn.v_proj.weight"),
            "v_bias": get(pre + "self_attn.v_proj.bias"),
            "out_proj": q(pre + "self_attn.out_proj.weight"),
            "out_bias": get(pre + "self_attn.out_proj.bias"),
            "ln2_w": get(pre + "final_layer_norm.weight"),
            "ln2_b": get(pre + "final_layer_norm.bias"),
            "fc1": q(pre + "fc1.weight"),
            "fc1_b": get(pre + "fc1.bias"),
            "fc2": q(pre + "fc2.weight"),
            "fc2_b": get(pre + "fc2.bias"),
        })
    wte = get("embed_tokens.weight")
    head = get_any("lm_head.weight") if "lm_head.weight" in tensors else wte
    params = {
        "wte": wte.to(cfg.dtype),
        "wpe": get("embed_positions.weight").to(cfg.dtype),
        "layers": layers,
        "ln_f_w": get("final_layer_norm.weight"),
        "ln_f_b": get("final_layer_norm.bias"),
        "lm_head": _quantize_linear(head, cfg),
    }
    if cfg.word_embed_proj_dim and cfg.word_embed_proj_dim != cfg.hidden_size:
        params["project_in"] = q("project_in.weight")
        params["project_out"] = q("project_out.weight")
    return cfg, params


def _config_from_hf(hf: dict, quant: str = "nf4") -> OPTConfig:
    """A HuggingFace OPT config.json dict -> the OPTConfig of the JAX
    package's loader, refusing the variants it refuses."""
    if not hf.get("do_layer_norm_before", True):
        raise NotImplementedError("post-LayerNorm OPT checkpoints (do_layer_norm_before=False) "
                                  "are not supported")
    hf_act = hf.get("activation_function", "relu")
    if hf_act != "relu":
        raise NotImplementedError(f"OPT activation_function={hf_act!r} is not supported "
                                  "(the substrate uses relu for OPT)")
    if not hf.get("enable_bias", True):
        raise NotImplementedError("enable_bias=false OPT checkpoints are not supported")
    if not hf.get("layer_norm_elementwise_affine", True):
        raise NotImplementedError("layer_norm_elementwise_affine=false OPT checkpoints are not "
                                  "supported")
    return OPTConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        ffn_dim=hf.get("ffn_dim", 4 * hf["hidden_size"]),
        word_embed_proj_dim=hf.get("word_embed_proj_dim", hf["hidden_size"]),
        max_seq_len=min(hf.get("max_position_embeddings", 2048), 4096),
        ln_eps=1e-5,
        quant=quant,
    )
