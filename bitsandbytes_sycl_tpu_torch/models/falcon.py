"""Falcon family (Falcon-7B/40B/180B) on the GPT-J substrate: multi-query
or grouped-query attention (``kv_heads``), half-split rotary over the whole
head, no biases; Falcon-40B's two LayerNorms are the substrate's ``ln2``.
Falcon-7B's head_dim of 64 is not a multiple of 128, so its cached
attention takes the dequantize-then-attend routes, as in the JAX package."""

from __future__ import annotations

import torch

from .gptj import GPTJConfig
from .gptj import gptj_forward as falcon_forward

__all__ = ["FalconConfig", "falcon_forward", "load_falcon_from_hf"]


class FalconConfig(GPTJConfig):
    """GPTJConfig with Falcon-7B defaults (32L/4544h/71H, one kv head,
    NeoX rotary over the head, bias-free, one shared LayerNorm)."""

    def __init__(self, **kw):
        defaults = dict(
            vocab_size=65024, hidden_size=4544, num_layers=32,
            num_heads=71, kv_heads=1, rotary_dim=64, max_seq_len=2048,
            rope_style="neox", attn_bias=False, act="gelu",
        )
        defaults.update(kw)
        super().__init__(**defaults)

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
                 kv_heads=1, rotary_dim=64, max_seq_len=128)
        d.update(kw)
        return cls(**d)


def load_falcon_from_hf(model_dir: str, cfg=None, quant: str = "nf4", device=None):
    """A HuggingFace Falcon checkpoint directory (FalconForCausalLM names)
    -> (cfg, params) on the GPT-J substrate, quantized on ``device``; the
    fused ``query_key_value`` is split for all three layouts: the new
    decoder architecture's kv groups of [q * (H / Hkv) | k | v], multi-query
    [q * H | k | v], and per-head [q | k | v]. Falcon ties lm_head to the
    embedding unless the checkpoint ships one."""
    from ..checkpoints import _getter, _read_config, _read_hf_tensors
    from ..ops.common import resolve_device
    from .llama import _quantize_linear

    dev = resolve_device(device)
    hf = _read_config(model_dir)
    built = _config_from_hf(hf, quant)  # refuses the variants the substrate cannot run
    cfg = built if cfg is None else cfg
    new_arch = hf.get("new_decoder_architecture", False)
    H, Hkv = built.num_heads, built.num_kv_heads
    hd = hf["hidden_size"] // H
    tensors = _read_hf_tensors(model_dir)
    get = _getter(tensors, dev)

    def q(name):
        return _quantize_linear(get(name), cfg)

    h = cfg.hidden_size
    layers = []
    for li in range(cfg.num_layers):
        pre = f"transformer.h.{li}."
        qkv = get(pre + "self_attention.query_key_value.weight")
        if new_arch:
            g = H // Hkv
            w = qkv.reshape(Hkv, g + 2, hd, h)
            qw = w[:, :g].reshape(H * hd, h)
            kw = w[:, g].reshape(Hkv * hd, h)
            vw = w[:, g + 1].reshape(Hkv * hd, h)
        elif Hkv == 1:
            qw, kw, vw = qkv[: H * hd], qkv[H * hd: H * hd + hd], qkv[H * hd + hd:]
        else:
            w = qkv.reshape(H, 3, hd, h)
            qw, kw, vw = (w[:, j].reshape(H * hd, h) for j in range(3))
        ffn = tensors[pre + "mlp.dense_h_to_4h.weight"].shape[0]
        layer = {
            "q_proj": _quantize_linear(qw.contiguous(), cfg),
            "k_proj": _quantize_linear(kw.contiguous(), cfg),
            "v_proj": _quantize_linear(vw.contiguous(), cfg),
            "out_proj": q(pre + "self_attention.dense.weight"),
            "fc_in": q(pre + "mlp.dense_h_to_4h.weight"),
            "fc_in_b": torch.zeros((ffn,), dtype=torch.float32, device=dev),
            "fc_out": q(pre + "mlp.dense_4h_to_h.weight"),
            "fc_out_b": torch.zeros((h,), dtype=torch.float32, device=dev),
        }
        del qkv, qw, kw, vw
        if new_arch:
            layer["ln_w"] = get(pre + "ln_attn.weight")
            layer["ln_b"] = get(pre + "ln_attn.bias")
            layer["ln2_w"] = get(pre + "ln_mlp.weight")
            layer["ln2_b"] = get(pre + "ln_mlp.bias")
        else:
            layer["ln_w"] = get(pre + "input_layernorm.weight")
            layer["ln_b"] = get(pre + "input_layernorm.bias")
        layers.append(layer)
    wte = get("transformer.word_embeddings.weight")
    head = get("lm_head.weight") if "lm_head.weight" in tensors else wte
    params = {
        "wte": wte.to(cfg.dtype),
        "layers": layers,
        "ln_f_w": get("transformer.ln_f.weight"),
        "ln_f_b": get("transformer.ln_f.bias"),
        "lm_head": _quantize_linear(head, cfg),
        "lm_head_b": torch.zeros((cfg.vocab_size,), dtype=torch.float32, device=dev),
    }
    return cfg, params


def _config_from_hf(hf: dict, quant: str = "nf4") -> FalconConfig:
    """A HuggingFace Falcon config.json dict -> the FalconConfig of the JAX
    package's loader, refusing the variants it refuses. The kv heads: the
    new decoder architecture's ``num_kv_heads``, 1 for multi-query, else
    one per head."""
    if hf.get("alibi", False):
        raise NotImplementedError("alibi Falcon checkpoints (falcon-rw) are not supported")
    if not hf.get("parallel_attn", True):
        raise NotImplementedError("sequential-residual Falcon checkpoints are not supported")
    if hf.get("bias", False):
        raise NotImplementedError("bias=true Falcon checkpoints are not supported")
    H = hf["num_attention_heads"]
    if hf.get("new_decoder_architecture", False):
        Hkv = hf.get("num_kv_heads", H)
    elif hf.get("multi_query", True):
        Hkv = 1
    else:
        Hkv = H
    return FalconConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=H,
        kv_heads=Hkv,
        rotary_dim=hf["hidden_size"] // H,
        max_seq_len=min(hf.get("max_position_embeddings", 2048), 4096),
        ln_eps=hf.get("layer_norm_epsilon", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        quant=quant,
    )
