"""GPT-NeoX family (Pythia, GPT-NeoX-20B) on the GPT-J substrate: the MLP
reads its own LayerNorm (layers hold ``ln2_w``/``ln2_b``), half-split
rotary on ``rotary_pct`` of the head dims, biased attention and exact-erf
GELU."""

from __future__ import annotations

import torch

from .gptj import GPTJConfig
from .gptj import gptj_forward as neox_forward

__all__ = ["NeoXConfig", "neox_forward", "load_neox_from_hf"]


class NeoXConfig(GPTJConfig):
    """GPTJConfig with Pythia-6.9B defaults (32L/4096h/32H, rotary 25%,
    NeoX rotary, biased attention, exact GELU)."""

    def __init__(self, **kw):
        defaults = dict(
            vocab_size=50432, hidden_size=4096, num_layers=32,
            num_heads=32, rotary_dim=32, max_seq_len=2048,
            rope_style="neox", attn_bias=True, act="gelu",
        )
        defaults.update(kw)
        super().__init__(**defaults)

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=2,
                 rotary_dim=32, max_seq_len=128)
        d.update(kw)
        return cls(**d)


def load_neox_from_hf(model_dir: str, cfg=None, quant: str = "nf4", device=None):
    """A HuggingFace GPT-NeoX checkpoint directory (GPTNeoXForCausalLM
    names) -> (cfg, params) on the GPT-J substrate, quantized on
    ``device``; the fused ``query_key_value`` (per head [q | k | v]) is
    split into q, k and v. Parallel-residual checkpoints only."""
    from ..checkpoints import _getter, _read_config, _read_hf_tensors
    from ..ops.common import resolve_device
    from .llama import _quantize_linear

    dev = resolve_device(device)
    hf = _read_config(model_dir)
    built = _config_from_hf(hf, quant)  # refuses what the substrate cannot run
    cfg = built if cfg is None else cfg
    tensors = _read_hf_tensors(model_dir)
    get = _getter(tensors, dev)

    def q(name):
        return _quantize_linear(get(name), cfg)

    h, H, hd = cfg.hidden_size, cfg.num_heads, cfg.hd
    layers = []
    for li in range(cfg.num_layers):
        pre = f"gpt_neox.layers.{li}."
        w3 = get(pre + "attention.query_key_value.weight").reshape(H, 3, hd, h)
        b3 = get(pre + "attention.query_key_value.bias").reshape(H, 3, hd)
        qw, kw, vw = (w3[:, j].reshape(H * hd, h) for j in range(3))
        qb, kb, vb = (b3[:, j].reshape(H * hd).contiguous() for j in range(3))
        layers.append({
            "ln_w": get(pre + "input_layernorm.weight"),
            "ln_b": get(pre + "input_layernorm.bias"),
            "ln2_w": get(pre + "post_attention_layernorm.weight"),
            "ln2_b": get(pre + "post_attention_layernorm.bias"),
            "q_proj": _quantize_linear(qw, cfg),
            "q_bias": qb,
            "k_proj": _quantize_linear(kw, cfg),
            "k_bias": kb,
            "v_proj": _quantize_linear(vw, cfg),
            "v_bias": vb,
            "out_proj": q(pre + "attention.dense.weight"),
            "out_bias": get(pre + "attention.dense.bias"),
            "fc_in": q(pre + "mlp.dense_h_to_4h.weight"),
            "fc_in_b": get(pre + "mlp.dense_h_to_4h.bias"),
            "fc_out": q(pre + "mlp.dense_4h_to_h.weight"),
            "fc_out_b": get(pre + "mlp.dense_4h_to_h.bias"),
        })
        del w3, b3, qw, kw, vw
    params = {
        "wte": get("gpt_neox.embed_in.weight").to(cfg.dtype),
        "layers": layers,
        "ln_f_w": get("gpt_neox.final_layer_norm.weight"),
        "ln_f_b": get("gpt_neox.final_layer_norm.bias"),
        "lm_head": q("embed_out.weight"),
        "lm_head_b": torch.zeros((cfg.vocab_size,), dtype=torch.float32, device=dev),
    }
    return cfg, params


def _config_from_hf(hf: dict, quant: str = "nf4") -> NeoXConfig:
    """A HuggingFace GPT-NeoX config.json dict -> the NeoXConfig of the JAX
    package's loader (parallel-residual checkpoints only)."""
    if not hf.get("use_parallel_residual", True):
        raise NotImplementedError("sequential-residual GPT-NeoX checkpoints are not supported "
                                  "(the substrate implements the parallel block)")
    hd = hf["hidden_size"] // hf["num_attention_heads"]
    return NeoXConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        rotary_dim=int(hf.get("rotary_pct", 0.25) * hd),
        max_seq_len=min(hf.get("max_position_embeddings", 2048), 4096),
        ln_eps=hf.get("layer_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", hf.get("rotary_emb_base", 10000.0)),
        quant=quant,
    )
