"""BLOOM family on the OPT substrate with ALiBi: no position table, a
LayerNorm on the embeddings, tanh GELU, and the ALiBi distance bias in
attention (kernels C, D and H take the per-head slopes; the
``_attention`` routes add the bias)."""

from __future__ import annotations

from .opt import OPTConfig
from .opt import opt_forward as bloom_forward

__all__ = ["BloomConfig", "bloom_forward", "load_bloom_from_hf"]


class BloomConfig(OPTConfig):
    """OPTConfig with bloom-7b1 defaults (30L/4096h/32H, ALiBi, embedding
    LayerNorm, gelu_tanh)."""

    def __init__(self, **kw):
        defaults = dict(
            vocab_size=250880, hidden_size=4096, num_layers=30,
            num_heads=32, max_seq_len=2048, act="gelu_tanh", alibi=True,
        )
        defaults.update(kw)
        super().__init__(**defaults)

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
                 max_seq_len=128, ffn_dim=512)
        d.update(kw)
        return cls(**d)


def load_bloom_from_hf(model_dir: str, cfg=None, quant: str = "nf4", device=None):
    """A HuggingFace BLOOM checkpoint directory (BloomForCausalLM names) ->
    (cfg, params) on the OPT substrate, quantized on ``device``; the fused
    qkv (per head [q | k | v]) splits into q, k and v; the embedding
    LayerNorm loads as ``wln_*``; lm_head is tied unless shipped."""
    from ..checkpoints import _getter, _read_config, _read_hf_tensors
    from ..ops.common import resolve_device
    from .llama import _quantize_linear

    dev = resolve_device(device)
    built = _config_from_hf(_read_config(model_dir), quant)  # refuses unsupported variants
    cfg = built if cfg is None else cfg
    tensors = _read_hf_tensors(model_dir)
    pfx = "transformer." if any(k.startswith("transformer.") for k in tensors) else ""
    get_any = _getter(tensors, dev)

    def get(name):
        return get_any(pfx + name)

    def q(name):
        return _quantize_linear(get(name), cfg)

    H, h, hd = cfg.num_heads, cfg.hidden_size, cfg.hd
    layers = []
    for li in range(cfg.num_layers):
        pre = f"h.{li}."
        w3 = get(pre + "self_attention.query_key_value.weight").reshape(H, 3, hd, h)
        b3 = get(pre + "self_attention.query_key_value.bias").reshape(H, 3, hd)
        qw, kw, vw = (w3[:, j].reshape(H * hd, h) for j in range(3))
        qb, kb, vb = (b3[:, j].reshape(H * hd).contiguous() for j in range(3))
        layers.append({
            "ln1_w": get(pre + "input_layernorm.weight"),
            "ln1_b": get(pre + "input_layernorm.bias"),
            "q_proj": _quantize_linear(qw, cfg),
            "q_bias": qb,
            "k_proj": _quantize_linear(kw, cfg),
            "k_bias": kb,
            "v_proj": _quantize_linear(vw, cfg),
            "v_bias": vb,
            "out_proj": q(pre + "self_attention.dense.weight"),
            "out_bias": get(pre + "self_attention.dense.bias"),
            "ln2_w": get(pre + "post_attention_layernorm.weight"),
            "ln2_b": get(pre + "post_attention_layernorm.bias"),
            "fc1": q(pre + "mlp.dense_h_to_4h.weight"),
            "fc1_b": get(pre + "mlp.dense_h_to_4h.bias"),
            "fc2": q(pre + "mlp.dense_4h_to_h.weight"),
            "fc2_b": get(pre + "mlp.dense_4h_to_h.bias"),
        })
        del w3, b3, qw, kw, vw
    wte = get("word_embeddings.weight")
    head = get_any("lm_head.weight") if "lm_head.weight" in tensors else wte
    params = {
        "wte": wte.to(cfg.dtype),
        "wln_w": get("word_embeddings_layernorm.weight"),
        "wln_b": get("word_embeddings_layernorm.bias"),
        "layers": layers,
        "ln_f_w": get("ln_f.weight"),
        "ln_f_b": get("ln_f.bias"),
        "lm_head": _quantize_linear(head, cfg),
    }
    return cfg, params


def _config_from_hf(hf: dict, quant: str = "nf4") -> BloomConfig:
    """A HuggingFace BLOOM config.json dict -> the BloomConfig of the JAX
    package's loader (pre-LayerNorm residuals only)."""
    if hf.get("apply_residual_connection_post_layernorm", False):
        raise NotImplementedError("post-layernorm-residual BLOOM checkpoints are not supported")
    return BloomConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf.get("hidden_size", hf.get("n_embed")),
        num_layers=hf.get("n_layer", hf.get("num_hidden_layers")),
        num_heads=hf.get("n_head", hf.get("num_attention_heads")),
        ln_eps=hf.get("layer_norm_epsilon", 1e-5),
        quant=quant,
    )
