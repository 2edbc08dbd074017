"""Phi family (phi-1, 1.5, 2) on the GPT-J substrate: half-split (NeoX)
rotary on the first ``rotary_dim`` dims and biased attention projections
(``rope_style="neox"``, ``attn_bias``). Phi-2's head_dim of 80 is not a
multiple of 128, so its cached attention takes the dequantize-then-attend
routes, as in the JAX package."""

from __future__ import annotations

from .gptj import GPTJConfig
from .gptj import gptj_forward as phi_forward

__all__ = ["PhiConfig", "phi_forward", "load_phi_from_hf"]


class PhiConfig(GPTJConfig):
    """GPTJConfig with phi-2 defaults (32L/2560h/32H, rotary_dim 32 = 0.4
    of head_dim, NeoX rotary, biased attention projections)."""

    def __init__(self, **kw):
        defaults = dict(
            vocab_size=51200, hidden_size=2560, num_layers=32,
            num_heads=32, rotary_dim=32, max_seq_len=2048,
            rope_style="neox", attn_bias=True,
        )
        defaults.update(kw)
        super().__init__(**defaults)

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=2,
                 rotary_dim=64, max_seq_len=128)
        d.update(kw)
        return cls(**d)


def load_phi_from_hf(model_dir: str, cfg=None, quant: str = "nf4", device=None):
    """A HuggingFace Phi checkpoint directory (PhiForCausalLM names:
    ``model.layers.N.self_attn.{q,k,v}_proj``/``dense``, ``mlp.fc1/fc2``,
    ``input_layernorm``, ``model.final_layernorm``, a biased lm_head) ->
    (cfg, params) on the GPT-J substrate, quantized on ``device``."""
    from ..checkpoints import _getter, _read_config, _read_hf_tensors
    from ..ops.common import resolve_device
    from .llama import _quantize_linear

    dev = resolve_device(device)
    if cfg is None:
        cfg = _config_from_hf(_read_config(model_dir), quant)
    tensors = _read_hf_tensors(model_dir)
    get = _getter(tensors, dev)

    def q(name):
        return _quantize_linear(get(name), cfg)

    layers = []
    for li in range(cfg.num_layers):
        pre = f"model.layers.{li}."
        layers.append({
            "ln_w": get(pre + "input_layernorm.weight"),
            "ln_b": get(pre + "input_layernorm.bias"),
            "q_proj": q(pre + "self_attn.q_proj.weight"),
            "q_bias": get(pre + "self_attn.q_proj.bias"),
            "k_proj": q(pre + "self_attn.k_proj.weight"),
            "k_bias": get(pre + "self_attn.k_proj.bias"),
            "v_proj": q(pre + "self_attn.v_proj.weight"),
            "v_bias": get(pre + "self_attn.v_proj.bias"),
            "out_proj": q(pre + "self_attn.dense.weight"),
            "out_bias": get(pre + "self_attn.dense.bias"),
            "fc_in": q(pre + "mlp.fc1.weight"),
            "fc_in_b": get(pre + "mlp.fc1.bias"),
            "fc_out": q(pre + "mlp.fc2.weight"),
            "fc_out_b": get(pre + "mlp.fc2.bias"),
        })
    params = {
        "wte": get("model.embed_tokens.weight").to(cfg.dtype),
        "layers": layers,
        "ln_f_w": get("model.final_layernorm.weight"),
        "ln_f_b": get("model.final_layernorm.bias"),
        "lm_head": q("lm_head.weight"),
        "lm_head_b": get("lm_head.bias"),
    }
    return cfg, params


def _config_from_hf(hf: dict, quant: str = "nf4") -> PhiConfig:
    """A HuggingFace Phi config.json dict -> the PhiConfig of the JAX
    package's loader."""
    hd = hf["hidden_size"] // hf["num_attention_heads"]
    return PhiConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        rotary_dim=int(hf.get("partial_rotary_factor", 0.4) * hd),
        max_seq_len=min(hf.get("max_position_embeddings", 2048), 4096),
        ln_eps=hf.get("layer_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        quant=quant,
    )
