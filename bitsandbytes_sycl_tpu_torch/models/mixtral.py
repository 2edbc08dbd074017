"""Mixtral family: Mistral-shaped attention with a top-2 routed mixture of
experts in place of the dense SwiGLU MLP (Mixtral 8x7B, arxiv 2401.04088).
The experts' weights are stacked on a leading dimension
(``llama.stack_experts``) and ``llama_forward`` runs the MoE block
(``llama._moe_ffn``) wherever a layer holds ``experts``."""

from __future__ import annotations

from .llama import LlamaConfig
from .llama import llama_forward as mixtral_forward

__all__ = ["MixtralConfig", "mixtral_forward", "load_mixtral_from_hf"]


class MixtralConfig(LlamaConfig):
    """LlamaConfig with Mixtral-8x7B defaults (32L/4096h/32H/8kv, 8
    experts of 14336, top-2, rope_theta 1e6, full attention)."""

    def __init__(self, **kw):
        defaults = dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=4096,
            rope_theta=1e6, num_experts=8, num_experts_per_tok=2,
        )
        defaults.update(kw)
        super().__init__(**defaults)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            vocab_size=256, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
            num_experts=4, num_experts_per_tok=2,
        )
        defaults.update(kw)
        return cls(**defaults)


def load_mixtral_from_hf(model_dir: str, cfg=None, use_native_quantizer: bool = True, device=None):
    """A HuggingFace Mixtral checkpoint directory -> (cfg, params),
    quantized on ``device`` (the card unless the caller says otherwise).
    Attention, norms and embeddings have Llama's names; the MoE block maps
    ``block_sparse_moe.gate`` to ``router`` and
    ``block_sparse_moe.experts.{e}.w1/w3/w2`` to the stacked
    gate/up/down_proj (``llama.stack_experts``). ``use_native_quantizer``
    has no effect, as in the JAX package."""
    from ..checkpoints import _getter, _read_config, _read_hf_tensors
    from ..ops.common import resolve_device
    from .llama import _quantize_linear, stack_experts

    del use_native_quantizer
    dev = resolve_device(device)
    if cfg is None:
        cfg = _config_from_hf(_read_config(model_dir))
    tensors = _read_hf_tensors(model_dir)
    get = _getter(tensors, dev)

    def q(name):
        return _quantize_linear(get(name), cfg)

    layers = []
    for li in range(cfg.num_layers):
        pre = f"model.layers.{li}."
        moe = pre + "block_sparse_moe."
        layers.append({
            "input_norm": get(pre + "input_layernorm.weight"),
            "post_attn_norm": get(pre + "post_attention_layernorm.weight"),
            "q_proj": q(pre + "self_attn.q_proj.weight"),
            "k_proj": q(pre + "self_attn.k_proj.weight"),
            "v_proj": q(pre + "self_attn.v_proj.weight"),
            "o_proj": q(pre + "self_attn.o_proj.weight"),
            "router": get(moe + "gate.weight"),
            "experts": stack_experts([
                {
                    "gate_proj": q(moe + f"experts.{e}.w1.weight"),
                    "up_proj": q(moe + f"experts.{e}.w3.weight"),
                    "down_proj": q(moe + f"experts.{e}.w2.weight"),
                }
                for e in range(cfg.num_experts)
            ]),
        })
    params = {
        "embed": get("model.embed_tokens.weight").to(cfg.dtype),
        "layers": layers,
        "final_norm": get("model.norm.weight"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = q("lm_head.weight")
    return cfg, params


def _config_from_hf(hf: dict) -> MixtralConfig:
    """A HuggingFace Mixtral config.json dict -> MixtralConfig (the config
    that the JAX package's loader builds)."""
    return MixtralConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", 8),
        max_seq_len=min(hf.get("max_position_embeddings", 4096), 4096),
        rope_theta=hf.get("rope_theta", 1e6),
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        num_experts=hf.get("num_local_experts", 8),
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        tie_embeddings=hf.get("tie_word_embeddings", False),
    )
