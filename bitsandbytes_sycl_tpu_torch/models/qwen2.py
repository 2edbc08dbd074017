"""Qwen2 family: the Llama architecture with additive q/k/v biases and GQA
(arxiv 2407.10671). The biases are layer params (``attn_bias``), so the
forward is ``llama_forward``. Qwen2-7B has 28 query heads over 4 kv heads,
a group of 7, which kernels H and D take."""

from __future__ import annotations

from .llama import LlamaConfig
from .llama import llama_forward as qwen2_forward

__all__ = ["Qwen2Config", "qwen2_forward", "load_qwen2_from_hf"]


class Qwen2Config(LlamaConfig):
    """LlamaConfig with Qwen2-7B defaults (28L/3584h/28H/4kv, qkv bias,
    rope_theta 1e6)."""

    def __init__(self, **kw):
        defaults = dict(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, max_seq_len=4096,
            rope_theta=1e6, attn_bias=True,
        )
        defaults.update(kw)
        super().__init__(**defaults)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            vocab_size=256, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
        )
        defaults.update(kw)
        return cls(**defaults)


def load_qwen2_from_hf(model_dir: str, cfg=None, use_native_quantizer: bool = True, device=None):
    """A HuggingFace Qwen2 checkpoint directory -> (cfg, params), quantized
    on ``device`` (the card unless the caller says otherwise): Llama key
    names and the q/k/v biases (``attn_bias``)."""
    from ..checkpoints import _read_config, load_llama_from_hf

    if cfg is None:
        cfg = _config_from_hf(_read_config(model_dir))
    return load_llama_from_hf(model_dir, cfg=cfg, use_native_quantizer=use_native_quantizer,
                              device=device)


def _config_from_hf(hf: dict) -> Qwen2Config:
    """A HuggingFace Qwen2 config.json dict -> Qwen2Config."""
    return Qwen2Config(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        max_seq_len=min(hf.get("max_position_embeddings", 4096), 4096),
        rope_theta=hf.get("rope_theta", 1e6),
        rms_eps=hf.get("rms_norm_eps", 1e-6),
        tie_embeddings=hf.get("tie_word_embeddings", False),
        attn_bias=True,
    )
