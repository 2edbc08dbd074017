"""Mistral family: the Llama architecture with sliding-window attention and
GQA (Mistral 7B, arxiv 2310.06825). The window lives in the config, so the
forward is ``llama_forward``, and the int8 kernels mask it."""

from __future__ import annotations

from .llama import LlamaConfig
from .llama import llama_forward as mistral_forward

__all__ = ["MistralConfig", "mistral_forward", "load_mistral_from_hf"]


class MistralConfig(LlamaConfig):
    """LlamaConfig with Mistral-7B-v0.1 defaults; every Llama entry point
    (``llama_forward``, the engine) takes it. ``dataclasses.replace`` gives
    a MistralConfig back: the given fields win over the defaults."""

    def __init__(self, **kw):
        defaults = dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=4096,
            rope_theta=10000.0, sliding_window=4096,
        )
        defaults.update(kw)
        super().__init__(**defaults)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            vocab_size=256, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
            sliding_window=16,
        )
        defaults.update(kw)
        return cls(**defaults)


def load_mistral_from_hf(model_dir: str, cfg=None, use_native_quantizer: bool = True, device=None):
    """A HuggingFace Mistral checkpoint directory -> (cfg, params),
    quantized on ``device`` (the card unless the caller says otherwise):
    Llama key names, the window and GQA from config.json."""
    from ..checkpoints import _read_config, load_llama_from_hf

    if cfg is None:
        cfg = _config_from_hf(_read_config(model_dir))[0]
    return load_llama_from_hf(model_dir, cfg=cfg, use_native_quantizer=use_native_quantizer,
                              device=device)


def _config_from_hf(hf: dict):
    """A HuggingFace Mistral config.json dict -> (MistralConfig, hf)."""
    cfg = MistralConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", 8),
        max_seq_len=min(hf.get("max_position_embeddings", 4096), 4096),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        sliding_window=hf.get("sliding_window"),
        tie_embeddings=hf.get("tie_word_embeddings", False),
    )
    return cfg, hf
