"""Gemma and Gemma-2: Llama-shaped decoders on ``llama_forward``'s options.

Gemma (arxiv 2403.08295): a tanh-GELU gate (``mlp_act="gelu_tanh"``),
RMSNorm weights stored as the offset from 1 (``norm_offset``), embeddings
times sqrt(hidden) (``scale_embeddings``), a head_dim of 256 apart from
hidden / heads, and tied embeddings. Gemma-2 (arxiv 2408.00118) adds
sandwich norms, attention and final logit softcapping, alternating
sliding/global layers and the softmax scale query_pre_attn_scalar**-0.5.
Kernels C and H take head_dim 256 on their SIMT bodies, kernel D on its
split body.
"""

from __future__ import annotations

from .llama import LlamaConfig
from .llama import llama_forward as gemma_forward
from .llama import llama_forward as gemma2_forward

__all__ = ["GemmaConfig", "gemma_forward", "load_gemma_from_hf",
           "Gemma2Config", "gemma2_forward", "load_gemma2_from_hf"]


class GemmaConfig(LlamaConfig):
    """LlamaConfig with Gemma-7B defaults (28L/3072h/16H, head_dim 256,
    GeGLU, (1 + w) norms, scaled and tied embeddings)."""

    def __init__(self, **kw):
        defaults = dict(
            vocab_size=256000, hidden_size=3072, intermediate_size=24576,
            num_layers=28, num_heads=16, num_kv_heads=16, head_dim=256,
            max_seq_len=4096, rope_theta=10000.0, rms_eps=1e-6,
            mlp_act="gelu_tanh", norm_offset=True, scale_embeddings=True,
            tie_embeddings=True,
        )
        defaults.update(kw)
        super().__init__(**defaults)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            vocab_size=256, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
            max_seq_len=128,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def gemma2b(cls, **kw):
        defaults = dict(
            hidden_size=2048, intermediate_size=16384, num_layers=18,
            num_heads=8, num_kv_heads=1,
        )
        defaults.update(kw)
        return cls(**defaults)


def load_gemma_from_hf(model_dir: str, cfg=None, use_native_quantizer: bool = True, device=None):
    """A HuggingFace Gemma checkpoint directory -> (cfg, params), quantized
    on ``device`` (the card unless the caller says otherwise): Llama key
    names, the norm weights stored as offsets from one (``norm_offset``)."""
    from ..checkpoints import _read_config, load_llama_from_hf

    if cfg is None:
        cfg = _config_from_hf(_read_config(model_dir))
    return load_llama_from_hf(model_dir, cfg=cfg, use_native_quantizer=use_native_quantizer,
                              device=device)


def _config_from_hf(hf: dict) -> GemmaConfig:
    """A HuggingFace Gemma config.json dict -> GemmaConfig."""
    return GemmaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
        max_seq_len=min(hf.get("max_position_embeddings", 4096), 4096),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-6),
        tie_embeddings=True,  # Gemma checkpoints never ship lm_head
    )


class Gemma2Config(GemmaConfig):
    """Gemma-2-9B defaults on top of Gemma's: sandwich norms, softcaps 50
    (attention) and 30 (final), even layers sliding (window 4096) and odd
    ones global, softmax scale 256**-0.5."""

    def __init__(self, **kw):
        defaults = dict(
            vocab_size=256000, hidden_size=3584, intermediate_size=14336,
            num_layers=42, num_heads=16, num_kv_heads=8, head_dim=256,
            max_seq_len=4096, rope_theta=10000.0, rms_eps=1e-6,
            sandwich_norms=True, attn_logit_softcap=50.0,
            final_logit_softcap=30.0, query_scale=256.0,
            sliding_window=4096, sliding_alternating=True,
        )
        defaults.update(kw)
        super().__init__(**defaults)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            vocab_size=256, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
            max_seq_len=128, query_scale=64.0, sliding_window=64,
        )
        defaults.update(kw)
        return cls(**defaults)


def load_gemma2_from_hf(model_dir: str, cfg=None, use_native_quantizer: bool = True, device=None):
    """A HuggingFace Gemma-2 checkpoint directory -> (cfg, params),
    quantized on ``device`` (the card unless the caller says otherwise):
    the sandwich norms through ``checkpoints._HF_LAYER_MAP_SANDWICH``."""
    from ..checkpoints import _read_config, load_llama_from_hf

    if cfg is None:
        cfg = _config_from_hf2(_read_config(model_dir))
    return load_llama_from_hf(model_dir, cfg=cfg, use_native_quantizer=use_native_quantizer,
                              device=device)


def _config_from_hf2(hf: dict) -> Gemma2Config:
    """A HuggingFace Gemma-2 config.json dict -> Gemma2Config."""
    return Gemma2Config(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
        max_seq_len=min(hf.get("max_position_embeddings", 4096), 4096),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-6),
        attn_logit_softcap=hf.get("attn_logit_softcapping", 50.0),
        final_logit_softcap=hf.get("final_logit_softcapping", 30.0),
        query_scale=float(hf.get("query_pre_attn_scalar", 256)),
        sliding_window=hf.get("sliding_window", 4096),
        tie_embeddings=True,
    )
