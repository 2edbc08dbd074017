"""Falcon family (Falcon-7B/40B/180B) on the GPT-J substrate: multi-query
or grouped-query attention (``kv_heads``), half-split rotary over the whole
head, no biases; Falcon-40B's two LayerNorms are the substrate's ``ln2``.
Falcon-7B's head_dim of 64 is not a multiple of 128, so its cached
attention takes the dequantize-then-attend routes, as in the JAX package."""

from __future__ import annotations

from ._hf import loader_not_ported
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


load_falcon_from_hf = loader_not_ported("load_falcon_from_hf")


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
