"""BLOOM family on the OPT substrate with ALiBi: no position table, a
LayerNorm on the embeddings, tanh GELU, and the ALiBi distance bias in
attention (kernels C, D and H take the per-head slopes; the
``_attention`` routes add the bias)."""

from __future__ import annotations

from ._hf import loader_not_ported
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


load_bloom_from_hf = loader_not_ported("load_bloom_from_hf")


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
