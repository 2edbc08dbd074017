"""GPT-NeoX family (Pythia, GPT-NeoX-20B) on the GPT-J substrate: the MLP
reads its own LayerNorm (layers hold ``ln2_w``/``ln2_b``), half-split
rotary on ``rotary_pct`` of the head dims, biased attention and exact-erf
GELU."""

from __future__ import annotations

from ._hf import loader_not_ported
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


load_neox_from_hf = loader_not_ported("load_neox_from_hf")


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
