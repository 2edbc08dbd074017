"""GPT-2 family on the OPT substrate: tanh GELU and learned positions
without an offset. GPT-2's head_dim of 64 is not a multiple of 128, so its
cached attention takes the dequantize-then-attend routes, as in the JAX
package."""

from __future__ import annotations

from ._hf import loader_not_ported
from .opt import OPTConfig
from .opt import opt_forward as gpt2_forward

__all__ = ["GPT2Config", "gpt2_forward", "load_gpt2_from_hf"]

# HF activation_function -> the substrate's act
_ACTS = {"gelu_new": "gelu_tanh", "gelu_pytorch_tanh": "gelu_tanh", "gelu": "gelu",
         "relu": "relu"}


class GPT2Config(OPTConfig):
    """OPTConfig with GPT-2-small defaults (12L/768h/12H, gelu_tanh,
    positions without offset)."""

    def __init__(self, **kw):
        defaults = dict(
            vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12,
            max_seq_len=1024, act="gelu_tanh", pos_offset=0,
        )
        defaults.update(kw)
        super().__init__(**defaults)

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
                 max_seq_len=128, ffn_dim=512)
        d.update(kw)
        return cls(**d)


load_gpt2_from_hf = loader_not_ported("load_gpt2_from_hf")


def _config_from_hf(hf: dict, quant: str = "nf4") -> GPT2Config:
    """A HuggingFace GPT-2 config.json dict -> the GPT2Config of the JAX
    package's loader, refusing the variants it refuses."""
    for flag in ("scale_attn_by_inverse_layer_idx", "reorder_and_upcast_attn"):
        if hf.get(flag, False):
            raise NotImplementedError(f"GPT-2 checkpoints with {flag}=true are not supported")
    hf_act = hf.get("activation_function", "gelu_new")
    if hf_act not in _ACTS:
        raise NotImplementedError(f"GPT-2 activation_function={hf_act!r} is not supported "
                                  f"(known: {sorted(_ACTS)})")
    return GPT2Config(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["n_embd"],
        num_layers=hf["n_layer"],
        num_heads=hf["n_head"],
        ffn_dim=hf.get("n_inner") or 4 * hf["n_embd"],
        max_seq_len=min(hf.get("n_positions", 1024), 4096),
        ln_eps=hf.get("layer_norm_epsilon", 1e-5),
        act=_ACTS[hf_act],
        quant=quant,
    )
