"""GPT-2 family on the OPT substrate: tanh GELU and learned positions
without an offset. GPT-2's head_dim of 64 is not a multiple of 128, so its
cached attention takes the dequantize-then-attend routes, as in the JAX
package."""

from __future__ import annotations

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


def load_gpt2_from_hf(model_dir: str, cfg=None, quant: str = "nf4", device=None):
    """A HuggingFace GPT-2 checkpoint directory (GPT2LMHeadModel names,
    Conv1D weights stored (in, out), transposed here) -> (cfg, params) on
    the OPT substrate, quantized on ``device``; the column-fused c_attn
    splits into q, k and v; lm_head is tied to wte unless shipped."""
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

    def conv1d_t(name):
        return get(name).T.contiguous()

    h = cfg.hidden_size
    layers = []
    for li in range(cfg.num_layers):
        pre = f"h.{li}."
        qkv_w = conv1d_t(pre + "attn.c_attn.weight")  # (3h, h)
        qkv_b = get(pre + "attn.c_attn.bias")
        layers.append({
            "ln1_w": get(pre + "ln_1.weight"),
            "ln1_b": get(pre + "ln_1.bias"),
            "q_proj": _quantize_linear(qkv_w[:h], cfg),
            "q_bias": qkv_b[:h],
            "k_proj": _quantize_linear(qkv_w[h:2 * h], cfg),
            "k_bias": qkv_b[h:2 * h],
            "v_proj": _quantize_linear(qkv_w[2 * h:], cfg),
            "v_bias": qkv_b[2 * h:],
            "out_proj": _quantize_linear(conv1d_t(pre + "attn.c_proj.weight"), cfg),
            "out_bias": get(pre + "attn.c_proj.bias"),
            "ln2_w": get(pre + "ln_2.weight"),
            "ln2_b": get(pre + "ln_2.bias"),
            "fc1": _quantize_linear(conv1d_t(pre + "mlp.c_fc.weight"), cfg),
            "fc1_b": get(pre + "mlp.c_fc.bias"),
            "fc2": _quantize_linear(conv1d_t(pre + "mlp.c_proj.weight"), cfg),
            "fc2_b": get(pre + "mlp.c_proj.bias"),
        })
        del qkv_w
    wte = get("wte.weight")
    head = get_any("lm_head.weight") if "lm_head.weight" in tensors else wte
    params = {
        "wte": wte.to(cfg.dtype),
        "wpe": get("wpe.weight").to(cfg.dtype),
        "layers": layers,
        "ln_f_w": get("ln_f.weight"),
        "ln_f_b": get("ln_f.bias"),
        "lm_head": _quantize_linear(head, cfg),
    }
    return cfg, params


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
