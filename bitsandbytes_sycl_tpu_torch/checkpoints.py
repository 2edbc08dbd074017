"""Checkpoints (the JAX package's ``checkpoints.py``): the bitsandbytes
quant-state format, ``torch.save`` trees, and HuggingFace directories
quantized on load.

- ``quant_state_as_dict`` / ``quant_state_from_dict`` and
  ``export_params4bit`` / ``import_params4bit``: bitsandbytes' state-dict
  layout, the non-tensor fields JSON-packed into a uint8 tensor under
  ``quant_state.bitsandbytes__{nf4,fp4,...}``; the bytes equal the JAX
  package's for the same ``QuantState``.
- ``save_checkpoint`` / ``load_checkpoint``: any tree of dicts, lists,
  tuples, tensors, Python scalars and the package's dataclasses
  (``QLinearWeight``, ``QuantState``, ``QTensor``), as ``torch.save`` of a
  tree whose dataclasses are flattened to tagged dicts, so
  ``torch.load(weights_only=True)`` reads it back. Optimizer states go in
  as ``opt.state_dict()`` (``optim.BnbOptimizer`` keeps its uint8 codes and
  its step count through ``load_state_dict``).
- ``read_safetensors``: a shard parsed here (8-byte little-endian header
  length, JSON header) and mapped copy-on-write (``torch.from_file``), every
  tensor a view of the mapped bytes in its own dtype (BF16 and F16
  included; F64 becomes F32, as in the JAX reader). Nothing of
  ``safetensors``, ``ml_dtypes`` or ``transformers`` is imported.
- ``load_llama_from_hf`` / ``load_gptj_from_hf``: a HuggingFace checkpoint
  directory (safetensors shards, else ``.bin`` files through
  ``torch.load(weights_only=True)``) quantized on load: each tensor goes to
  ``device`` (the card unless the caller says otherwise), becomes f32
  there, is quantized (``models.llama._quantize_linear``) and is dropped
  before the next, so the host holds the mapped file and about one tensor.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Optional

import torch

from .ops.common import QLinearWeight, resolve_device
from .types import QTensor, QuantState
from .utils import pack_dict_to_tensor, unpack_tensor_to_dict

__all__ = [
    "quant_state_as_dict",
    "quant_state_from_dict",
    "export_params4bit",
    "import_params4bit",
    "save_checkpoint",
    "load_checkpoint",
    "load_llama_from_hf",
    "load_gptj_from_hf",
    "read_safetensors",
]

_VALID_QS_KEYS = (
    "absmax",
    "quant_map",
    "nested_absmax",
    "nested_quant_map",
    "quant_state",
    "quant_type",
    "blocksize",
    "dtype",
    "shape",
    "nested_blocksize",
    "nested_dtype",
    "nested_offset",
)


def quant_state_as_dict(qs: QuantState, packed: bool = True) -> Dict[str, Any]:
    """A QuantState in bitsandbytes' state-dict layout. ``packed``: the
    non-tensor fields JSON-packed into a uint8 tensor under
    ``quant_state.bitsandbytes__<quant_type>`` (what a safetensors file
    can hold)."""
    d: Dict[str, Any] = {
        "quant_type": qs.quant_type,
        "absmax": qs.absmax,
        "blocksize": qs.blocksize,
        "quant_map": qs.code,
        "dtype": qs.dtype,
        "shape": tuple(qs.shape),
    }
    if qs.nested:
        d.update({
            "nested_absmax": qs.state2.absmax,
            "nested_blocksize": qs.state2.blocksize,
            "nested_quant_map": qs.state2.code,
            "nested_dtype": qs.state2.dtype,
            "nested_offset": float(qs.offset),
        })
    if not packed:
        return d
    tensors = {k: v for k, v in d.items() if isinstance(v, torch.Tensor)}
    non_tensors = {k: v for k, v in d.items() if not isinstance(v, torch.Tensor)}
    tensors[f"quant_state.bitsandbytes__{qs.quant_type}"] = pack_dict_to_tensor(non_tensors)
    return tensors


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def quant_state_from_dict(d: Dict[str, Any]) -> QuantState:
    """Inverse of quant_state_as_dict, packed or not, keys with or without
    a prefix."""
    d = dict(d)
    qs_key = [k for k in d if "quant_state" in k and hasattr(d[k], "__len__")]
    if qs_key:
        (key,) = qs_key
        d.update(unpack_tensor_to_dict(d.pop(key)))
    d = {k.split(".")[-1]: v for k, v in d.items()}
    unknown = set(d) - set(_VALID_QS_KEYS)
    if unknown:
        raise ValueError(f"unknown quant-state keys: {unknown}")
    absmax = _tensor(d["absmax"])
    state2 = offset = None
    if "nested_absmax" in d:
        state2 = QuantState(
            absmax=_tensor(d["nested_absmax"]),
            code=_tensor(d["nested_quant_map"]),
            blocksize=int(d["nested_blocksize"]),
            dtype=str(d["nested_dtype"]),
            shape=(int(absmax.numel()),),  # state2 describes the quantized absmax
            quant_type="dynamic",
        )
        offset = torch.tensor(float(d["nested_offset"]), dtype=torch.float32,
                              device=absmax.device)
    return QuantState(
        absmax=absmax,
        code=_tensor(d["quant_map"]),
        blocksize=int(d["blocksize"]),
        dtype=str(d["dtype"]),
        shape=tuple(int(s) for s in d["shape"]),
        quant_type=str(d["quant_type"]),
        offset=offset,
        state2=state2,
    )


def export_params4bit(packed_data: torch.Tensor, qs: QuantState,
                      prefix: str = "weight") -> Dict[str, torch.Tensor]:
    """A bnb ``Linear4bit`` state-dict entry: ``<prefix>``, the packed
    payload as bnb stores it ((n // 2, 1) uint8), and ``<prefix>.<key>`` for
    the packed quant state."""
    out = {prefix: packed_data.reshape(-1, 1)}
    for k, v in quant_state_as_dict(qs, packed=True).items():
        out[f"{prefix}.{k}"] = v
    return out


def import_params4bit(state_dict: Dict[str, Any], prefix: str = "weight"):
    """Inverse of export_params4bit -> (flat uint8 payload, QuantState)."""
    qs_items = {k[len(prefix) + 1:]: v for k, v in state_dict.items()
                if k.startswith(prefix + ".")}
    qs = quant_state_from_dict(qs_items)
    packed = _tensor(state_dict[prefix]).reshape(-1).to(torch.uint8)
    return packed, qs


# ---------------------------------------------------------------------------
# torch.save trees
# ---------------------------------------------------------------------------

_TAG = "__bnb_dataclass__"
_DATACLASSES = {cls.__name__: cls for cls in (QLinearWeight, QuantState, QTensor)}


def _flatten(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _DATACLASSES:
            raise TypeError(f"save_checkpoint: no tag for dataclass {name}")
        out = {_TAG: name}
        for f in dataclasses.fields(obj):
            out[f.name] = _flatten(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {k: _flatten(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_flatten(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_flatten(v) for v in obj)
    return obj


def _to(t: torch.Tensor, device) -> torch.Tensor:
    """t on ``device``; a tensor that requires grad stays a leaf there."""
    if t.requires_grad:
        return t.detach().to(device).requires_grad_()
    return t.to(device)


def _unflatten(obj, device, target=None):
    if isinstance(obj, dict) and _TAG in obj:
        cls = _DATACLASSES[obj[_TAG]]
        fields = {}
        for f in dataclasses.fields(cls):
            v = obj[f.name]
            tv = getattr(target, f.name) if target is not None else None
            v = _unflatten(v, device, tv)
            fields[f.name] = tuple(v) if isinstance(v, list) and f.name == "shape" else v
        return cls(**fields)
    if isinstance(obj, dict):
        if target is not None and set(obj) != set(target):
            raise ValueError(f"load_checkpoint: keys {sorted(map(str, obj))} differ from the "
                             f"target's {sorted(map(str, target))}")
        return {k: _unflatten(v, device, None if target is None else target[k])
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        if target is not None and len(obj) != len(target):
            raise ValueError("load_checkpoint: a sequence's length differs from the target's")
        out = [_unflatten(v, device, None if target is None else target[i])
               for i, v in enumerate(obj)]
        return tuple(out) if isinstance(obj, tuple) else out
    if isinstance(obj, torch.Tensor):
        if target is not None:
            return _to(obj, target.device) if isinstance(target, torch.Tensor) else obj
        return _to(obj, device)
    return obj


def save_checkpoint(path: str, tree: Any) -> None:
    """``torch.save`` of a tree of dicts, lists, tuples, tensors, scalars
    and the package's dataclasses (flattened to tagged dicts). uint8
    payloads, scales and optimizer states come back bit for bit."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_flatten(tree), path)


def load_checkpoint(path: str, target: Optional[Any] = None, device=None) -> Any:
    """The tree that save_checkpoint wrote, read with
    ``torch.load(weights_only=True)``. Tensors go to ``device`` (the card
    unless the caller says otherwise), or, with a ``target`` tree of the
    same structure, each to the device of the target's tensor there."""
    dev = None if target is not None else resolve_device(device)
    flat = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return _unflatten(flat, dev, target)


# ---------------------------------------------------------------------------
# safetensors and HuggingFace directories
# ---------------------------------------------------------------------------

_DTYPES = {
    "F32": torch.float32,
    "F64": torch.float64,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "U64": torch.uint64,
    "I32": torch.int32,
    "U32": torch.uint32,
    "I16": torch.int16,
    "U16": torch.uint16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of one safetensors file, by name, as views of the file
    mapped copy-on-write: no copy is made (but for F64, returned as F32,
    and a tensor whose offset does not suit its dtype's alignment, which is
    copied alone). The file's pages are read as the tensors are used."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    size = os.path.getsize(path)
    data = torch.from_file(path, shared=False, size=size, dtype=torch.uint8)
    base = 8 + hlen
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        dtype = _DTYPES[meta["dtype"]]
        raw = data[base + lo: base + hi]
        if (base + lo) % dtype.itemsize:
            raw = raw.clone()
        t = raw.view(dtype).reshape(meta["shape"])
        out[name] = t.float() if dtype == torch.float64 else t
    return out


def _read_hf_tensors(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory: its safetensors shards if
    it has any, else its ``.bin`` files (``torch.load(weights_only=True)``,
    memory-mapped where the file's format allows)."""
    files = sorted(os.listdir(model_dir))
    out: Dict[str, torch.Tensor] = {}
    st = [f for f in files if f.endswith(".safetensors")]
    if st:
        for fname in st:
            out.update(read_safetensors(os.path.join(model_dir, fname)))
        return out
    bins = [f for f in files if f.endswith(".bin")]
    if bins:
        for fname in bins:
            p = os.path.join(model_dir, fname)
            try:
                sd = torch.load(p, map_location="cpu", weights_only=True, mmap=True)
            except RuntimeError:  # a legacy (non-zip) file cannot be mapped
                sd = torch.load(p, map_location="cpu", weights_only=True)
            out.update(sd)
        return out
    raise FileNotFoundError(f"no safetensors/bin weights in {model_dir}")


def _read_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def _getter(tensors: Dict[str, torch.Tensor], dev: torch.device):
    """name -> the tensor on ``dev`` as f32 (upcast there)."""
    def get(name: str) -> torch.Tensor:
        return tensors[name].to(dev).float()
    return get


_HF_LAYER_MAP = {
    "q_proj": "self_attn.q_proj.weight",
    "k_proj": "self_attn.k_proj.weight",
    "v_proj": "self_attn.v_proj.weight",
    "o_proj": "self_attn.o_proj.weight",
    "gate_proj": "mlp.gate_proj.weight",
    "up_proj": "mlp.up_proj.weight",
    "down_proj": "mlp.down_proj.weight",
    "input_norm": "input_layernorm.weight",
    "post_attn_norm": "post_attention_layernorm.weight",
}

# Gemma-2's sandwich norms: HF's post_attention_layernorm norms the
# attention output (attn_out_norm here) and the pre-MLP norm is
# pre_feedforward_layernorm (the post_attn_norm slot)
_HF_LAYER_MAP_SANDWICH = {
    **{k: v for k, v in _HF_LAYER_MAP.items() if not k.endswith("_norm")},
    "input_norm": "input_layernorm.weight",
    "attn_out_norm": "post_attention_layernorm.weight",
    "post_attn_norm": "pre_feedforward_layernorm.weight",
    "ffn_out_norm": "post_feedforward_layernorm.weight",
}


def load_llama_from_hf(model_dir: str, cfg=None, use_native_quantizer: bool = True, device=None):
    """A HuggingFace Llama-layout checkpoint directory -> (cfg, params),
    every projection quantized on ``device`` as ``cfg.quant`` says. The
    config comes from config.json when ``cfg`` is None. Qwen2-style qkv
    biases load where ``cfg.attn_bias``, Gemma-2's sandwich norms where
    ``cfg.sandwich_norms``. ``use_native_quantizer`` is accepted and, as in
    the JAX package, has no effect."""
    from .models.llama import LlamaConfig, _quantize_linear

    del use_native_quantizer
    dev = resolve_device(device)
    if cfg is None:
        hf = _read_config(model_dir)
        cfg = LlamaConfig(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            max_seq_len=min(hf.get("max_position_embeddings", 2048), 4096),
            rope_theta=hf.get("rope_theta", 10000.0),
            rms_eps=hf.get("rms_norm_eps", 1e-5),
            tie_embeddings=hf.get("tie_word_embeddings", False),
        )
    tensors = _read_hf_tensors(model_dir)
    get = _getter(tensors, dev)
    lmap = _HF_LAYER_MAP_SANDWICH if getattr(cfg, "sandwich_norms", False) else _HF_LAYER_MAP
    layers = []
    for li in range(cfg.num_layers):
        pre = f"model.layers.{li}."
        layer = {}
        for ours, theirs in lmap.items():
            w = get(pre + theirs)
            layer[ours] = _quantize_linear(w, cfg) if ours.endswith("_proj") else w
            del w
        if getattr(cfg, "attn_bias", False):  # Qwen2-style qkv biases
            for b in ("q", "k", "v"):
                layer[f"{b}_bias"] = get(pre + f"self_attn.{b}_proj.bias")
        layers.append(layer)
    params = {
        "embed": get("model.embed_tokens.weight").to(cfg.dtype),
        "layers": layers,
        "final_norm": get("model.norm.weight"),
    }
    if not cfg.tie_embeddings and "lm_head.weight" in tensors:
        params["lm_head"] = _quantize_linear(get("lm_head.weight"), cfg)
    return cfg, params


def load_gptj_from_hf(model_dir: str, cfg=None, quant: str = "nf4", device=None):
    """A HuggingFace GPT-J checkpoint directory -> (cfg, params), every
    projection quantized on ``device`` as ``quant`` (or ``cfg.quant``)
    says."""
    from .models.gptj import GPTJConfig
    from .models.llama import _quantize_linear

    dev = resolve_device(device)
    if cfg is None:
        hf = _read_config(model_dir)
        cfg = GPTJConfig(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["n_embd"],
            num_layers=hf["n_layer"],
            num_heads=hf["n_head"],
            rotary_dim=hf.get("rotary_dim", 64),
            max_seq_len=min(hf.get("n_positions", 2048), 4096),
            ln_eps=hf.get("layer_norm_epsilon", 1e-5),
            quant=quant,
        )
    tensors = _read_hf_tensors(model_dir)
    get = _getter(tensors, dev)

    def q(name):
        return _quantize_linear(get(name), cfg)

    layers = []
    for li in range(cfg.num_layers):
        pre = f"transformer.h.{li}."
        layers.append({
            "ln_w": get(pre + "ln_1.weight"),
            "ln_b": get(pre + "ln_1.bias"),
            "q_proj": q(pre + "attn.q_proj.weight"),
            "k_proj": q(pre + "attn.k_proj.weight"),
            "v_proj": q(pre + "attn.v_proj.weight"),
            "out_proj": q(pre + "attn.out_proj.weight"),
            "fc_in": q(pre + "mlp.fc_in.weight"),
            "fc_in_b": get(pre + "mlp.fc_in.bias"),
            "fc_out": q(pre + "mlp.fc_out.weight"),
            "fc_out_b": get(pre + "mlp.fc_out.bias"),
        })
    params = {
        "wte": get("transformer.wte.weight").to(cfg.dtype),
        "layers": layers,
        "ln_f_w": get("transformer.ln_f.weight"),
        "ln_f_b": get("transformer.ln_f.bias"),
        "lm_head": q("lm_head.weight"),
        "lm_head_b": (get("lm_head.bias") if "lm_head.bias" in tensors
                      else torch.zeros((cfg.vocab_size,), dtype=torch.float32, device=dev)),
    }
    return cfg, params
