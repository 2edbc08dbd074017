"""Llama-family decoder with quantized weights, in PyTorch.

Parameters are plain dicts of tensors with the JAX package's structure:
``{"embed", "layers": [{"q_proj": weight, ..., "input_norm",
"post_attn_norm"}], "final_norm", "lm_head"}``, where a weight is a 4-bit
``QLinearWeight`` or an LLM.int8 dict ``{"CB", "SCB"[, "outliers"]}``. The
KV cache is a dict in the JAX package's layouts: int8, contiguous or
paged, or the contiguous bf16 cache (``kv_quant=False``).
LoRA adapters (``models/lora.py``) are a per-layer list of ``{proj_name:
{"A", "B", "scale"}}`` threaded through ``llama_forward(lora=...)``; the
4-bit linears' backwards (``ops.matmul_4bit.ExactDequantGrad``) and the
LLM.int8 linears' (``autograd.matmul_8bit_lt``, grad = g @ dequant(CB))
carry gradients through the frozen base, so ``llama_forward`` records a graph
whenever an adapter leaf requires grad (the engine serves under
``torch.no_grad()``).
Decode steps write each layer's quantized token in place before attending
with ``lengths = position`` and the token folded in as ``new_kv``; the
attention masks positions ``>= len``, so the early write leaves the result
equal to the JAX package's deferred write.

Mixtral's mixture of experts (``num_experts > 1``): a layer carries a
``router`` (E, h) and ``experts``, the gate/up/down weights of its E
experts stacked on a leading dimension (``stack_experts``); ``_moe_ffn``
routes each token to its top-k experts (softmax over all E, top-k,
renormalized) and runs every expert on every token (dense combine), or
from ``moe_dispatch_min_tokens`` tokens only on the ones it chose, up to a
capacity (``_moe_dispatch``). ALiBi (``alibi`` in a config, BLOOM) goes to
the attention kernels as per-head slopes and to the ``_attention`` routes
as a bias. The helpers that every family shares (``apply_linear``,
``write_and_attend``, ``init_kv_cache``, ``kernel_attends``) read the
config's optional fields with ``getattr``, as the JAX package does, so the
GPT-J and OPT substrates (``models/gptj.py``, ``models/opt.py``) use them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fnn

from .. import functional as F
from ..autograd import matmul_8bit_lt
from ..ops.common import QLinearWeight, quantize_4bit_native, resolve_device
from ..ops.matmul_4bit import differentiable, matmul_4bit_fused
from ..ops.matmul_w4a8 import (
    W8A8_PREFILL_MIN_M,
    grouped_min_m,
    matmul_4bit_w4a8,
    matmul_4bit_w4a8_grouped,
    matmul_4bit_w8a8_prefill,
)

__all__ = [
    "LlamaConfig",
    "init_params",
    "quantize_params",
    "llama_forward",
    "init_kv_cache",
    "apply_linear",
    "linear_route",
    "repack_params_int8",
    "write_and_attend",
    "kernel_attends",
    "stack_experts",
    "alibi_slopes",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The JAX package's LlamaConfig, field for field (see its docstrings)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    quant: str = "nf4"
    blocksize: int = 64
    compress_stats: bool = False
    absmax_dtype: str = "bfloat16"
    a8_decode: bool = True
    llm_int8_threshold: float = 6.0
    kv_quant: bool = True
    kv_bits: int = 8
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None
    attn_bias: bool = False
    mlp_act: str = "silu"
    norm_offset: bool = False
    scale_embeddings: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    sandwich_norms: bool = False
    sliding_alternating: bool = False
    num_experts: int = 1
    num_experts_per_tok: int = 2
    moe_dispatch_min_tokens: int = 0
    moe_capacity_factor: float = 2.0
    pages_hint: Optional[int] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw):
        """Test-sized config."""
        defaults = dict(
            vocab_size=256, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def llama7b(cls, **kw):
        return cls(**kw)

    @classmethod
    def serving7b(cls, **kw):
        """The JAX package's single-chip 7B serving preset: NF4 at
        blocksize 128 with W4A8 decode and bf16 scales."""
        defaults = dict(
            quant="nf4", blocksize=128, a8_decode=True,
            absmax_dtype="bfloat16", kv_quant=True,
        )
        defaults.update(kw)
        return cls(**defaults)


# ---------------------------------------------------------------------------
# linears
# ---------------------------------------------------------------------------


def _quantize_linear(W: torch.Tensor, cfg: LlamaConfig):
    if cfg.quant in ("nf4", "fp4", "int4", "af4"):
        return quantize_4bit_native(
            W, blocksize=cfg.blocksize, quant_type=cfg.quant,
            compress_statistics=cfg.compress_stats,
            absmax_dtype=getattr(torch, getattr(cfg, "absmax_dtype", "float32")),
        )
    if cfg.quant == "int8":
        CB, SCB = F.int8_vectorwise_quant(W)
        out = {"CB": CB, "SCB": SCB}
        if cfg.llm_int8_threshold > 0.0:
            # static outlier columns, predicted from the weight's statistics
            from ..utils import find_outlier_dims

            idx = find_outlier_dims(W, reduction_dim=0, topk=min(32, W.shape[1]))
            out["outliers"] = F.llm_int8_prepare_outliers(CB, SCB, idx)
        return out
    return W.to(cfg.dtype)


@torch.no_grad()
def repack_params_int8(params: Dict, cfg: LlamaConfig, only=None):
    """Serving-time 4-bit -> int8 repack: every QLinearWeight leaf becomes
    the LLM.int8 dict ``{"CB", "SCB"}`` of its dequantized weight (one int8
    grid per output row), with the matching config (quant="int8",
    threshold 0: no outlier decomposition). ``only``: the set of key names
    to repack (e.g. the FFN projections and lm_head); the rest stay 4-bit.
    Stacked MoE experts (3-D) stay 4-bit, as in the JAX package. Returns
    (params8, cfg8); the input tree is not changed."""
    def walk(obj, name=None):
        if isinstance(obj, QLinearWeight):
            if obj.packed.dim() != 2 or (only is not None and name not in only):
                return obj
            CB, SCB = F.int8_vectorwise_quant(obj.dequantize().float())
            return {"CB": CB, "SCB": SCB}
        if isinstance(obj, dict):
            return {k: walk(v, k) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v, name) for v in obj]
        return obj

    return walk(params), dataclasses.replace(cfg, quant="int8", llm_int8_threshold=0.0)


def linear_route(rows: int, w: QLinearWeight, cfg: LlamaConfig) -> str:
    """The JAX package's apply_linear routing by padded row count:
    "w4a8", "grouped", "w8a8" or "exact"."""
    lim = 256 if w.blocksize >= 256 else 128
    a8 = getattr(cfg, "a8_decode", False)
    if a8 and 0 < rows <= lim and w.quant_type != "int4":
        return "w4a8"
    if a8 and rows > grouped_min_m(w.blocksize) and (
            w.blocksize >= 128 or rows < W8A8_PREFILL_MIN_M):
        return "grouped"
    if a8 and rows >= W8A8_PREFILL_MIN_M:
        return "w8a8"
    return "exact"


def _lora_for(lora, li: int, name: str):
    if lora is None:
        return None
    return lora[li].get(name)


def _apply_lora(x: torch.Tensor, out: torch.Tensor, lora: Dict, lora_ids) -> torch.Tensor:
    """Add the adapter delta (x @ A^T) @ B^T * scale in f32, cast to out's
    dtype. Single adapter: A (r, K), B (N, r). Batched: A (n, r, K), B (n,
    N, r), scale (n,), with per-row ``lora_ids`` ((B, T) constant along T,
    or one id per row of a 2-D x), gathered per sequence."""
    xf = x.float()
    if lora["A"].dim() == 2:
        xa = torch.matmul(xf, lora["A"].float().T)
        delta = torch.matmul(xa, lora["B"].float().T) * lora["scale"]
        return out + delta.to(out.dtype)
    ids = lora_ids if lora_ids is not None else torch.zeros(
        x.shape[:-1], dtype=torch.long, device=x.device)
    if x.dim() == 3:
        idb = ids[:, 0].long()
        A_sel = lora["A"].float()[idb]  # (B, r, K)
        B_sel = lora["B"].float()[idb]  # (B, N, r)
        s_sel = lora["scale"].float().reshape(-1)[idb]
        xa = torch.einsum("btk,brk->btr", xf, A_sel)
        delta = torch.einsum("btr,bnr->btn", xa, B_sel) * s_sel[:, None, None]
        return out + delta.to(out.dtype)
    lead = x.shape[:-1]
    idr = ids.reshape(-1).long()
    A_sel = lora["A"].float()[idr]  # (rows, r, K)
    B_sel = lora["B"].float()[idr]  # (rows, N, r)
    s_sel = lora["scale"].float().reshape(-1)[idr]
    xa = torch.einsum("bk,brk->br", xf.reshape(-1, x.shape[-1]), A_sel)
    delta = torch.einsum("br,bnr->bn", xa, B_sel) * s_sel[:, None]
    return out + delta.reshape(*lead, -1).to(out.dtype)


def apply_linear(x: torch.Tensor, w, cfg: LlamaConfig, lora=None, lora_ids=None) -> torch.Tensor:
    if isinstance(w, QLinearWeight):
        route = linear_route(int(np.prod(x.shape[:-1])), w, cfg)
        if route == "w4a8":
            out = matmul_4bit_w4a8(x, w, out_dtype=cfg.dtype)
        elif route == "grouped":
            out = matmul_4bit_w4a8_grouped(x, w, out_dtype=cfg.dtype)
        elif route == "w8a8":
            out = matmul_4bit_w8a8_prefill(x, w, out_dtype=cfg.dtype)
        else:
            out = matmul_4bit_fused(x, w, compute_dtype=cfg.dtype)
    elif isinstance(w, dict):
        # the same forward; with a graph, autograd's full-precision backward
        mm8 = matmul_8bit_lt if differentiable(x, None) else F.llm_int8_matmul
        out = mm8(x, w["CB"], w["SCB"], cfg.llm_int8_threshold, outliers=w.get("outliers"))
    else:
        out = (x.float() @ w.float().T).to(cfg.dtype)
    if lora is not None:
        # frozen quantized base + trainable low-rank delta
        out = _apply_lora(x, out, lora, lora_ids)
    return out


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _fp_layer_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, int]]:
    h, i = cfg.hidden_size, cfg.intermediate_size
    qd = cfg.num_heads * cfg.hd
    kvd = cfg.num_kv_heads * cfg.hd
    return {
        "q_proj": (qd, h),
        "k_proj": (kvd, h),
        "v_proj": (kvd, h),
        "o_proj": (h, qd),
        "gate_proj": (i, h),
        "up_proj": (i, h),
        "down_proj": (h, i),
    }


@torch.no_grad()
def init_params(cfg: LlamaConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from a seeded torch.Generator on ``device``, scaled
    as the JAX package's init_params (1/sqrt(K); embed and lm_head 0.02),
    quantized one weight at a time on that device; with ``num_experts > 1``
    a router and the experts' stacked weights take the dense MLP's place."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def dense(shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[1]))
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    ones = lambda: torch.ones((cfg.hidden_size,), dtype=torch.float32, device=dev)  # noqa: E731
    moe = getattr(cfg, "num_experts", 1) > 1
    layers = []
    for _ in range(cfg.num_layers):
        shapes = _fp_layer_shapes(cfg)
        if moe:  # the dense MLP is replaced by the router and the stacked experts
            mlp_shapes = {n: shapes.pop(n) for n in ("gate_proj", "up_proj", "down_proj")}
        layer = {name: _quantize_linear(dense(shape), cfg) for name, shape in shapes.items()}
        if moe:
            layer["router"] = dense((cfg.num_experts, cfg.hidden_size))
            layer["experts"] = stack_experts([
                {n: _quantize_linear(dense(sh), cfg) for n, sh in mlp_shapes.items()}
                for _ in range(cfg.num_experts)])
        layer["input_norm"] = ones()
        layer["post_attn_norm"] = ones()
        if cfg.sandwich_norms:
            layer["attn_out_norm"] = ones()
            layer["ffn_out_norm"] = ones()
        if cfg.attn_bias:
            for b, name in (("q_bias", "q_proj"), ("k_bias", "k_proj"), ("v_bias", "v_proj")):
                layer[b] = dense((shapes[name][0],), 0.02)
        layers.append(layer)
    params = {
        "embed": dense((cfg.vocab_size, cfg.hidden_size), 0.02).to(cfg.dtype),
        "layers": layers,
        "final_norm": ones(),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _quantize_linear(dense((cfg.vocab_size, cfg.hidden_size), 0.02), cfg)
    return params


@torch.no_grad()
def quantize_params(fp_params: Dict, cfg: LlamaConfig) -> Dict:
    """Quantize a full-precision param dict (2D projections) into cfg.quant."""
    out = {
        "embed": fp_params["embed"].to(cfg.dtype),
        "final_norm": fp_params["final_norm"],
        "layers": [],
    }
    for layer in fp_params["layers"]:
        q = {}
        for name, w in layer.items():
            if name.endswith("_proj"):
                q[name] = _quantize_linear(w.float(), cfg)
            elif name == "experts":
                # stacked ({name: (E, n, k)}) or a per-expert list: quantize
                # each expert's weights and restack
                per_expert = list(w) if isinstance(w, (list, tuple)) else [
                    {n2: w2[e] for n2, w2 in w.items()}
                    for e in range(next(iter(w.values())).shape[0])]
                q[name] = stack_experts([
                    {n2: _quantize_linear(w2.float(), cfg) for n2, w2 in ex.items()}
                    for ex in per_expert])
            else:
                q[name] = w  # norms, biases, the router
        out["layers"].append(q)
    if "lm_head" in fp_params:
        out["lm_head"] = _quantize_linear(fp_params["lm_head"].float(), cfg)
    return out


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg, batch: int, device=None) -> Dict:
    """Contiguous int8 cache: K (L, B, H, D, S) transposed, V (L, B, H, S, D),
    scales (L, B, H, S); with ``kv_quant=False`` the bf16 cache, K and V
    both (L, B, H, S, D) in ``cfg.dtype`` and no scales."""
    dev = resolve_device(device)
    L, B, S, H, D = cfg.num_layers, batch, cfg.max_seq_len, cfg.num_kv_heads, cfg.hd
    if not cfg.kv_quant:
        return {
            "k": torch.zeros((L, B, H, S, D), dtype=cfg.dtype, device=dev),
            "v": torch.zeros((L, B, H, S, D), dtype=cfg.dtype, device=dev),
        }
    return {
        "k": torch.zeros((L, B, H, D, S), dtype=torch.int8, device=dev),
        "v": torch.zeros((L, B, H, S, D), dtype=torch.int8, device=dev),
        "k_scale": torch.zeros((L, B, H, S), dtype=torch.float32, device=dev),
        "v_scale": torch.zeros((L, B, H, S), dtype=torch.float32, device=dev),
    }


_LEVELS: Dict = {}


def _levels(levels: float, device) -> torch.Tensor:
    """``levels`` as an f32 tensor on ``device``, one per device and level:
    PyTorch computes a Python scalar over a tensor (or a tensor over a
    scalar, on CUDA) through a rounded reciprocal, which rounds twice, so
    the KV codecs divide by this tensor."""
    key = (str(device), levels)
    lv = _LEVELS.get(key)
    if lv is None:
        lv = _LEVELS[key] = torch.tensor(levels, dtype=torch.float32, device=device)
    return lv


def _kv_quantize(x: torch.Tensor, levels: float = 127.0):
    """(B, T, H, D) -> int8 codes on the +-levels grid and the per-(token,
    head) absmax (stored as is; the codes take levels / absmax, divided
    by a tensor)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, _levels(levels, xf.device) / absmax, torch.zeros_like(absmax))
    q = torch.clamp(torch.round(xf * scale[..., None]), -levels, levels)
    return q.to(torch.int8), absmax


def _kv_dequantize(q: torch.Tensor, absmax: torch.Tensor, dtype, levels: float = 127.0):
    """int8 codes (..., D) and their absmax (...) -> values in ``dtype``:
    codes times absmax / levels in f32, rounded once to ``dtype``."""
    return (q.float() * (absmax / _levels(levels, absmax.device))[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _mlp_act(cfg, gate_f32: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "gelu_tanh":
        return Fnn.gelu(gate_f32, approximate="tanh")
    return Fnn.silu(gate_f32)


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float, offset: bool = False) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    wf = w.float() + 1.0 if offset else w
    return (xf * torch.rsqrt(var + eps) * wf).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, llama convention (half split). x: (B, T, H, D)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _sm_scale(cfg) -> Optional[float]:
    qs = getattr(cfg, "query_scale", None)
    return None if qs is None else float(qs) ** -0.5


def _attention(q, k, v, mask, dtype, sm_scale=None, softcap=None, bias=None):
    """q: (B, T, Hq, D); k, v: (B, S, Hkv, D); mask (B, T, S); bias (B, Hq,
    T, S) added to the scaled scores before the softcap and the mask
    (ALiBi)."""
    D = q.shape[-1]
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq != Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    scores = scores * (sm_scale if sm_scale is not None else 1.0 / np.sqrt(D))
    if bias is not None:
        scores = scores + bias
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(mask[:, None, :, :], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(dtype)


# ---------------------------------------------------------------------------
# ALiBi (BLOOM)
# ---------------------------------------------------------------------------


def alibi_slopes(n: int) -> np.ndarray:
    """ALiBi per-head slopes (Press et al., arxiv 2108.12409): the
    geometric sequence 2^(-8/n), with the paper's interpolation for head
    counts that are not powers of two (HF BloomModel.build_alibi); the JAX
    package's values bit for bit."""
    def pow2(m):
        start = 2.0 ** (-(2.0 ** -(math.log2(m) - 3)))
        return [start * start ** i for i in range(m)]

    if math.log2(n).is_integer():
        return np.asarray(pow2(n), np.float32)
    closest = 2 ** int(math.floor(math.log2(n)))
    return np.asarray(pow2(closest) + pow2(2 * closest)[0::2][: n - closest], np.float32)


_SLOPES: Dict = {}


def _alibi_slopes_local(cfg, device) -> Optional[torch.Tensor]:
    """(Hq,) f32 ALiBi slopes of an ALiBi config on ``device`` (one copy per
    device and head block), or None. Without tensor parallelism the slopes
    are those of ``cfg.num_heads``. Under it the slope sequence is global
    while ``cfg.num_heads`` is the rank's head count: ``opt_forward_tp``
    sets ``alibi_total_heads`` and ``alibi_axis`` (the process group of the
    tensor-parallel dim), and rank r takes the block [r * Hq, (r + 1) * Hq)
    of its heads (row-block sharded projections own those heads)."""
    if not getattr(cfg, "alibi", False):
        return None
    total = getattr(cfg, "alibi_total_heads", None) or cfg.num_heads
    group = getattr(cfg, "alibi_axis", None)
    off = 0
    if group is not None:
        import torch.distributed as dist

        off = dist.get_rank(group) * cfg.num_heads
    key = (str(device), total, off, cfg.num_heads)
    t = _SLOPES.get(key)
    if t is None:
        t = _SLOPES[key] = torch.from_numpy(
            alibi_slopes(total)[off: off + cfg.num_heads].copy()).to(device)
    return t


def _alibi_bias(cfg, positions: torch.Tensor, S: int) -> torch.Tensor:
    """(B, Hq, T, S) additive score bias -slope_h * (q_pos - k_pos) at
    absolute positions (k_pos > q_pos is masked anyway); equal after the
    softmax to HF Bloom's slope * k_pos form."""
    slopes = _alibi_slopes_local(cfg, positions.device)
    dist = positions.long()[:, None, :, None] - torch.arange(S, device=positions.device)
    return -slopes[None, :, None, None] * dist.float()


# ---------------------------------------------------------------------------
# mixture of experts (Mixtral)
# ---------------------------------------------------------------------------


def _tree_stack(xs):
    x0 = xs[0]
    if isinstance(x0, QLinearWeight):
        st = lambda name: (None if getattr(x0, name) is None  # noqa: E731
                           else torch.stack([getattr(x, name) for x in xs]))
        return dataclasses.replace(x0, packed=st("packed"), absmax=st("absmax"),
                                   absmax_scale=st("absmax_scale"),
                                   absmax_offset=st("absmax_offset"))
    if isinstance(x0, dict):
        return {k: _tree_stack([x[k] for x in xs]) for k in x0}
    return torch.stack(xs)


def stack_experts(expert_list: list):
    """Per-expert weight dicts (quantized or full-precision linears) ->
    one dict whose tensors carry a leading expert dimension E, the layout
    of a MoE layer's ``experts``; a QLinearWeight's ``shape`` still
    describes one expert."""
    return _tree_stack(list(expert_list))


def _expert_slice(experts, e: int):
    """Expert e of the stacked weights: views, never copies (a slice of a
    contiguous stack is contiguous), which kernels A, B and G take as they
    are."""
    if isinstance(experts, QLinearWeight):
        sl = lambda t: None if t is None else t[e]  # noqa: E731
        return dataclasses.replace(experts, packed=experts.packed[e], absmax=experts.absmax[e],
                                   absmax_scale=sl(experts.absmax_scale),
                                   absmax_offset=sl(experts.absmax_offset))
    if isinstance(experts, dict):
        return {k: _expert_slice(v, e) for k, v in experts.items()}
    return experts[e]


def _expert_ffn(x, ex, cfg):
    gate = apply_linear(x, ex["gate_proj"], cfg)
    up = apply_linear(x, ex["up_proj"], cfg)
    return apply_linear(_mlp_act(cfg, gate.float()).to(cfg.dtype) * up, ex["down_proj"], cfg)


def _moe_ffn(h: torch.Tensor, layer: Dict, cfg, psum_axis=None) -> torch.Tensor:
    """Top-k routed mixture-of-experts FFN (HF MixtralSparseMoeBlock): the
    router in f32, softmax over all E experts, the top k, renormalized.
    Dense combine: every expert runs on every token and the router weight
    (0 for an expert not chosen) scales its output, in f32; from
    ``moe_dispatch_min_tokens`` tokens, capacity-bounded dispatch.

    Expert parallelism (``psum_axis``, the process group of the dim the
    stacked experts are sharded on): the router stays replicated, so the
    routing is global, and rank r combines only its E_local experts
    [r * E_local, (r + 1) * E_local) with their slice of the combine
    weights; the caller sums the partial outputs over the group."""
    router = layer["router"]
    E = router.shape[0]
    k = cfg.num_experts_per_tok
    probs = torch.softmax(torch.matmul(h.float(), router.float().T), dim=-1)  # (..., E)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    w_full = torch.zeros_like(probs).scatter(-1, topi, topw)
    experts = layer["experts"]
    e_local = _stacked_leaf(experts).shape[0]
    if psum_axis is not None:
        import torch.distributed as dist

        e0 = dist.get_rank(psum_axis) * e_local
        w_full = w_full[..., e0: e0 + e_local]
    n_tok = int(np.prod(h.shape[:-1]))
    min_disp = getattr(cfg, "moe_dispatch_min_tokens", 0)
    if min_disp and n_tok >= min_disp:
        return _moe_dispatch(h, experts, w_full, cfg, E)
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e in range(e_local):
        d = _expert_ffn(h, _expert_slice(experts, e), cfg)
        out = out + w_full[..., e:e + 1] * d.float()
    return out.to(cfg.dtype)


def _stacked_leaf(experts) -> torch.Tensor:
    """A tensor of the stacked experts (its leading dim counts them)."""
    while not isinstance(experts, torch.Tensor):
        experts = experts.packed if isinstance(experts, QLinearWeight) else \
            next(iter(experts.values()))
    return experts


def _moe_dispatch(h: torch.Tensor, experts, w: torch.Tensor, cfg, e_global: int) -> torch.Tensor:
    """Capacity-bounded dispatch (GShard, arxiv 2006.16668): expert e runs
    on a buffer of C token slots, token n in slot pos[n, e] = (the tokens
    before it that chose e), kept while pos < C; an expert's overflowing
    tokens are dropped for that expert (their weight is missing from the
    sum), the same tokens as in the JAX package's cumsum. C = ceil(cf * N
    * k / E_global), rounded up to 8, at least 8 and at most N; ``w`` holds
    the combine weights of this rank's experts."""
    lead, hd = h.shape[:-1], h.shape[-1]
    n = int(np.prod(lead))
    E = w.shape[-1]
    cf = getattr(cfg, "moe_capacity_factor", 2.0)
    cap = int(np.ceil(cf * n * cfg.num_experts_per_tok / e_global))
    cap = min(n, max(8, -(-cap // 8) * 8))
    x = h.reshape(n, hd)
    wn = w.reshape(n, E)
    chosen = wn > 0.0
    pos = torch.cumsum(chosen.long(), dim=0) - 1  # slot within the expert
    keep = chosen & (pos < cap)
    slot = torch.where(keep, pos, torch.full_like(pos, cap))  # dropped: a spare slot
    out = torch.zeros((n, hd), dtype=torch.float32, device=h.device)
    for e in range(E):
        xs = torch.zeros((cap + 1, hd), dtype=x.dtype, device=x.device)
        xs.index_copy_(0, slot[:, e], x)  # the spare slot takes any dropped row
        ys = _expert_ffn(xs[:cap], _expert_slice(experts, e), cfg)
        got = ys.float()[slot[:, e].clamp(max=cap - 1)]
        out = out + torch.where(keep[:, e:e + 1], wn[:, e:e + 1] * got, torch.zeros_like(got))
    return out.reshape(*lead, hd).to(cfg.dtype)


# ---------------------------------------------------------------------------
# cached attention
# ---------------------------------------------------------------------------


def _paged_write_and_attend(cache: Dict, li: int, q, k, v, positions, cfg):
    """Decode step over the paged pool: write this layer's quantized token
    at (write_page, write_off), then attend with lengths = positions (the
    pool tokens before this one) and the token folded in as new_kv. A kv4
    pool (uint8 pages) takes the token on the +-7 grid: an even offset
    writes its nibble high in a fresh byte, an odd one beside the high
    nibble the byte already holds (the step before's token), and its
    scales go to column (off % 2) * P/2 + off // 2. The JAX package builds
    the odd byte from a staged copy of that nibble instead of reading the
    pool; the bytes agree wherever a slot's tokens are its own (not on the
    trash page 0, which retired rows share).

    Where kernel D's JAX counterpart declines the shapes
    (``paged_attention_ok``: D or P not a multiple of 128), the row's pages
    are gathered, dequantized (kv4 unpacked) and made seq-major, the
    token's own quantize-dequantize round trip appended as column S + 1
    (distance 0), and q attends through ``_attention`` under the length,
    window and ALiBi masks, as the JAX package does; the choice is made by
    the shapes before any launch and counted in
    ``write_and_attend.paged_dequant_calls``."""
    from ..ops.paged_attention import (kv4_scales_logical, kv4_unpack, nib_sign_mag,
                                       paged_decode_attention_int8_stacked)

    kv4 = cache["v"].dtype == torch.uint8
    levels = 7.0 if kv4 else 127.0
    kq, ks = _kv_quantize(k, levels)
    vq, vs = _kv_quantize(v, levels)
    pages, offs = cache["write_page"].long(), cache["write_off"].long()
    if kv4:
        parity, row = offs % 2, offs // 2
        odd = (parity == 1)[:, None, None]
        for leaf, codes in (("k", kq), ("v", vq)):
            nib = nib_sign_mag(codes[:, 0])  # (B, H, D)
            held = cache[leaf][li, pages, :, row]
            cache[leaf][li, pages, :, row] = torch.where(odd, (held & 0xF0) | nib, nib << 4)
        offs = parity * (cache["v_scale"].shape[3] // 2) + row
    else:
        cache["k"][li, pages, :, offs] = kq[:, 0]
        cache["v"][li, pages, :, offs] = vq[:, 0]
    cache["k_scale"][li, pages, :, offs] = ks[:, 0]
    cache["v_scale"][li, pages, :, offs] = vs[:, 0]
    window = getattr(cfg, "sliding_window", None)
    softcap = getattr(cfg, "attn_logit_softcap", None)
    if kernel_attends(cache, cfg, q.shape[1], q.shape[2]):
        attn = paged_decode_attention_int8_stacked(
            q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], li,
            cache["page_table"], positions[:, 0], new_kv=(kq[:, 0], ks[:, 0], vq[:, 0], vs[:, 0]),
            window=window, softcap=softcap, sm_scale=_sm_scale(cfg),
            pages_hint=getattr(cfg, "pages_hint", None),
            alibi_slopes=_alibi_slopes_local(cfg, q.device),
        )
        return attn, cache
    # the gather route: layer li's pages of each row, seq-major
    pt = cache["page_table"].long()
    B, MAXP = pt.shape
    kg, vg = cache["k"][li][pt], cache["v"][li][pt]  # (B, MAXP, H, rows, D)
    ksg, vsg = cache["k_scale"][li][pt], cache["v_scale"][li][pt]  # (B, MAXP, H, P)
    if kv4:
        kg, vg = kv4_unpack(kg), kv4_unpack(vg)
        ksg, vsg = kv4_scales_logical(ksg), kv4_scales_logical(vsg)
    H, P, D = kg.shape[2], kg.shape[3], kg.shape[4]
    S = MAXP * P
    k_full = _kv_dequantize(kg.permute(0, 1, 3, 2, 4).reshape(B, S, H, D),
                            ksg.permute(0, 1, 3, 2).reshape(B, S, H), cfg.dtype, levels)
    v_full = _kv_dequantize(vg.permute(0, 1, 3, 2, 4).reshape(B, S, H, D),
                            vsg.permute(0, 1, 3, 2).reshape(B, S, H), cfg.dtype, levels)
    k_full = torch.cat([k_full, _kv_dequantize(kq, ks, cfg.dtype, levels)], dim=1)
    v_full = torch.cat([v_full, _kv_dequantize(vq, vs, cfg.dtype, levels)], dim=1)
    s_ids = torch.arange(S, device=q.device)[None, None, :]
    qp = positions.long()[:, :, None]
    mask = s_ids < qp
    if window is not None:
        mask = mask & (qp - s_ids < window)
    mask = torch.cat([mask, torch.ones((B, q.shape[1], 1), dtype=torch.bool, device=q.device)],
                     dim=2)  # the token itself: always valid
    bias = None
    if getattr(cfg, "alibi", False):
        # pool order is token order; the appended token sits at the query's position
        kpos = torch.cat([torch.arange(S, device=q.device).expand(B, S), positions[:, 0:1].long()],
                         dim=1)
        dist = positions.long()[:, None, :, None] - kpos[:, None, None, :]
        bias = -_alibi_slopes_local(cfg, q.device)[None, :, None, None] * dist.float()
    write_and_attend.paged_dequant_calls += 1
    return _attention(q, k_full, v_full, mask, cfg.dtype, sm_scale=_sm_scale(cfg),
                      softcap=softcap, bias=bias), cache


def _cache_mask(positions: torch.Tensor, S: int, window: Optional[int]) -> torch.Tensor:
    """(B, T, S) mask of a cached forward: query t may attend cache slot s
    iff s <= its absolute position, and (sliding window) lies less than
    ``window`` positions behind it."""
    s_ids = torch.arange(S, device=positions.device)[None, None, :]
    q_pos = positions.long()[:, :, None]
    mask = s_ids <= q_pos
    if window is not None:
        mask = mask & (q_pos - s_ids < window)
    return mask


def kernel_attends(cache: Dict, cfg, T: int, Hq: int) -> bool:
    """Whether layer attention of a cached forward of T rows runs on a
    kernel: the paged pool where the JAX package's paged kernel takes the
    shapes (``paged_attention_ok``), the int8 cache where its decode (T =
    1) or prefill kernel does, the bf16 cache never. Otherwise
    ``write_and_attend`` takes a dequantize-then-attend route
    (``_attention``), chosen by these shapes before any launch."""
    if "page_table" in cache:
        from ..ops.paged_attention import paged_attention_ok

        Hkv, rows, D = cache["v"].shape[2], cache["v"].shape[3], cache["v"].shape[4]
        return paged_attention_ok(T, D, Hq, Hkv, cache["v_scale"].shape[3], rows)
    if not cfg.kv_quant:
        return False
    from ..ops.attention import decode_attention_ok, prefill_attention_ok

    Hkv, S, D = cache["v"].shape[2], cache["v"].shape[3], cache["v"].shape[4]
    ok = decode_attention_ok if T == 1 else prefill_attention_ok
    return ok(T, S, D, Hq, Hkv)


def write_and_attend(cache: Dict, li: int, q, k, v, positions, cfg, mask=None):
    """Write this step's k/v into layer li of the cache and attend q over
    it: the paged decode step, or the contiguous decode step or prefill.
    Returns (attn (B, T, Hq, hd), cache); the cache is updated in place.
    The int8 cache attends on kernels C and H where they take the shapes
    (``kernel_attends``); elsewhere, and over the bf16 cache, q attends
    through ``_attention`` over layer li alone, made seq-major (and
    dequantized to ``cfg.dtype`` from int8), under ``mask`` (B, T, S), the
    absolute-position mask, built here when not given, and the ALiBi bias
    of an ALiBi config. The JAX package takes the same routes.
    ``write_and_attend.dequant_calls``, ``.bf16_calls`` and
    ``.paged_dequant_calls`` count the calls of the three ``_attention``
    routes (int8 cache, bf16 cache, paged pool)."""
    from ..ops.attention import decode_attention_int8_stacked, prefill_attention_int8_stacked

    starts = positions[:, 0]
    B, T, Hq = q.shape[:3]
    if "page_table" in cache:
        if T != 1:
            raise ValueError("paged KV cache supports decode (T=1) steps only")
        if not cfg.kv_quant:
            raise ValueError("paged KV cache requires kv_quant=True (int8 pages)")
        return _paged_write_and_attend(cache, li, q, k, v, positions, cfg)
    window = getattr(cfg, "sliding_window", None)
    softcap = getattr(cfg, "attn_logit_softcap", None)
    S = cache["v"].shape[3]
    # rows land at [start, start + T), the start clamped into the cache as
    # the JAX package's dynamic_update_slice clamps it
    pos = starts.long().clamp(0, S - T)[:, None] + torch.arange(T, device=q.device)[None, :]
    bi = torch.arange(B, device=q.device)[:, None].expand(B, T)
    if not cfg.kv_quant:
        cache["k"][li][bi, :, pos, :] = k.to(cache["k"].dtype)  # (B, T, H, D) into (B, H, S, D)
        cache["v"][li][bi, :, pos, :] = v.to(cache["v"].dtype)
        k_full, v_full = cache["k"][li].transpose(1, 2), cache["v"][li].transpose(1, 2)
        write_and_attend.bf16_calls += 1
    else:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        cache["k"][li][bi, :, :, pos] = kq  # (B, T, H, D) into (B, H, D, S)
        cache["v"][li][bi, :, pos, :] = vq
        cache["k_scale"][li][bi, :, pos] = ks
        cache["v_scale"][li][bi, :, pos] = vs
        # the kernels take the stacked cache and the layer index: a per-layer
        # copy of the cache would move ~2.2 GB per 7B decode step at B = 8
        if kernel_attends(cache, cfg, T, Hq):
            slopes = _alibi_slopes_local(cfg, q.device)
            if T == 1:
                # the step's token is written: attend over the positions
                # before it with the token folded in, as the JAX package's
                # deferred write
                attn = decode_attention_int8_stacked(
                    q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], li, starts,
                    new_kv=(kq[:, 0], ks[:, 0], vq[:, 0], vs[:, 0]), window=window,
                    softcap=softcap, sm_scale=_sm_scale(cfg), alibi_slopes=slopes,
                )
            else:
                attn = prefill_attention_int8_stacked(
                    q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], li,
                    starts=starts, window=window, softcap=softcap, sm_scale=_sm_scale(cfg),
                    alibi_slopes=slopes,
                )
            return attn, cache
        # the shapes the kernels decline: dequantize layer li alone (never
        # the stacked cache) and make it seq-major
        k_full = _kv_dequantize(cache["k"][li].transpose(-1, -2), cache["k_scale"][li],
                                cfg.dtype).transpose(1, 2)
        v_full = _kv_dequantize(cache["v"][li], cache["v_scale"][li], cfg.dtype).transpose(1, 2)
        write_and_attend.dequant_calls += 1
    if mask is None:
        mask = _cache_mask(positions, S, window)
    bias = _alibi_bias(cfg, positions, S) if getattr(cfg, "alibi", False) else None
    attn = _attention(q, k_full, v_full, mask, cfg.dtype, sm_scale=_sm_scale(cfg),
                      softcap=softcap, bias=bias)
    return attn, cache


# calls of the dequantize-then-attend routes: the int8 cache's, the bf16
# cache's and the paged pool's gather route
write_and_attend.dequant_calls = 0
write_and_attend.bf16_calls = 0
write_and_attend.paged_dequant_calls = 0


def llama_forward(
    params: Dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # (B, T)
    cache: Optional[Dict] = None,
    positions: Optional[torch.Tensor] = None,  # (B, T) absolute positions
    seq_lens: Optional[torch.Tensor] = None,  # unused, as in the JAX package
    psum_axis=None,
    lora: Optional[list] = None,
    lora_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (logits (B, T, vocab) f32, cache). With a cache, the cache
    dict is updated in place and returned. ``lora``: per-layer adapters
    (``models/lora.init_lora``), or batched ones (``stack_lora``) with
    per-sequence ``lora_ids`` (B,).

    ``psum_axis``: the ``torch.distributed`` process group of the
    tensor-parallel dim (the JAX package takes the mesh axis name), for a
    rank's local shard of the params (``parallel.shard_llama_params``) and
    of the cache, under the rank's local config (``parallel.llama_tp``):
    the row-parallel o_proj and down_proj partial sums, and the
    expert-parallel MoE block's, are all-reduced once each per layer."""
    if psum_axis is not None:
        from ..parallel.mesh import psum
    B, T = tokens.shape
    dev = tokens.device
    ids_bt = None if lora_ids is None else lora_ids.reshape(B, 1).expand(B, T)
    if positions is None:
        positions = torch.arange(T, device=dev).expand(B, T)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(np.sqrt(cfg.hidden_size), dtype=cfg.dtype, device=dev)
    norm_off = cfg.norm_offset
    use_cache = cache is not None
    sw = cfg.sliding_window
    alternating = cfg.sliding_alternating and sw is not None
    mask = mask_global = None  # the kernels mask by position
    if not use_cache:
        mask = mask_global = torch.tril(
            torch.ones((T, T), dtype=torch.bool, device=dev))[None].expand(B, T, T)
        if sw is not None:
            q_ids = torch.arange(T, device=dev)[:, None]
            mask = mask & ((q_ids - torch.arange(T, device=dev)[None, :]) < sw)[None]
    elif "page_table" not in cache and not kernel_attends(cache, cfg, T, cfg.num_heads):
        # the absolute-position mask of the _attention route, once a forward
        S = cache["v"].shape[3]
        mask = _cache_mask(positions, S, sw)
        mask_global = _cache_mask(positions, S, None) if alternating else mask
    if alternating:
        cfg_global = dataclasses.replace(cfg, sliding_window=None)

    for li, layer in enumerate(params["layers"]):
        lcfg, lmask = cfg, mask
        if alternating and li % 2 == 1:
            lcfg, lmask = cfg_global, mask_global
        h = _rms_norm(x, layer["input_norm"], cfg.rms_eps, norm_off)
        q = apply_linear(h, layer["q_proj"], cfg, _lora_for(lora, li, "q_proj"), ids_bt)
        k = apply_linear(h, layer["k_proj"], cfg, _lora_for(lora, li, "k_proj"), ids_bt)
        v = apply_linear(h, layer["v_proj"], cfg, _lora_for(lora, li, "v_proj"), ids_bt)
        if "q_bias" in layer:
            q = q + layer["q_bias"].to(q.dtype)
            k = k + layer["k_bias"].to(k.dtype)
            v = v + layer["v_bias"].to(v.dtype)
        q = _rope(q.reshape(B, T, cfg.num_heads, cfg.hd), positions, cfg.rope_theta)
        k = _rope(k.reshape(B, T, cfg.num_kv_heads, cfg.hd), positions, cfg.rope_theta)
        v = v.reshape(B, T, cfg.num_kv_heads, cfg.hd)
        if use_cache:
            attn, cache = write_and_attend(cache, li, q, k, v, positions, lcfg, lmask)
        else:
            attn = _attention(q, k, v, lmask, cfg.dtype, sm_scale=_sm_scale(cfg),
                              softcap=cfg.attn_logit_softcap)
        attn = attn.to(cfg.dtype).reshape(B, T, cfg.num_heads * cfg.hd)
        o = apply_linear(attn, layer["o_proj"], cfg, _lora_for(lora, li, "o_proj"), ids_bt)
        if psum_axis is not None:  # row-parallel o_proj partial sums
            o = psum(o, psum_axis)
        if cfg.sandwich_norms:
            o = _rms_norm(o, layer["attn_out_norm"], cfg.rms_eps, norm_off)
        x = x + o
        h = _rms_norm(x, layer["post_attn_norm"], cfg.rms_eps, norm_off)
        if "experts" in layer:  # Mixtral's MoE block (adapters target attention only)
            d = _moe_ffn(h, layer, cfg, psum_axis)
        else:
            gate = apply_linear(h, layer["gate_proj"], cfg, _lora_for(lora, li, "gate_proj"),
                                ids_bt)
            up = apply_linear(h, layer["up_proj"], cfg, _lora_for(lora, li, "up_proj"), ids_bt)
            d = apply_linear(_mlp_act(cfg, gate.float()).to(cfg.dtype) * up, layer["down_proj"],
                             cfg, _lora_for(lora, li, "down_proj"), ids_bt)
        if psum_axis is not None:  # row-parallel / expert-parallel partial sums
            d = psum(d, psum_axis)
        if cfg.sandwich_norms:
            d = _rms_norm(d, layer["ffn_out_norm"], cfg.rms_eps, norm_off)
        x = x + d

    x = _rms_norm(x, params["final_norm"], cfg.rms_eps, norm_off)
    if cfg.tie_embeddings or "lm_head" not in params:
        logits = (x.float() @ params["embed"].to(cfg.dtype).float().T).to(cfg.dtype)
    else:
        logits = apply_linear(x, params["lm_head"], cfg)
    logits = logits.float()
    if cfg.final_logit_softcap is not None:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    return logits, cache
