"""Attention over the contiguous int8 KV cache: causal flash prefill
(kernel C, ``prefill_attn_int8``) and single-token decode (kernel H,
``decode_attn_int8``).

The cache is the JAX package's layer-stacked layout: K transposed
(L, B, Hkv, D, S) int8, V (L, B, Hkv, S, D) int8, per-token absmax scales
(L, B, Hkv, S) f32. Scores are ``(q . k_i8) * k_scale * sm / 127``, then
the ALiBi bias ``slope * (k_pos - q_pos)``, then softcapping, then the mask
``k_pos <= q_pos`` (and ``q_pos - k_pos < window``); V is weighted by
``v_scale / 127``. GQA maps q head h to kv head ``h // (Hq // Hkv)``.

Prefill: query row t of batch b sits at absolute position ``starts[b] + t``.
Decode: positions ``< lengths[b]`` are valid; the query sits at ``len`` when
``new_kv`` (this step's token, folded in last as an exact online-softmax
step) is given, else at ``len - 1``; a row with ``len == 0`` and no
``new_kv`` yields zeros. The kernels take the layer index and never copy a
layer out of the stacked cache.

Kernel C has two bodies (``prefill_plan``): a tensor-core body for bf16 q
(the model's dtype, so every prefill of a served model) at every head_dim
(a cluster of CTAs past 512), and a SIMT body for f32 q and caches that
are not a whole number of key tiles. Kernel H has two too
(``decode_plan``): a split body (flash-decoding at every head_dim, a
cluster of CTAs past 256) and a SIMT body for the other shapes. Both take
any group size ``rep = Hq // Hkv``, a CTA serving
``decode_groups(rep, body)[0]`` q heads of one kv head.

``prefill_kernel_takes`` and ``decode_kernel_takes`` are the wrappers' shape
guards; they accept every shape the JAX predicates (``prefill_attention_ok``,
``decode_attention_ok``) accept.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .common import check_cuda_tensors, scratch_buffer, sm_count, ticket_buffer

__all__ = [
    "prefill_attention_int8", "prefill_attention_int8_stacked", "prefill_attention_ok",
    "prefill_attn_int8", "prefill_kernel_takes", "prefill_plan", "decode_attention_int8",
    "decode_attention_int8_stacked", "decode_attention_ok", "decode_attn_int8",
    "decode_kernel_takes", "decode_groups", "decode_plan", "DecodePlan", "split_cluster",
]

# head dims the SIMT bodies of kernels C and H are built for
KERNEL_HEAD_DIMS = tuple(range(128, 1025, 128))


def prefill_kernel_takes(T: int, S: int, D: int, Hq: int, Hkv: int) -> bool:
    """Kernel C's shape guard: head_dim 128 to 1024 in steps of 128, Hq a
    multiple of Hkv, at least one query row (the wrapper also checks that
    the cache's shapes agree)."""
    return D in KERNEL_HEAD_DIMS and Hkv > 0 and Hq % Hkv == 0 and T >= 1 and S >= 1


def decode_kernel_takes(S: int, D: int, rep: int) -> bool:
    """Kernel H's shape guard: head_dim 128 to 1024 in steps of 128, any
    group size, S a multiple of 4 (the SIMT body reads K four positions a
    word)."""
    return D in KERNEL_HEAD_DIMS and rep >= 1 and S > 0 and S % 4 == 0


def _group_size(rep: int, largest: int) -> int:
    g = 1
    while g < rep and g < largest:
        g *= 2
    return g


def decode_groups(rep: int, body: str):
    """(heads per CTA, groups per kv head) of kernel H's body: rep itself
    for 1, 2 and 4 (and 8 in the SIMT body), else groups of 4 (split) or 8
    (SIMT), the last one padded; the C entry's ``group_size``. Past
    head_dim 512 the SIMT body's C entry caps its groups at 4 heads."""
    g = _group_size(rep, 4 if body == "split" else 8)
    return g, -(-rep // g)


# Kernel C's tensor-core instances: head_dim -> keys per tile (the C
# entry's instances; past 512, where a tile's 64 rows of f32 output no
# longer fit one CTA's registers beside S and P, its cluster instance, a
# CTA per 128 dims).
TC_KEY_TILE = {128: 64, 256: 64, 384: 32, 512: 32, 640: 64, 768: 64, 896: 64, 1024: 64}


def prefill_plan(D: int, S: int, q_dtype) -> str:
    """Kernel C's body: "tc", the tensor-core body (64 query rows per CTA,
    D / 128 warpgroups each owning 128 output dims, key tiles of
    ``TC_KEY_TILE[D]``; past D = 512 a cluster of D / 128 CTAs of one
    warpgroup each), takes bf16 q over a cache of a whole number of key
    tiles, at every prompt length: at B = 4, T = 32 its CTAs fill half
    their rows and it still beat the SIMT body on the H100 (PERF.md).
    "simt", one warp per query row, takes f32 q and the other S."""
    if q_dtype == torch.bfloat16 and D in TC_KEY_TILE and S % TC_KEY_TILE[D] == 0:
        return "tc"
    return "simt"


def _prefill_plain(q, kq, ks, vq, vs, li, starts, scale, window, softcap, alibi):
    """Plain PyTorch version of kernel C (one-shot softmax)."""
    B, T, Hq, D = q.shape
    Hkv, S = vq.shape[2], vq.shape[3]
    rep = Hq // Hkv
    k = kq[li].float().repeat_interleave(rep, dim=1)  # (B, Hq, D, S)
    v = vq[li].float().repeat_interleave(rep, dim=1)  # (B, Hq, S, D)
    ksl = ks[li].float().repeat_interleave(rep, dim=1)[:, :, None, :]  # (B, Hq, 1, S)
    vsl = vs[li].float().repeat_interleave(rep, dim=1)[:, :, None, :]
    qf = q.float().permute(0, 2, 1, 3)  # (B, Hq, T, D)
    sc = (qf @ k) * (ksl * scale)  # (B, Hq, T, S)
    q_pos = (starts.long()[:, None] + torch.arange(T, device=q.device)[None, :])[:, None, :, None]
    k_pos = torch.arange(S, device=q.device)[None, None, None, :]
    if alibi is not None:
        sc = sc + alibi.float()[None, :, None, None] * (k_pos - q_pos).float()
    if softcap is not None:
        sc = softcap * torch.tanh(sc * np.float32(1.0 / softcap))
    valid = k_pos <= q_pos
    if window is not None:
        valid = valid & (q_pos - k_pos < window)
    sc = torch.where(valid, sc, torch.full_like(sc, -1e30))
    m = sc.amax(dim=-1, keepdim=True)
    w = torch.exp(sc - m)
    l = w.sum(dim=-1, keepdim=True)
    acc = (w * (vsl * np.float32(1.0 / 127.0))) @ v
    return (acc / l).permute(0, 2, 1, 3).to(q.dtype)


def prefill_attn_int8(q, kq, ks, vq, vs, li: int, starts, scale: float,
                      window: Optional[int] = None, softcap: Optional[float] = None,
                      alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel C on CUDA tensors; the plain version on CPU tensors.
    q (B, T, Hq, D) f32/bf16 -> (B, T, Hq, D) in q's dtype."""
    if not check_cuda_tensors("prefill_attn_int8", q, kq, ks, vq, vs, starts, alibi):
        return _prefill_plain(q, kq, ks, vq, vs, li, starts, scale, window, softcap, alibi)
    B, T, Hq, D = q.shape
    L, _, Hkv, S = vq.shape[:4]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"prefill_attn_int8: q must be f32/bf16, got {q.dtype}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 or ks.dtype != torch.float32 \
            or vs.dtype != torch.float32:
        raise ValueError("prefill_attn_int8: int8 K/V with f32 scales only")
    if not prefill_kernel_takes(T, S, D, Hq, Hkv) or kq.shape != (L, B, Hkv, D, S) \
            or vq.shape != (L, B, Hkv, S, D):
        raise ValueError(f"prefill_attn_int8: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(kq.shape)} v={tuple(vq.shape)}")
    if not 0 <= li < L:
        raise ValueError(f"prefill_attn_int8: layer {li} out of range [0, {L})")
    return _prefill_launch(q, kq, ks, vq, vs, li, starts, scale, window, softcap, alibi,
                           prefill_plan(D, S, q.dtype))


def _prefill_launch(q, kq, ks, vq, vs, li, starts, scale, window, softcap, alibi,
                    body: str) -> torch.Tensor:
    """Launch kernel C's body ``body`` ("tc" or "simt") on checked CUDA tensors."""
    B, T, Hq, D = q.shape
    L, _, Hkv, S = vq.shape[:4]
    ts = [t.contiguous() for t in (q, kq, ks, vq, vs)]
    st = starts.to(torch.int32).contiguous()
    al = None if alibi is None else alibi.float().contiguous()
    out = torch.empty_like(ts[0])
    ptrs = (*(t.data_ptr() for t in ts), st.data_ptr(), None if al is None else al.data_ptr(),
            out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if body == "tc":
        if ts[0].data_ptr() % 16:
            ts[0] = ts[0].clone()  # a view at an odd offset; q rows are read 16 bytes at a time
            ptrs = (ts[0].data_ptr(),) + ptrs[1:]
        # TMA and the bulk copies read the cache at 16-byte aligned addresses
        assert all(t.data_ptr() % 16 == 0 for t in ts[1:]), "unaligned cache"
        fn = _build.kernel_fn("prefill_attn_int8", "prefill_attn_int8_tc", 20,
                              int_args=range(8, 17), float_args=(17, 18))
        err = fn(*ptrs, int(li), L, B, T, Hq, Hkv, D, S, int(window or 0),
                 float(scale), float(softcap or 0.0), stream)
        prefill_attn_int8.launches_tc += 1
    else:
        fn = _build.kernel_fn("prefill_attn_int8", "prefill_attn_int8", 21,
                              int_args=range(8, 18), float_args=(18, 19))
        err = fn(*ptrs, int(li), L, B, T, Hq, Hkv, D, S, int(window or 0),
                 int(q.dtype == torch.bfloat16), float(scale), float(softcap or 0.0), stream)
    _build.check(f"prefill_attn_int8 ({body})", err)
    prefill_attn_int8.launches += 1
    return out


# launches of either body, and of the tensor-core body alone
prefill_attn_int8.launches = 0
prefill_attn_int8.launches_tc = 0


def prefill_attention_ok(T: int, S: int, D: int, Hq: int, Hkv: int, tq: int = 256,
                         ts: int = 512) -> bool:
    """Whether the JAX package's prefill kernel takes these shapes: D a
    multiple of 128, Hq of Hkv, and T and S tiled by query and key tiles
    of at least 8 and 128 rows (T < 8 never is). Where it is False the
    model attends through its dequantize-then-attend route, as the JAX
    package does, and ``prefill_attention_int8_stacked`` raises."""
    tq = min(tq, T)
    while T % tq != 0 and tq > 8:
        tq //= 2
    ts = min(ts, S)
    while S % ts != 0 and ts >= 256:
        ts //= 2
    return (D % 128 == 0 and Hq % Hkv == 0 and T % tq == 0 and S % ts == 0 and tq >= 8
            and ts >= 128)


def prefill_attention_int8_stacked(
    q: torch.Tensor,  # (B, T, Hq, D)
    kq: torch.Tensor,  # (L, B, Hkv, D, S) int8
    ks: torch.Tensor,  # (L, B, Hkv, S)
    vq: torch.Tensor,  # (L, B, Hkv, S, D) int8
    vs: torch.Tensor,  # (L, B, Hkv, S)
    li: int,
    starts: torch.Tensor,  # (B,) absolute position of query row 0
    tq: int = 256,
    ts: int = 512,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sm_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # (Hq,)
) -> torch.Tensor:
    """Causal flash attention of q over layer ``li`` of the int8 cache,
    (B, T, Hq, D). Raises ValueError on the shapes the JAX kernel declines
    (D not a multiple of 128, Hq not a multiple of Hkv, T or S that its
    tiles cannot cover: ``prefill_attention_ok``); the model attends those
    through its dequantize-then-attend route, as the JAX package does."""
    B, T, Hq, D = q.shape
    Hkv, S = vq.shape[2], vq.shape[3]
    if not prefill_attention_ok(T, S, D, Hq, Hkv, tq, ts):
        raise ValueError(f"prefill_attention_int8_stacked: the kernel does not take "
                         f"T={T}, S={S}, D={D}, Hq={Hq}, Hkv={Hkv}")
    if window is not None and window >= S:
        window = None  # can never bind
    sm = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(D))
    return prefill_attn_int8(q, kq, ks, vq, vs, int(li), starts, sm / 127.0,
                             window=window, softcap=softcap, alibi=alibi_slopes)


def prefill_attention_int8(
    q: torch.Tensor,  # (B, T, Hq, D)
    kq: torch.Tensor,  # (B, Hkv, D, S) int8
    ks: torch.Tensor,  # (B, Hkv, S)
    vq: torch.Tensor,  # (B, Hkv, S, D) int8
    vs: torch.Tensor,  # (B, Hkv, S)
    starts: torch.Tensor,  # (B,) absolute position of query row 0
    tq: int = 256,
    ts: int = 512,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sm_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # (Hq,)
) -> Optional[torch.Tensor]:
    """Single-layer cache form of ``prefill_attention_int8_stacked``: kernel
    C over a one-layer view of the cache (no copy). Returns None where the
    JAX kernel declines the shapes (``prefill_attention_ok``), as the JAX
    package's entry does; its caller then attends another way."""
    B, T, Hq, D = q.shape
    Hkv, S = vq.shape[1], vq.shape[2]
    if not prefill_attention_ok(T, S, D, Hq, Hkv, tq, ts):
        return None
    return prefill_attention_int8_stacked(
        q, kq[None], ks[None], vq[None], vs[None], 0, starts, tq, ts, window=window,
        softcap=softcap, sm_scale=sm_scale, alibi_slopes=alibi_slopes)


# ---------------------------------------------------------------------------
# decode (kernel H)
# ---------------------------------------------------------------------------


def _decode_plain(q4, kq, ks, vq, vs, li, lengths, new_kv, scale, window, softcap, alibi):
    """Plain PyTorch version of kernel H, in the JAX kernel's order
    (one-shot softmax over the whole row)."""
    B, Hkv, rep, D = q4.shape
    S = vq.shape[3]
    qf = q4.float()
    sc = (qf @ kq[li].float()) * (ks[li].float()[:, :, None, :] * scale)  # (B, Hkv, rep, S)
    lens = lengths.long().reshape(B, 1, 1, 1)
    pos = torch.arange(S, device=q4.device).reshape(1, 1, 1, S)
    qpos = lens if new_kv is not None else lens - 1
    if alibi is not None:
        sc = sc + alibi.float().reshape(1, Hkv, rep, 1) * (pos - qpos).float()
    if softcap is not None:
        sc = softcap * torch.tanh(sc * np.float32(1.0 / softcap))
    valid = pos < lens
    if window is not None:
        valid = valid & (pos >= qpos + 1 - window)
    sc = torch.where(valid, sc, torch.full_like(sc, -1e30))
    v = vq[li].float()  # (B, Hkv, S, D)
    vsc = vs[li].float()[:, :, None, :] * np.float32(1.0 / 127.0)
    if new_kv is None:
        m = sc.amax(dim=-1, keepdim=True)
        w = torch.exp(sc - m)
        l = w.sum(dim=-1, keepdim=True)
        inv = torch.where(lens > 0, 1.0 / l, torch.zeros_like(l))
        return ((w * vsc * inv) @ v).to(q4.dtype)
    kn, ksn, vn, vsn = new_kv
    sc_new = (qf * kn.float()[:, :, None, :]).sum(dim=-1, keepdim=True)
    sc_new = sc_new * (ksn.float()[:, :, None, None] * scale)
    if softcap is not None:
        sc_new = softcap * torch.tanh(sc_new * np.float32(1.0 / softcap))
    m = torch.maximum(sc.amax(dim=-1, keepdim=True), sc_new)
    w = torch.exp(sc - m)
    w_new = torch.exp(sc_new - m)
    inv = 1.0 / (w.sum(dim=-1, keepdim=True) + w_new)
    o = (w * vsc * inv) @ v
    vsn_c = vsn.float()[:, :, None, None] * np.float32(1.0 / 127.0)
    return (o + (w_new * inv * vsn_c) * vn.float()[:, :, None, :]).to(q4.dtype)


class DecodePlan(NamedTuple):
    """Kernel H's launch: the body, and for the split body the number of
    CTAs that share each row's used span."""

    body: str  # "split" or "simt"
    nsplit: int


DECODE_TILE = 128  # positions per tile of the split body
# Split CTAs per SM the plan aims at (fitted on the H100: PERF.md,
# chip_smoke.py check_decode): rows are split only to fill SMs that one CTA
# per row and kv head leaves idle.
_DECODE_CTAS_PER_SM = 1


def split_cluster(D: int) -> int:
    """CTAs of kernel H's split body that share one head group's split: past
    head_dim 256 a cluster of D / 128, each holding 128 dims (three
    128-position ring slots of the whole head pass 227 KB there)."""
    return D // 128 if D > 256 else 1


@functools.lru_cache(maxsize=None)
def decode_plan(B: int, Hkv: int, S: int, D: int, rep: int, q_dtype, sms: int) -> DecodePlan:
    """Kernel H's launch on ``sms`` SMs from host-known sizes only (reading
    the lengths would stop the host in every layer of a decode step). The
    split body takes f32 or bf16 q at every head_dim (past 256 as clusters
    of ``split_cluster(D)`` CTAs), any rep but 8 at D = 128 (rep 8 keeps
    the SIMT body there, which reads each position once for all 8 heads;
    at D = 256 two groups of 4 beat it, PERF.md), and S % 16 == 0 (the row
    stride of its TMA copies of K); it splits each head group's used span
    into ``nsplit`` equal shares of 128-position tiles, B * Hkv * groups *
    clusters * nsplit CTAs about _DECODE_CTAS_PER_SM per SM, never more
    splits than the cache has tiles. The SIMT body takes the rest (rep 8
    at D = 128, other S), one CTA per row, kv head and group."""
    if q_dtype in (torch.float32, torch.bfloat16) and not (D == 128 and rep == 8) \
            and S % 16 == 0:
        tiles = -(-S // DECODE_TILE)
        groups = decode_groups(rep, "split")[1]
        per_row = _DECODE_CTAS_PER_SM * sms // (B * Hkv * groups * split_cluster(D))
        return DecodePlan("split", max(1, min(tiles, per_row)))
    return DecodePlan("simt", 1)


def decode_attn_int8(q4, kq, ks, vq, vs, li: int, lengths, scale: float, new_kv=None,
                     window: Optional[int] = None, softcap: Optional[float] = None,
                     alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel H on CUDA tensors; the plain version on CPU tensors.
    q4 (B, Hkv, rep, D) f32/bf16 -> (B, Hkv, rep, D) in q's dtype."""
    extra = () if new_kv is None else tuple(new_kv)
    if not check_cuda_tensors("decode_attn_int8", q4, kq, ks, vq, vs, lengths, alibi, *extra):
        return _decode_plain(q4, kq, ks, vq, vs, li, lengths, new_kv, scale, window, softcap,
                             alibi)
    B, Hkv, rep, D = q4.shape
    L, S = kq.shape[0], kq.shape[4]
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attn_int8: q must be f32/bf16, got {q4.dtype}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 or ks.dtype != torch.float32 \
            or vs.dtype != torch.float32:
        raise ValueError("decode_attn_int8: int8 K/V with f32 scales only")
    if not decode_kernel_takes(S, D, rep) \
            or kq.shape != (L, B, Hkv, D, S) or vq.shape != (L, B, Hkv, S, D) \
            or ks.shape != (L, B, Hkv, S) or vs.shape != ks.shape:
        raise ValueError(f"decode_attn_int8: unsupported shapes q={tuple(q4.shape)} "
                         f"k={tuple(kq.shape)} v={tuple(vq.shape)}")
    if not 0 <= li < L:
        raise ValueError(f"decode_attn_int8: layer {li} out of range [0, {L})")
    return _decode_launch(q4, kq, ks, vq, vs, li, lengths, scale, new_kv, window, softcap, alibi,
                          decode_plan(B, Hkv, S, D, rep, q4.dtype, sm_count(q4.device)))


def _decode_launch(q4, kq, ks, vq, vs, li, lengths, scale, new_kv, window, softcap, alibi,
                   plan: DecodePlan) -> torch.Tensor:
    """Launch kernel H's body ``plan.body`` on checked CUDA tensors."""
    B, Hkv, rep, D = q4.shape
    L, S = kq.shape[0], kq.shape[4]
    qc = q4.contiguous()
    ts = [t.contiguous() for t in (kq, ks, vq, vs)]
    ln = lengths.to(torch.int32).contiguous()
    al = None if alibi is None else alibi.float().contiguous()
    if new_kv is not None:
        kn, ksn, vn, vsn = new_kv
        nk = [kn.to(torch.int8).contiguous(), ksn.float().contiguous(),
              vn.to(torch.int8).contiguous(), vsn.float().contiguous()]
        nk_ptrs = [t.data_ptr() for t in nk]
    else:
        nk_ptrs = [None] * 4
    out = torch.empty_like(qc)
    ptrs = (qc.data_ptr(), *(t.data_ptr() for t in ts), ln.data_ptr(),
            None if al is None else al.data_ptr(), *nk_ptrs, out.data_ptr())
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    q_bf16 = int(q4.dtype == torch.bfloat16)
    if plan.body == "split":
        # TMA and the bulk copies read the cache at 16-byte aligned addresses
        assert all(t.data_ptr() % 16 == 0 for t in ts), "unaligned cache"
        part = tickets = None
        if plan.nsplit > 1:
            g, groups = decode_groups(rep, "split")
            n = split_cluster(D)
            part = scratch_buffer(q4.device, B * Hkv * groups * plan.nsplit * g * (D + 2 * n))
            tickets = ticket_buffer(q4.device, B * Hkv * groups * n)
        fn = _build.kernel_fn("decode_attn_int8", "decode_attn_int8_split", 28,
                              int_args=range(14, 25), float_args=(25, 26))
        err = fn(*ptrs, None if part is None else part.data_ptr(),
                 None if tickets is None else tickets.data_ptr(),
                 int(li), L, B, Hkv, rep, D, S, plan.nsplit, int(window or 0),
                 int(new_kv is not None), q_bf16, float(scale), float(softcap or 0.0), stream)
        decode_attn_int8.launches_split += 1
    else:
        fn = _build.kernel_fn("decode_attn_int8", "decode_attn_int8", 25,
                              int_args=range(12, 22), float_args=(22, 23))
        err = fn(*ptrs, int(li), L, B, Hkv, rep, D, S, int(window or 0),
                 int(new_kv is not None), q_bf16, float(scale), float(softcap or 0.0), stream)
    _build.check(f"decode_attn_int8 ({plan.body})", err)
    decode_attn_int8.launches += 1
    return out


# launches of either body, and of the split body alone
decode_attn_int8.launches = 0
decode_attn_int8.launches_split = 0


def decode_attention_ok(T: int, S: int, D: int, Hq: int, Hkv: int) -> bool:
    """Whether the JAX package's decode kernel takes these shapes: one
    query row, D and S multiples of 128, Hq a multiple of Hkv, and one
    row's K and V within 8 MiB. Where it is False the model attends
    through its dequantize-then-attend route, as the JAX package does, and
    ``decode_attention_int8_stacked`` raises."""
    return (T == 1 and D % 128 == 0 and Hq % Hkv == 0 and S % 128 == 0
            and 2 * S * D <= 8 * 1024 * 1024)


def decode_attention_int8_stacked(
    q: torch.Tensor,  # (B, 1, Hq, D)
    kq: torch.Tensor,  # (L, B, Hkv, D, S) int8
    ks: torch.Tensor,  # (L, B, Hkv, S) f32
    vq: torch.Tensor,  # (L, B, Hkv, S, D) int8
    vs: torch.Tensor,  # (L, B, Hkv, S) f32
    li: int,
    lengths: torch.Tensor,  # (B,) tokens in the cache per row
    new_kv=None,  # optional (kq (B,Hkv,D) i8, ks (B,Hkv) f32, vq, vs)
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sm_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # (Hq,)
) -> torch.Tensor:
    """Single-step attention over layer ``li`` of the stacked cache, (B, 1,
    Hq, D) in q's dtype. Raises ValueError on the shapes the JAX kernel
    declines (T != 1, D or S not a multiple of 128, Hq not a multiple of
    Hkv, K and V of one row over 8 MiB: ``decode_attention_ok``); the model
    attends those through its dequantize-then-attend route, as the JAX
    package does."""
    B, T, Hq, D = q.shape
    Hkv, S = vq.shape[2], vq.shape[3]
    if not decode_attention_ok(T, S, D, Hq, Hkv):
        raise ValueError(f"decode_attention_int8_stacked: the kernel does not take "
                         f"T={T}, S={S}, D={D}, Hq={Hq}, Hkv={Hkv}")
    if window is not None and window >= S:
        window = None  # can never bind
    sm = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(D))
    q4 = q.reshape(B, Hkv, Hq // Hkv, D)
    out = decode_attn_int8(q4, kq, ks, vq, vs, int(li), lengths, sm / 127.0, new_kv=new_kv,
                           window=window, softcap=softcap, alibi=alibi_slopes)
    return out.reshape(B, 1, Hq, D)


def decode_attention_int8(q, kq, ks, vq, vs, lengths, window=None, softcap=None,
                          sm_scale=None, alibi_slopes=None):
    """Single-layer cache (K (B, Hkv, D, S), V (B, Hkv, S, D), scales (B,
    Hkv, S)) form of the stacked wrapper."""
    return decode_attention_int8_stacked(
        q, kq[None], ks[None], vq[None], vs[None], 0, lengths, window=window,
        softcap=softcap, sm_scale=sm_scale, alibi_slopes=alibi_slopes)
