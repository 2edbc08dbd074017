"""Causal flash prefill over the int8 KV cache (kernel C, ``prefill_attn_int8``).

The cache is the JAX package's layer-stacked layout: K transposed
(L, B, Hkv, D, S) int8, V (L, B, Hkv, S, D) int8, per-token absmax scales
(L, B, Hkv, S) f32. Scores are ``(q . k_i8) * k_scale * sm / 127``, then
the ALiBi bias ``slope * (k_pos - q_pos)``, then softcapping, then the mask
``k_pos <= q_pos`` (and ``q_pos - k_pos < window``); V is weighted by
``v_scale / 127``. Query row t of batch b sits at absolute position
``starts[b] + t``; GQA maps q head h to kv head ``h // (Hq // Hkv)``.

The contiguous-cache decode wrappers (``decode_attention_int8[_stacked]``)
come with the contiguous engine in a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from .common import check_cuda_tensors

__all__ = ["prefill_attention_int8_stacked", "prefill_attn_int8"]


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
    if D not in (128, 256) or Hq % Hkv or kq.shape != (L, B, Hkv, D, S) or vq.shape != (L, B, Hkv, S, D):
        raise ValueError(f"prefill_attn_int8: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(kq.shape)} v={tuple(vq.shape)}")
    if not 0 <= li < L:
        raise ValueError(f"prefill_attn_int8: layer {li} out of range [0, {L})")
    ts = [t.contiguous() for t in (q, kq, ks, vq, vs)]
    st = starts.to(torch.int32).contiguous()
    al = None if alibi is None else alibi.float().contiguous()
    out = torch.empty_like(ts[0])
    fn = _build.kernel_fn("prefill_attn_int8", "prefill_attn_int8", 21,
                          int_args=range(8, 18), float_args=(18, 19))
    err = fn(
        *(t.data_ptr() for t in ts), st.data_ptr(), None if al is None else al.data_ptr(),
        out.data_ptr(),
        int(li), L, B, T, Hq, Hkv, D, S, int(window or 0), int(q.dtype == torch.bfloat16),
        float(scale), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("prefill_attn_int8", err)
    prefill_attn_int8.launches += 1
    return out


prefill_attn_int8.launches = 0


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
    tiles cannot cover); the JAX package attends those without the kernel,
    and the port has no such path."""
    B, T, Hq, D = q.shape
    Hkv, S = vq.shape[2], vq.shape[3]
    tq = min(tq, T)
    while T % tq != 0 and tq > 8:
        tq //= 2
    ts = min(ts, S)
    while S % ts != 0 and ts >= 256:
        ts //= 2
    if D % 128 != 0 or Hq % Hkv != 0 or T % tq != 0 or S % ts != 0 or tq < 8 or ts < 128:
        raise ValueError(f"prefill_attention_int8_stacked: the kernel does not take "
                         f"T={T}, S={S}, D={D}, Hq={Hq}, Hkv={Hkv}")
    if window is not None and window >= S:
        window = None  # can never bind
    sm = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(D))
    return prefill_attn_int8(q, kq, ks, vq, vs, int(li), starts, sm / 127.0,
                             window=window, softcap=softcap, alibi=alibi_slopes)

