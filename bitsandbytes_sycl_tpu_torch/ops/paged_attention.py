"""Paged int8-KV decode attention (kernel D, ``paged_attn_int8``).

Single-token attention over the layer-stacked, token-major page pool of
the JAX package: K and V pages (L, NP, Hkv, P, D) int8 with per-token
absmax scales (L, NP, Hkv, P) f32, reached through ``page_table[b, j]``.
Positions are logical (``j * P + col``), valid while ``pos < len[b]``; the
query sits at ``len`` when ``new_kv`` (this step's token, folded in last as
an exact online-softmax step) is given, else at ``len - 1``. A row with
``len == 0`` and no ``new_kv`` yields zeros.

The kernel walks each row's used pages, ``max(ceil(len / P), 1)`` (at most
the table width). ``pages_hint``, a host-known bound on every row's used
pages (the engine's page horizon), only caps how many CTAs share a row: it
never changes the result.

int4 (kv4) pages (``kv_bits=4``): K and V (L, NP, Hkv, P/2, D) uint8, byte
row r holding token 2r in the high nibble and token 2r + 1 in the low one,
sign-magnitude codes on the +-7 grid (``nib_sign_mag``); the per-token f32
scales (L, NP, Hkv, P) sit in parity-grouped column order, token t at
column (t % 2) * P/2 + t // 2 (``engine/paged._scale_cols``). K's factor is
``sm / 7`` and V's ``1 / 7``; ``new_kv`` then carries +-7 codes as int8.

Two bodies (``paged_plan``): the split body spreads a row's pages over
``nsplit`` CTAs and merges their partial softmax states in split order; the
SIMT body walks a row's pages in one CTA, for the shapes the split body
does not take. Both take any group size ``rep = Hq // Hkv``, a CTA serving
``paged_groups(rep, D, body)[0]`` q heads of one kv head.

``paged_attention_ok`` is the JAX kernel's predicate: where it is False the
model gathers the row's pages and attends through its dequantize-then-attend
route, as the JAX package does. ``paged_kernel_takes`` is the wrapper's
shape guard; it accepts every shape the predicate accepts up to head_dim
1024 (no configuration of either package reaches a wider one; ROADMAP
Queue C).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .attention import _group_size
from .common import check_cuda_tensors, scratch_buffer, sm_count, ticket_buffer

__all__ = ["paged_decode_attention_int8", "paged_decode_attention_int8_stacked", "paged_attn_int8",
           "paged_attention_ok", "paged_kernel_takes", "paged_groups", "paged_plan", "PagedPlan",
           "nib_sign_mag", "requant_nib4", "kv4_unpack", "kv4_scales_logical"]


def paged_attention_ok(T: int, D: int, Hq: int, Hkv: int, P: int, page_rows: int) -> bool:
    """Whether the JAX package's paged kernel takes these shapes: one query
    row, D and P multiples of 128, Hq a multiple of Hkv, and int8 pages
    (``page_rows == P``) or kv4 pages (``P // 2`` byte rows)."""
    return (T == 1 and D % 128 == 0 and Hq % Hkv == 0 and P % 128 == 0
            and page_rows in (P, P // 2))


def paged_kernel_takes(D: int, rep: int, P: int) -> bool:
    """Kernel D's shape guard: head_dim a multiple of 128 up to 1024 (the
    SIMT body's threads), any group size, an even page (kv4 byte rows)."""
    return D % 128 == 0 and 0 < D <= 1024 and rep >= 1 and P > 0 and P % 2 == 0


def paged_groups(rep: int, D: int, body: str):
    """(heads per CTA, groups per kv head) of kernel D's body: rep itself
    for 1, 2 and 4 (and 8 in the SIMT body), else the next of those up to
    8 (SIMT) or 4 with heads x D <= 512 (split), the last group padded; the
    C entry's ``group_size``."""
    g = _group_size(rep, 8 if body == "simt" else (4 if D == 128 else 2))
    return g, -(-rep // g)


def nib_sign_mag(c4: torch.Tensor) -> torch.Tensor:
    """+-7-grid codes -> sign-magnitude nibbles ``|c| + 8 * [c < 0]``,
    uint8: the kv4 nibble encoding of the page pool."""
    return torch.where(c4 < 0, 8 - c4, c4).to(torch.uint8)


def requant_nib4(c8: torch.Tensor) -> torch.Tensor:
    """+-127-grid int8 codes -> kv4 nibbles: ``round(c * 7 / 127)`` (half to
    even, in f32) clipped to +-7, then ``nib_sign_mag``; the one-time
    requantization of the int8 prefill scratch into kv4 pages."""
    f = torch.tensor(np.float32(7.0 / 127.0), device=c8.device)
    c4 = torch.clamp(torch.round(c8.to(torch.float32) * f), -7.0, 7.0)
    return nib_sign_mag(c4)


def kv4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """(..., P/2, D) uint8 nibble pairs -> (..., P, D) int8 codes in [-7, 7]
    in token order (byte row r: token 2r high, 2r + 1 low)."""
    def dec(nib):
        n = nib.to(torch.int32)
        return torch.where(n >= 8, 8 - n, n).to(torch.int8)

    pair = torch.stack([dec(packed >> 4), dec(packed & 0xF)], dim=-2)  # (..., P/2, 2, D)
    return pair.reshape(*packed.shape[:-2], -1, packed.shape[-1])


def kv4_scales_logical(s: torch.Tensor) -> torch.Tensor:
    """kv4 scales from parity-grouped column order back to token order."""
    half = s.shape[-1] // 2
    return torch.stack([s[..., :half], s[..., half:]], dim=-1).reshape(*s.shape[:-1], -1)


class PagedPlan(NamedTuple):
    """Kernel D's launch: the body, and for the split body the number of
    CTAs that share each row's used pages."""

    body: str  # "split" or "simt"
    nsplit: int


# Split CTAs per SM the plan aims at. One: a CTA's page loop is bound by
# its own instruction stream, and more CTAs on an SM share its issue slots
# without adding bandwidth. On the H100, whole rows ran fastest at B = 4,
# Hkv = 32, 16 pages, and splitting won at B = 1 and 2, where whole rows
# leave SMs idle (PERF.md, chip_smoke.py check_paged). So rows are split
# only to fill idle SMs (B * Hkv < SMs).
_PAGED_CTAS_PER_SM = 1


def paged_plan(B: int, Hkv: int, MAXP: int, P: int, D: int, rep: int, sms: int,
               pages_hint: Optional[int] = None) -> PagedPlan:
    """Kernel D's launch on ``sms`` SMs, from the page-table width MAXP, or
    the host-known ``pages_hint`` where given, and never from the lengths
    (reading them would stop the host in every layer of a decode step).
    The split body takes D = 128 or 256 and P a multiple of 128 with a
    page-head's K and V (2 * P * D bytes) within one 64 KB slot of its
    2-slot ring, at rep 1, 2 or 4 with rep * D <= 512 (one group: the
    SIMT body keeps rep 8 and rep 4 at D = 256, where it reads each page
    once for all heads) and at every other rep, in groups of
    ``paged_groups``; it splits each head group's used pages into
    ``nsplit`` equal shares, with B * Hkv * groups * nsplit CTAs about
    _PAGED_CTAS_PER_SM per SM, and no more splits than pages. The SIMT
    body takes the rest, one CTA per row, kv head and group."""
    pages = MAXP if pages_hint is None else max(1, min(int(pages_hint), MAXP))
    one_group = rep * D <= 512 if rep in (1, 2, 4, 8) else True
    if D in (128, 256) and one_group and P % 128 == 0 and P * D <= 32768:
        groups = paged_groups(rep, D, "split")[1]
        per_row = _PAGED_CTAS_PER_SM * sms // (B * Hkv * groups)
        return PagedPlan("split", max(1, min(pages, per_row)))
    return PagedPlan("simt", 1)


def _paged_plain(q4, kp, ks, vp, vs, li, page_table, lengths, new_kv, scale,
                 window, softcap, alibi):
    """Plain PyTorch version of kernel D (gathers every table page; kv4
    pages and scales are put back into token order first)."""
    B, Hkv, rep, D = q4.shape
    P = vs.shape[3]
    MAXP = page_table.shape[1]
    pt = page_table.long()
    S = MAXP * P
    kg, vg, ksg, vsg = kp[li][pt], vp[li][pt], ks[li][pt], vs[li][pt]
    kv4 = vp.dtype == torch.uint8
    if kv4:
        kg, vg = kv4_unpack(kg), kv4_unpack(vg)
        ksg, vsg = kv4_scales_logical(ksg), kv4_scales_logical(vsg)
    vfac = np.float32(1.0 / 7.0) if kv4 else np.float32(1.0 / 127.0)
    k = kg.permute(0, 2, 1, 3, 4).reshape(B, Hkv, S, D).float()
    v = vg.permute(0, 2, 1, 3, 4).reshape(B, Hkv, S, D).float()
    ksg = ksg.permute(0, 2, 1, 3).reshape(B, Hkv, 1, S).float()
    vsg = vsg.permute(0, 2, 1, 3).reshape(B, Hkv, 1, S).float()
    qf = q4.float()
    sc = torch.einsum("bhrd,bhsd->bhrs", qf, k) * (ksg * scale)
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
    m = sc.amax(dim=-1, keepdim=True)
    w = torch.exp(sc - m)
    l = w.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhrs,bhsd->bhrd", w * (vsg * vfac), v)
    if new_kv is not None:
        kn, ksn, vn, vsn = new_kv
        sc_new = (qf * kn.float()[:, :, None, :]).sum(dim=-1, keepdim=True)
        sc_new = sc_new * (ksn.float()[:, :, None, None] * scale)
        if softcap is not None:
            sc_new = softcap * torch.tanh(sc_new * np.float32(1.0 / softcap))
        m2 = torch.maximum(m, sc_new)
        alpha = torch.exp(m - m2)
        w_new = torch.exp(sc_new - m2)
        l2 = l * alpha + w_new
        wv_new = w_new * (vsn.float()[:, :, None, None] * vfac)
        o = (acc * alpha + wv_new * vn.float()[:, :, None, :]) / l2
    else:
        inv = torch.where(lens > 0, 1.0 / l, torch.zeros_like(l))
        o = acc * inv
    return o.to(q4.dtype)


def paged_attn_int8(q4, kp, ks, vp, vs, li: int, page_table, lengths, scale: float,
                    new_kv=None, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    alibi: Optional[torch.Tensor] = None,
                    pages_hint: Optional[int] = None) -> torch.Tensor:
    """Kernel D on CUDA tensors; the plain version on CPU tensors.
    q4 (B, Hkv, rep, D) f32/bf16 -> (B, Hkv, rep, D) in q's dtype; int8
    pages, or kv4 pages (uint8, P/2 byte rows), whose ``scale`` the caller
    gives for the +-7 grid. ``pages_hint``: see the module note."""
    extra = () if new_kv is None else tuple(new_kv)
    if not check_cuda_tensors("paged_attn_int8", q4, kp, ks, vp, vs, page_table, lengths,
                              alibi, *extra):
        return _paged_plain(q4, kp, ks, vp, vs, li, page_table, lengths, new_kv, scale,
                            window, softcap, alibi)
    B, Hkv, rep, D = q4.shape
    L, NP, _, P = ks.shape
    MAXP = page_table.shape[1]
    kv4 = kp.dtype == torch.uint8
    rows = P // 2 if kv4 else P
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_attn_int8: q must be f32/bf16, got {q4.dtype}")
    if kp.dtype not in (torch.int8, torch.uint8) or vp.dtype != kp.dtype \
            or ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise ValueError("paged_attn_int8: int8 or kv4 (uint8) pages with f32 scales only")
    if not paged_kernel_takes(D, rep, P) or kp.shape != (L, NP, Hkv, rows, D) \
            or vp.shape != kp.shape or ks.shape != (L, NP, Hkv, P) or vs.shape != ks.shape:
        raise ValueError(f"paged_attn_int8: unsupported shapes q={tuple(q4.shape)} "
                         f"pool={tuple(kp.shape)}")
    if not 0 <= li < L:
        raise ValueError(f"paged_attn_int8: layer {li} out of range [0, {L})")
    return _paged_launch(q4, kp, ks, vp, vs, li, page_table, lengths, scale, new_kv, window,
                         softcap, alibi,
                         paged_plan(B, Hkv, MAXP, P, D, rep, sm_count(q4.device), pages_hint))


def _paged_launch(q4, kp, ks, vp, vs, li, page_table, lengths, scale, new_kv, window, softcap,
                  alibi, plan: PagedPlan) -> torch.Tensor:
    """Launch kernel D's body ``plan.body`` on checked CUDA tensors."""
    B, Hkv, rep, D = q4.shape
    L, NP, _, P = ks.shape
    MAXP = page_table.shape[1]
    kv4 = int(kp.dtype == torch.uint8)
    qc = q4.contiguous()
    ts = [t.contiguous() for t in (kp, ks, vp, vs)]
    pt = page_table.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    al = None if alibi is None else alibi.float().contiguous()
    if new_kv is not None:
        kn, ksn, vn, vsn = new_kv
        nk = [kn.to(torch.int8).contiguous(), ksn.float().contiguous(),
              vn.to(torch.int8).contiguous(), vsn.float().contiguous()]
        if nk[0].data_ptr() % 16:
            nk[0] = nk[0].clone()  # the split body reads new K rows 16 bytes at a time
        nk_ptrs = [t.data_ptr() for t in nk]
    else:
        nk_ptrs = [None] * 4
    out = torch.empty_like(qc)
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    ptrs = (qc.data_ptr(), *(t.data_ptr() for t in ts), pt.data_ptr(), ln.data_ptr(),
            None if al is None else al.data_ptr(), *nk_ptrs, out.data_ptr())
    if plan.body == "split":
        # the bulk copies read pages and scale rows at 16-byte aligned addresses
        assert all(t.data_ptr() % 16 == 0 for t in ts), "unaligned page pool"
        part = tickets = None
        if plan.nsplit > 1:
            g, groups = paged_groups(rep, D, "split")
            part = scratch_buffer(q4.device, B * Hkv * groups * plan.nsplit * g * (D + 2))
            tickets = ticket_buffer(q4.device, B * Hkv * groups)
        fn = _build.kernel_fn("paged_attn_int8", "paged_attn_int8_split", 32,
                              int_args=range(15, 29), float_args=(29, 30))
        err = fn(*ptrs, None if part is None else part.data_ptr(),
                 None if tickets is None else tickets.data_ptr(),
                 int(li), L, NP, B, Hkv, rep, D, P, MAXP, plan.nsplit, int(window or 0),
                 int(new_kv is not None), int(q4.dtype == torch.bfloat16), kv4,
                 float(scale), float(softcap or 0.0), stream)
        paged_attn_int8.launches_split += 1
    else:
        fn = _build.kernel_fn("paged_attn_int8", "paged_attn_int8", 29,
                              int_args=range(13, 26), float_args=(26, 27))
        err = fn(*ptrs, int(li), L, NP, B, Hkv, rep, D, P, MAXP, int(window or 0),
                 int(new_kv is not None), int(q4.dtype == torch.bfloat16), kv4,
                 float(scale), float(softcap or 0.0), stream)
    _build.check(f"paged_attn_int8 ({plan.body})", err)
    paged_attn_int8.launches += 1
    paged_attn_int8.launches_kv4 += kv4
    return out


# launches of either body, of the split body alone, and over kv4 pages
paged_attn_int8.launches = 0
paged_attn_int8.launches_split = 0
paged_attn_int8.launches_kv4 = 0


def paged_decode_attention_int8_stacked(
    q: torch.Tensor,  # (B, 1, Hq, D)
    kp: torch.Tensor,  # (L, NP, Hkv, P, D) int8, or kv4 (L, NP, Hkv, P/2, D) uint8
    ks: torch.Tensor,  # (L, NP, Hkv, P) f32
    vp: torch.Tensor,  # as kp
    vs: torch.Tensor,  # (L, NP, Hkv, P) f32
    li: int,
    page_table: torch.Tensor,  # (B, MAXP) int32
    lengths: torch.Tensor,  # (B,) tokens in the pool per row
    new_kv=None,  # optional (kq (B,Hkv,D) i8, ks (B,Hkv) f32, vq, vs); kv4: +-7 codes
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sm_scale: Optional[float] = None,
    pages_hint: Optional[int] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # (Hq,)
) -> torch.Tensor:
    """Single-step attention over layer ``li`` of the paged pool, (B, 1, Hq,
    D) in q's dtype. Raises ValueError on the shapes the JAX kernel declines
    (``paged_attention_ok``: T != 1, D or P not a multiple of 128, Hq not a
    multiple of Hkv); the model attends those through its gather route
    (``models.llama._paged_write_and_attend``), as the JAX package does."""
    B, T, Hq, D = q.shape
    Hkv, P = vp.shape[2], vs.shape[3]
    if not paged_attention_ok(T, D, Hq, Hkv, P, vp.shape[3]):
        raise ValueError(f"paged_decode_attention_int8_stacked: the kernel does not take "
                         f"T={T}, D={D}, P={P}, Hq={Hq}, Hkv={Hkv}, pages {tuple(vp.shape)}")
    if window is not None and window >= page_table.shape[1] * P:
        window = None  # can never bind
    sm = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(D))
    q4 = q.reshape(B, Hkv, Hq // Hkv, D)
    levels = 7.0 if vp.dtype == torch.uint8 else 127.0
    out = paged_attn_int8(q4, kp, ks, vp, vs, int(li), page_table, lengths, sm / levels,
                          new_kv=new_kv, window=window, softcap=softcap, alibi=alibi_slopes,
                          pages_hint=pages_hint)
    return out.reshape(B, 1, Hq, D)


def paged_decode_attention_int8(q, kp, ks, vp, vs, page_table, lengths, window=None,
                                softcap=None, sm_scale=None, pages_hint=None,
                                alibi_slopes=None):
    """Single-layer pool (NP, Hkv, P, D) form of the stacked wrapper."""
    return paged_decode_attention_int8_stacked(
        q, kp[None], ks[None], vp[None], vs[None], 0, page_table, lengths,
        window=window, softcap=softcap, sm_scale=sm_scale, pages_hint=pages_hint,
        alibi_slopes=alibi_slopes)
