"""Fused blockwise 8-bit optimizer step: kernel J (``optim8_2state``: adam,
lamb) and kernel K (``optim8_1state``: momentum, rmsprop, adagrad, lion),
the port of the JAX package's ``ops/optim8.py``.

Per quantization block of a leaf: read g, p, the uint8 states and their
per-block absmax, decode the states, run the update, requantize each state
with a fresh per-block absmax, write p, the codes and the absmax. The
states go through one of two codecs: the arithmetic dynamic maps
(``dynamic8``, the default) or any 256-entry table (``qmaps``, the LUT
codec ``LutCodec``: decode by the table, encode by a search over the
midpoints of its sorted distinct values). Each kernel runs over a leaf
table: one launch takes every 8-bit leaf of an optimizer step
(``optim8_update``, ``leaf_plan``) and updates the leaves in place, with
no padding copy; the ragged last block of a leaf reads as the JAX
package's kernel route pads it (g, p 0, state1 code 127, state2 code 0,
under either codec). Blocks of up to ``ONE_PASS_MAX`` elements take the
one-pass body (a CTA holds a block). A larger block of kernel K up to
``resident_max`` elements, in a table of enough such blocks, takes the
resident body: a cluster of up to 16 CTAs holds the block's new states
in shared memory, agrees on its maximum and encodes them, in one launch.
Any other larger block spans several CTAs and takes two launches (the
first folds each chunk's maximum into its block's slot, the second
recomputes the update and encodes with it). ``leaf_plan`` picks the
route from the shape. The
JAX entry on (nb, bs) rows (``optim8_blockwise_fused``) runs the same
bodies over a one-leaf table of copies. The step's eight f32 scalars
(``functional._optim8_scalars``) come as rows of an (R, 8) tensor, one
row index per leaf:

- 2-state: b1, b2, eps * c2, step_size, decay, gnorm_scale, 0, 0 (the bias
  correction folded in, c1 = 1 - b1^step, c2 = sqrt(1 - b2^step),
  step_size = -lr * c2 / c1, decay = 1 - lr * weight_decay);
- 1-state: b1, b2, eps, lr, weight_decay, gnorm_scale, is_step1, 0.

Semantics of the JAX kernel: non-finite gradient entries keep p and the
old decoded states (which still enter the block's new absmax); the absmax
is the block's fresh max |state| (NaN if any is NaN), ``safe_inv(0) = 0``;
state1's code gets the sign fix unless rounding is stochastic; stochastic
rounding takes the uniforms ``u`` as an input, and state2 uses them after a
golden-ratio scramble; it needs the dynamic codec.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import _build
from .common import check_cuda_tensors, safe_inv
from .common import sm_count as _sm_count
from .dynamic8 import (KERNEL_TABLE_PARTS, dynamic_decode, dynamic_encode, encode_consts,
                       kernel_table, stochastic_adjust)

__all__ = ["optim8_blockwise_fused", "optim8_update", "optim8_2state",
           "optim8_1state", "Optim8Leaf", "LeafPlan", "leaf_plan", "optim8_route",
           "resident_cluster", "resident_max", "resident_slices", "ONE_STATE", "TWO_STATE",
           "ONE_PASS_MAX", "RESIDENT_SMEM_MAX", "LutCodec", "lut_table_ok", "lut_bucket_rank"]

TWO_STATE = ("adam", "lamb")
ONE_STATE = ("momentum", "rmsprop", "adagrad", "lion")
# a CTA of 256 threads holds a block of up to 2048 elements, 8 a thread;
# larger blocks are walked in chunks of that size by the two-pass body
ONE_PASS_MAX = 2048
CTAS_PER_SM = 3  # the persistent grid (csrc/dynamic8.cuh kMinCtas)
LEAF_WORDS = 10  # int64 words of a leaf table row (csrc/dynamic8.cuh Leaf)
PAD_CODES = (127, 0)  # a ragged block's state1 and state2 codes past the leaf
# the bucket index of a LUT codec: one byte per value of the top bits of an
# f32's order-preserving key (csrc/dynamic8.cuh kLutBucketBits)
LUT_BUCKET_BITS = 14
# f32 words of one LUT codec in the kernels' table (csrc/dynamic8.cuh
# kLutWords): decode table, midpoints, rank -> code, n_neg, top, the
# largest bucket occupancy, a spare word, then the bucket index
LUT_WORDS = 580 + (1 << LUT_BUCKET_BITS) // 4
# kernel K's resident body (csrc/optim8_1state.cu): the dynamic shared
# memory a CTA may take (kResSmemMax), its threads, the largest cluster
# (16 CTAs, past the portable 8), and the bytes beside the new states and
# the codec table: two rows of the 16 warps' maxima and two rows of the
# cluster's 16 CTA maxima (kResSlotBytes)
RESIDENT_SMEM_MAX = 225 * 1024
RESIDENT_THREADS = 512
RESIDENT_CLUSTER_MAX = 16
RESIDENT_SLOT_BYTES = (2 * (RESIDENT_THREADS // 32) + 2 * RESIDENT_CLUSTER_MAX) * 4
# the elements a CTA of a cluster aims to hold, and the blocks per cluster
# the resident route needs (the cluster sweep on the H100, PERF.md)
RESIDENT_PER_CTA = 32768
RESIDENT_MIN_RUN = 2


def _apply_sign_fix(rank: torch.Tensor, normed: torch.Tensor, n_neg: int, top: int) -> torch.Tensor:
    """State1's sign preservation: where sign(table[code]) differs from the
    value's (signbit semantics: -0.0 counts as negative), bump the rank one
    step toward the value's sign, so a small nonzero momentum never
    requantizes to zero or the wrong sign."""
    r = rank.to(torch.int32)
    mism = (r < n_neg) != torch.signbit(normed)
    step = torch.where(normed > 0, 1, -1).to(torch.int32)
    return torch.where(mism, (r + step).clamp(0, top), r)


class _DynamicCodec:
    """The arithmetic dynamic-map codec; ``sign_fix`` for state1 only."""

    def __init__(self, signed: bool, sign_fix: bool = False):
        self.signed = signed
        self.sign_fix = sign_fix and signed

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return dynamic_decode(codes, signed=self.signed)

    def encode(self, normed: torch.Tensor, u: Optional[torch.Tensor] = None) -> torch.Tensor:
        codes = dynamic_encode(normed, signed=self.signed)
        if u is not None:
            return stochastic_adjust(codes, normed, u, signed=self.signed)
        if self.sign_fix:
            return _apply_sign_fix(codes, normed, n_neg=127, top=255).to(torch.uint8)
        return codes


def lut_table_ok(q) -> bool:
    """A table the JAX package's LUT kernel takes: (256,) finite values,
    non-decreasing, with at least two distinct entries (duplicates are
    allowed)."""
    if q is None:
        return False
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    try:
        t = np.asarray(q, np.float32)
    except (TypeError, ValueError):
        return False
    return (t.shape == (256,) and bool(np.all(np.isfinite(t))) and bool(np.all(np.diff(t) >= 0))
            and np.unique(t).size >= 2)


class LutParts(NamedTuple):
    """The host-side description of one 256-entry table: the decode table,
    the f32 midpoints between its sorted (distinct) values, the rank ->
    code map, the count of sorted values with the sign bit set, the top
    rank, and the bucket index of the midpoints (``_bucket_index``)."""
    table: np.ndarray  # f32 (256,), index = code
    mids: np.ndarray   # f32 (top,), ascending
    code: np.ndarray   # uint8 (top + 1,)
    n_neg: int
    top: int
    bucket_lo: np.ndarray  # uint8 (2^LUT_BUCKET_BITS,): midpoints in lower buckets
    bucket_max: int        # the most midpoints in one bucket


def _order_keys(x: np.ndarray) -> np.ndarray:
    """The f32 values' order-preserving uint32 keys, -0.0 keyed as +0.0
    (they compare equal): for values that are not NaN, a < b exactly where
    key(a) < key(b)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).copy()
    u[(u & np.uint32(0x7FFFFFFF)) == 0] = 0
    return np.where(u >> np.uint32(31) != 0, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _bucket_index(mids: np.ndarray):
    """The kernels' index over ascending midpoints: bucket b holds the
    values whose key's top LUT_BUCKET_BITS bits are b. Returns (lo, max):
    lo[b] = #{mids in buckets below b}, the least rank of any value in
    bucket b, and the most midpoints any one bucket holds. A value x (not
    NaN) in bucket b then has rank lo[b] + #{mids[lo[b] + k] < x, k <
    max}: midpoints of lower buckets are all below x, those of higher ones
    (and the +inf padding) all above."""
    b = (_order_keys(mids) >> np.uint32(32 - LUT_BUCKET_BITS)).astype(np.int64)
    assert np.all(np.diff(b) >= 0), "midpoints must ascend"
    lo = np.searchsorted(b, np.arange(1 << LUT_BUCKET_BITS), side="left")
    most = int(np.bincount(b).max()) if b.size else 0
    return lo.astype(np.uint8), most


def _table_bytes(qmap) -> bytes:
    if isinstance(qmap, torch.Tensor):
        qmap = qmap.detach().cpu().numpy()
    t = np.ascontiguousarray(np.asarray(qmap, np.float32).reshape(-1))
    if t.shape != (256,):
        raise ValueError(f"optim8: a state table must hold 256 entries, got {t.shape}")
    if not np.all(np.isfinite(t)):
        raise ValueError("optim8: a state table with non-finite entries is declined")
    return t.tobytes()


@functools.lru_cache(maxsize=64)
def _lut_parts(key: bytes) -> LutParts:
    """The JAX package's two table forms from one description. A sorted
    table (duplicates allowed, a constant one included) is deduplicated:
    ranks run over its distinct values, each maps to the first index of
    its duplicate run. An unsorted table is stably argsorted, with no
    deduplication."""
    table = np.frombuffer(key, np.float32).copy()
    if np.all(np.diff(table) >= 0):
        uq, code = np.unique(table, return_index=True)
        sc = uq.astype(np.float32)
    else:
        code = np.argsort(table, kind="stable")
        sc = table[code]
    mids = ((sc[1:] + sc[:-1]) / 2.0).astype(np.float32)
    return LutParts(table, mids, code.astype(np.uint8), int(np.signbit(sc).sum()), sc.size - 1,
                    *_bucket_index(mids))


def lut_parts(qmap) -> LutParts:
    """The (cached) description of a 256-entry table, numpy or a tensor;
    a table with a non-finite entry raises ValueError."""
    return _lut_parts(_table_bytes(qmap))


class LutCodec:
    """The plain version of the LUT codec over one table (``LutParts``):
    decode is ``table[code]``; encode is the rank #{mids < x}, NaN at rank
    0 (as the JAX package's select tree has it), then state1's sign fix in
    rank space, then the rank -> code map. No stochastic rounding."""

    def __init__(self, qmap, sign_fix: bool = False):
        self.parts = qmap if isinstance(qmap, LutParts) else lut_parts(qmap)
        self.sign_fix = sign_fix

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(self.parts.table).to(codes.device)[codes.long()]

    def rank(self, x: torch.Tensor) -> torch.Tensor:
        mids = torch.from_numpy(self.parts.mids).to(x.device)
        if mids.numel() == 0:
            return torch.zeros(x.shape, dtype=torch.int64, device=x.device)
        r = torch.searchsorted(mids, x.contiguous(), right=False)
        return torch.where(torch.isnan(x), torch.zeros_like(r), r)

    def encode(self, normed: torch.Tensor, u: Optional[torch.Tensor] = None) -> torch.Tensor:
        if u is not None:
            raise ValueError("optim8: the LUT codec has no stochastic rounding")
        rank = self.rank(normed)
        if self.sign_fix:
            rank = _apply_sign_fix(rank, normed, self.parts.n_neg, self.parts.top)
        return torch.from_numpy(self.parts.code).to(normed.device)[rank.long()]


def lut_bucket_rank(parts: LutParts, x: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernels' rank of f32 values ``x`` among a
    table's midpoints: the bucket of x's order-preserving key
    (``_order_keys``), the least rank there, plus the midpoints from that
    rank on (at most ``bucket_max``, past ``top`` the +inf padding) that lie
    below x; NaN at rank 0. Equal to ``LutCodec.rank`` for every f32."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where((bits & 0x7FFFFFFF) == 0, torch.zeros_like(bits), bits)
    key = torch.where(bits >= 1 << 31, 0xFFFFFFFF - bits, bits | 1 << 31)
    lo = torch.from_numpy(parts.bucket_lo.astype(np.int64)).to(x.device)[
        key >> (32 - LUT_BUCKET_BITS)]
    mids = torch.full((256,), float("inf"), dtype=torch.float32, device=x.device)
    mids[:parts.mids.size] = torch.from_numpy(parts.mids).to(x.device)
    r = lo.clone()
    for k in range(parts.bucket_max):
        r += (mids[(lo + k).clamp(max=255)] < x).long()
    return torch.where(torch.isnan(x), torch.zeros_like(r), r)


def _codecs(two: bool, qmaps=None):
    """The codecs of the plain bodies: (state1 with the sign fix, state2 or
    None), dynamic without ``qmaps``, else LUT codecs over its tables."""
    if qmaps is None:
        return _DynamicCodec(True, sign_fix=True), _DynamicCodec(False) if two else None
    return LutCodec(qmaps[0], sign_fix=True), LutCodec(qmaps[1]) if two else None


def lut_words(parts: LutParts) -> np.ndarray:
    """One codec's words of the kernels' table (csrc/dynamic8.cuh): the
    decode table, the midpoints padded with +inf to 256, the rank -> code
    bytes, n_neg, top and the largest bucket occupancy as int32 bits, a
    spare word, then the bucket index's bytes."""
    w = np.zeros(LUT_WORDS, np.float32)
    w[:256] = parts.table
    w[256:512] = np.inf
    w[256:256 + parts.mids.size] = parts.mids
    code = np.zeros(256, np.uint8)
    code[:parts.code.size] = parts.code
    w[512:576] = code.view(np.float32)
    w[576:579] = np.array([parts.n_neg, parts.top, parts.bucket_max], np.int32).view(np.float32)
    w[580:] = parts.bucket_lo.view(np.float32)
    return w


@functools.lru_cache(maxsize=32)
def _lut_table(keys: tuple, device: str) -> torch.Tensor:
    return torch.from_numpy(np.concatenate([lut_words(_lut_parts(k)) for k in keys])).to(device)


def _requant_rows(s: torch.Tensor, codec, u=None):
    amax = s.abs().amax(dim=1, keepdim=True)
    return codec.encode(s * safe_inv(amax), u=u), amax


def _scalars(sc: torch.Tensor) -> list:
    """The step's scalars as Python floats from an (8,) row, or as (nb, 1)
    f32 columns from one row per block; each rounds alike in the update."""
    if sc.dim() == 2:
        return [sc[:, k:k + 1].float() for k in range(8)]
    return [float(v) for v in sc.float().cpu().reshape(-1)[:8]]


def _one_minus(b):
    if isinstance(b, torch.Tensor):
        return 1.0 - b  # rounds once in f32, as below
    return float(np.float32(1.0) - np.float32(b))


def _kernel2_plain(name, sc, g, p, s1, am1, s2, am2, u=None, qmaps=None):
    """Plain PyTorch version of kernel J: (p, state1, absmax1, state2,
    absmax2); the dynamic codec, or the LUT codec over ``qmaps``."""
    b1, b2, eps_c2, step_size, decay, gnorm_scale = _scalars(sc)[:6]
    codec1, codec2 = _codecs(True, qmaps)
    g = g.float() * gnorm_scale
    finite = torch.isfinite(g)
    g = torch.where(finite, g, torch.zeros_like(g))
    p = p.float()
    s1 = codec1.decode(s1) * am1.float()[:, None]
    s2 = codec2.decode(s2) * am2.float()[:, None]
    n1 = s1 * b1 + _one_minus(b1) * g
    n2 = s2 * b2 + _one_minus(b2) * g * g
    np_ = p + step_size * (n1 / (torch.sqrt(n2) + eps_c2))
    np_ = np_ * decay
    np_ = torch.where(finite, np_, p)
    n1 = torch.where(finite, n1, s1)
    n2 = torch.where(finite, n2, s2)
    u2 = None if u is None else torch.remainder(u * 0.6180339887 + 0.3819660113, 1.0)
    c1, a1 = _requant_rows(n1, codec1, u)
    c2, a2 = _requant_rows(n2, codec2, u2)
    return np_, c1, a1.reshape(-1), c2, a2.reshape(-1)


def _kernel1_plain(name, sc, g, p, s1, am1, u=None, qmaps=None):
    """Plain PyTorch version of kernel K: (p, state1, absmax1)."""
    b1, b2, eps, lr, wd, gnorm_scale, is_step1 = _scalars(sc)[:7]
    codec1, _ = _codecs(False, qmaps)
    g = g.float() * gnorm_scale
    finite = torch.isfinite(g)
    g = torch.where(finite, g, torch.zeros_like(g))
    p = p.float()
    s1 = codec1.decode(s1) * am1.float()[:, None]
    g = g + p * wd  # coupled weight decay
    if name == "momentum":
        if isinstance(is_step1, torch.Tensor):
            n1 = torch.where(is_step1 > 0, g, s1 * b1 + g)
        else:
            n1 = g if is_step1 > 0 else s1 * b1 + g
        np_ = p - lr * n1
    elif name == "rmsprop":
        n1 = s1 * b1 + _one_minus(b1) * g * g
        np_ = p - lr * g / (torch.sqrt(n1) + eps)
    elif name == "adagrad":
        n1 = s1 + g * g
        np_ = p - lr * g / (torch.sqrt(n1) + eps)
    elif name == "lion":
        np_ = p - lr * torch.sign(s1 * b1 + _one_minus(b1) * g)
        n1 = s1 * b2 + _one_minus(b2) * g
    else:
        raise ValueError(name)
    np_ = torch.where(finite, np_, p)
    n1 = torch.where(finite, n1, s1)
    c1, a1 = _requant_rows(n1, codec1, u)
    return np_, c1, a1.reshape(-1)


def _check_rows(name, g, p, states, scalars, u):
    nb, bs = g.shape
    if bs == 0 or nb == 0:
        raise ValueError(f"{name}: rows must be (nb >= 1, bs >= 1), got ({nb}, {bs})")
    for t, dt in [(g, torch.float32), (p, torch.float32)] + [(s, torch.uint8) for s in states[0::2]]:
        if t.dtype != dt or tuple(t.shape) != (nb, bs) or not t.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous ({nb}, {bs}) {dt}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for a in states[1::2]:
        if a.dtype != torch.float32 or a.numel() != nb or not a.is_contiguous():
            raise ValueError(f"{name}: absmax must be contiguous ({nb},) f32")
    if scalars.dtype != torch.float32 or scalars.numel() < 8 or not scalars.is_contiguous():
        raise ValueError(f"{name}: scalars must be a contiguous (8,) f32 tensor")
    if u is not None and (u.dtype != torch.float32 or tuple(u.shape) != (nb, bs)
                          or not u.is_contiguous()):
        raise ValueError(f"{name}: u must be contiguous ({nb}, {bs}) f32")


# ------------------------------------------------------------ leaf table


class Optim8Leaf(NamedTuple):
    """One 8-bit leaf of a step: g and p (f32, n elements), state1 (uint8,
    n), absmax1 (f32, one per block), state2 and absmax2 for a 2-state
    optimizer, u (f32 uniforms, at least n) under stochastic rounding. All
    contiguous; p, the states and the absmax are written in place."""
    g: torch.Tensor
    p: torch.Tensor
    state1: torch.Tensor
    absmax1: torch.Tensor
    state2: Optional[torch.Tensor] = None
    absmax2: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None


class LeafPlan(NamedTuple):
    blocks: tuple   # quantization blocks of each leaf
    first: tuple    # each leaf's first global block (the prefix sum of blocks)
    total: int      # blocks of the step
    grid: int       # persistent CTAs of the launch (the resident route: clusters x cluster)
    route: str = "one_pass"  # "one_pass", "resident" or "two_pass" (optim8_route)
    cluster: int = 0         # the resident route: CTAs of a cluster, one block at a time
    per_cta: int = 0         # the resident route: elements of a block a CTA holds
    smem: int = 0            # the resident route: dynamic shared memory bytes a CTA


def _table_words(lut: bool) -> int:
    return LUT_WORDS if lut else KERNEL_TABLE_PARTS["words"]


def resident_per_cta_max(lut: bool) -> int:
    """The most elements of a block one CTA of the resident body holds: a
    multiple of 8 (a thread's run) whose f32 states fit RESIDENT_SMEM_MAX
    beside the codec table (the dynamic maps' 1,058 words, or one LUT
    codec's LUT_WORDS) and the reduction and exchange slots."""
    return (RESIDENT_SMEM_MAX - 4 * _table_words(lut) - RESIDENT_SLOT_BYTES) // 32 * 8


def resident_max(lut: bool) -> int:
    """The largest block kernel K's resident body takes: a cluster of
    RESIDENT_CLUSTER_MAX CTAs, each holding resident_per_cta_max elements
    (903,552 under the dynamic maps, 845,696 under a LUT codec; both
    multiples of 128)."""
    return RESIDENT_CLUSTER_MAX * resident_per_cta_max(lut)


def resident_cluster(blocksize: int, lut: bool) -> int:
    """The resident body's cluster size for a block: the next power of two
    at or past both the fewest CTAs whose shared memory holds the block and
    RESIDENT_PER_CTA elements a CTA (8 at 262,144, 16 at 704,512, from
    the cluster sweep on the H100)."""
    want = max(-(-blocksize // resident_per_cta_max(lut)), -(-blocksize // RESIDENT_PER_CTA))
    return min(1 << (want - 1).bit_length(), RESIDENT_CLUSTER_MAX)


def optim8_route(one_state: bool, blocksize: int, lut: bool, total: int, sm_count: int) -> str:
    """The body a table of ``total`` blocks of ``blocksize`` elements takes:
    "one_pass" up to ONE_PASS_MAX; then for kernel K (``one_state``)
    "resident" up to ``resident_max(lut)`` where the table gives each
    cluster the card holds at once RESIDENT_MIN_RUN blocks or more (at one
    a cluster's update, barrier and encode do not overlap, and the
    two-pass body, on every SM, is as fast or faster); else "two_pass"
    (kernel J always past ONE_PASS_MAX)."""
    if blocksize <= ONE_PASS_MAX:
        return "one_pass"
    if one_state and blocksize <= resident_max(lut):
        clusters = max(1, sm_count // resident_cluster(blocksize, lut))
        if total >= RESIDENT_MIN_RUN * clusters:
            return "resident"
    return "two_pass"


def resident_slices(blocksize: int, cluster: int, lut: bool) -> tuple:
    """(per_cta, smem) of the resident body at ``cluster`` CTAs a block:
    the elements of a block each CTA holds (a multiple of 8) and its
    dynamic shared memory bytes (the held states, the codec table and the
    slots). Raises where the cluster cannot hold the block."""
    per_cta = -(-blocksize // (8 * cluster)) * 8
    if not 1 <= cluster <= RESIDENT_CLUSTER_MAX or per_cta > resident_per_cta_max(lut):
        raise ValueError(f"leaf_plan: a cluster of {cluster} CTAs cannot hold a block of {blocksize}")
    return per_cta, 4 * per_cta + 4 * _table_words(lut) + RESIDENT_SLOT_BYTES


@functools.lru_cache(maxsize=64)
def leaf_plan(numels: tuple, blocksize: int, sm_count: int, one_state: bool = False,
              lut: bool = False) -> LeafPlan:
    """The launch plan of one step's leaf table: block counts and offsets
    per leaf, the route (``optim8_route``) and the persistent grid. The
    one-pass and two-pass routes run CTAS_PER_SM CTAs per SM (fewer when
    the step has fewer blocks, or, past ONE_PASS_MAX, fewer 2048-element
    chunks of blocks). The resident route runs clusters of
    ``resident_cluster`` CTAs, one CTA an SM, at most one cluster a block:
    each CTA holds ``per_cta`` elements of a block in ``smem`` bytes of
    dynamic shared memory (``resident_slices``). The whole table goes in one launch (a launch
    pair on the two-pass route): it reaches the kernel as one device
    buffer, whatever its length."""
    if blocksize < 1:
        raise ValueError(f"leaf_plan: blocksize {blocksize} must be >= 1 (any size: blocks past "
                         f"{ONE_PASS_MAX} take the resident or the two-pass body)")
    if any(n < 0 for n in numels):
        raise ValueError(f"leaf_plan: negative leaf size in {numels}")
    blocks = tuple(-(-int(n) // blocksize) for n in numels)
    first = tuple(itertools.accumulate(blocks[:-1], initial=0)) if blocks else ()
    total = sum(blocks)
    route = optim8_route(one_state, blocksize, lut, total, sm_count)
    if route != "resident":
        chunks = total * -(-blocksize // ONE_PASS_MAX)
        return LeafPlan(blocks, first, total, min(chunks, sm_count * CTAS_PER_SM), route)
    c = resident_cluster(blocksize, lut)
    per_cta, smem = resident_slices(blocksize, c, lut)
    clusters = min(total, max(1, sm_count // c))
    return LeafPlan(blocks, first, total, clusters * c, route, c, per_cta, smem)


def _check_leaves(name, leaves: Sequence[Optim8Leaf], scalars, rows, blocksize):
    """Validate a leaf table; returns (rows as a tuple, stochastic, the
    table's rows for the kernel: the seven pointers and n of each leaf,
    and whether the tensors lie on CUDA (True) or on the CPU (False); a
    mix raises)."""
    two = name in TWO_STATE
    if name not in TWO_STATE + ONE_STATE:
        raise ValueError(f"optim8: unknown optimizer {name!r}")
    if not leaves:
        raise ValueError("optim8: empty leaf table")
    stochastic = leaves[0].u is not None
    f32, u8 = torch.float32, torch.uint8
    kinds = (f32, f32, u8, f32, u8, f32)
    nfields = 6 if two else 4
    out, spans, on_cuda = [], [], 0
    for i, lf in enumerate(leaves):
        n = lf.p.numel()
        nb = -(-n // blocksize)
        sizes = (n, n, n, nb, n, nb)
        ptrs = [0] * 8
        for k in range(nfields):
            t = lf[k]
            if t is None or t.dtype != kinds[k] or t.numel() != sizes[k] or not t.is_contiguous():
                raise ValueError(
                    f"optim8 {name}: leaf {i} needs contiguous {kinds[k]} of {sizes[k]} elements, "
                    "got " + ("None" if t is None else f"{t.dtype} {tuple(t.shape)}"))
            ptrs[k] = t.data_ptr()
            on_cuda += t.is_cuda
            if k and sizes[k]:  # written in place
                spans.append((ptrs[k], ptrs[k] + sizes[k] * (1 if kinds[k] is u8 else 4)))
        if not two and (lf.state2 is not None or lf.absmax2 is not None):
            raise ValueError(f"optim8 {name}: a 1-state optimizer's leaf {i} has a state2")
        if (lf.u is not None) != stochastic:
            raise ValueError("optim8: uniforms u for every leaf or for none")
        if stochastic:
            if lf.u.dtype != f32 or lf.u.numel() < n or not lf.u.is_contiguous():
                raise ValueError(f"optim8 {name}: leaf {i} needs contiguous f32 u of >= {n} elements")
            ptrs[6] = lf.u.data_ptr()
            on_cuda += lf.u.is_cuda
        ptrs[7] = n
        out.append(ptrs)
    if scalars.dtype != f32 or scalars.dim() != 2 or scalars.shape[1] != 8 \
            or not scalars.is_contiguous():
        raise ValueError("optim8: scalars must be a contiguous (R, 8) f32 tensor")
    rows = (0,) * len(leaves) if rows is None else tuple(int(r) for r in rows)
    if len(rows) != len(leaves) or not all(0 <= r < scalars.shape[0] for r in rows):
        raise ValueError(f"optim8: one scalars row per leaf in 0..{scalars.shape[0] - 1}")
    # the leaves are written in place: no two may share memory
    spans = np.array(spans, dtype=np.int64).reshape(-1, 2)
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    if np.any(spans[1:, 0] < spans[:-1, 1]):
        raise ValueError("optim8: leaves share memory (p, a state or an absmax of one leaf "
                         "overlaps another's); step such leaves one at a time")
    on_cuda += scalars.is_cuda
    n_tensors = len(leaves) * (nfields + stochastic) + 1
    if on_cuda not in (0, n_tensors):
        raise ValueError("optim8: tensors must all lie on the CPU or all on CUDA")
    return rows, stochastic, out, on_cuda > 0


def _grouped_plain(name, leaves, scalars, rows, plan, blocksize, apply_delta, qmaps=None):
    """Plain PyTorch version of the leaf-table bodies (one-pass and
    two-pass alike), in place: every leaf's blocks at its offset of one
    (total, blocksize) array, read up to n and padded past it as the JAX
    package's kernel route pads (g, p 0, state1 and state2 codes
    PAD_CODES, under either codec); each block's row of scalars;
    _kernel2_plain or _kernel1_plain over all blocks at once; p written as
    new_p, or as p + (new_p - p) with ``apply_delta``; codes and absmax
    written back."""
    two = name in TWO_STATE
    bs, total = blocksize, plan.total
    dev = leaves[0].p.device

    def gather(attr, fill, dtype):
        out = torch.full((total * bs,), fill, dtype=dtype, device=dev)
        for lf, f0 in zip(leaves, plan.first):
            n = lf.p.numel()
            out[f0 * bs:f0 * bs + n] = getattr(lf, attr).reshape(-1)[:n]
        return out.reshape(total, bs)

    per_block = torch.repeat_interleave(torch.tensor(rows, dtype=torch.long),
                                        torch.tensor(plan.blocks, dtype=torch.long))
    sc = scalars[per_block.to(dev)]
    g, p = gather("g", 0.0, torch.float32), gather("p", 0.0, torch.float32)
    s1 = gather("state1", PAD_CODES[0], torch.uint8)
    am1 = torch.cat([lf.absmax1.reshape(-1) for lf in leaves])
    u = gather("u", 0.0, torch.float32) if leaves[0].u is not None else None
    if two:
        s2 = gather("state2", PAD_CODES[1], torch.uint8)
        am2 = torch.cat([lf.absmax2.reshape(-1) for lf in leaves])
        out = _kernel2_plain(name, sc, g, p, s1, am1, s2, am2, u, qmaps)
    else:
        out = _kernel1_plain(name, sc, g, p, s1, am1, u, qmaps)
    po = out[0].reshape(-1)
    flat = [o.reshape(-1) for o in out[1:]]  # codes, absmax[, codes, absmax]
    for lf, f0, nb in zip(leaves, plan.first, plan.blocks):
        o, n = f0 * bs, lf.p.numel()
        pf, new = lf.p.view(-1), po[o:o + n]
        pf.copy_(pf + (new - pf) if apply_delta else new)
        dst = (lf.state1, lf.absmax1) + ((lf.state2, lf.absmax2) if two else ())
        for k, t in enumerate(dst):
            src = flat[k][o:o + n] if k % 2 == 0 else flat[k][f0:f0 + nb]
            t.view(-1).copy_(src)


def _launch(kname, name, table, scalars, rows, plan, blocksize, apply_delta, stochastic, dev,
            qmaps=None) -> int:
    """The launch over the leaf table (rows of _check_leaves) on the plan's
    route: one launch, a launch pair on the two-pass route; ``qmaps`` None
    or LutParts. Returns the launches made."""
    if blocksize >= 2 ** 31:
        raise ValueError(f"optim8: blocksize {blocksize} does not fit the kernels' int32")
    tab = np.zeros((len(table), LEAF_WORDS), np.int64)
    tab[:, :8] = table
    tab[:, 8] = plan.first
    tab[:, 9] = rows
    # one pinned copy per step: the caching host allocator keeps the block
    # until the asynchronous copy has read it
    leaves_dev = torch.from_numpy(tab).pin_memory().to(dev, non_blocking=True)
    if qmaps is None:
        codec = kernel_table(dev)
    else:
        codec = _lut_table(tuple(q.table.tobytes() for q in qmaps if q is not None), str(dev))
    two_pass = plan.route == "two_pass"
    # per block: the two states' maxima (int bits, zeroed by the C entry)
    # and their old absmax, between the two launches
    scratch = torch.empty((plan.total, 4), dtype=torch.int32, device=dev) if two_pass else None
    args = (leaves_dev.data_ptr(), len(table), scalars.data_ptr(), codec.data_ptr(),
            plan.total, blocksize, plan.grid, int(apply_delta), int(stochastic),
            int(qmaps is not None))
    tail = (0 if scratch is None else scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if kname == "optim8_2state":
        fn = _build.kernel_fn(kname, kname, 12, int_args=(1, 5, 6, 7, 8, 9), long_args=(4,))
        err = fn(*args, *tail)
    else:
        fn = _build.kernel_fn(kname, kname, 16, int_args=(0, 2, 6, 7, 8, 9, 10, 11, 12, 13),
                              long_args=(5,))
        err = fn(ONE_STATE.index(name), *args, plan.cluster, plan.per_cta, plan.smem, *tail)
    _build.check(kname, err)
    return 2 if two_pass else 1


def optim8_update(name: str, leaves: Sequence[Optim8Leaf], scalars: torch.Tensor, rows=None,
                  blocksize: int = 2048, apply_delta: bool = False, qmaps=None) -> None:
    """Kernel J (2-state) or K (1-state) over a leaf table, in place: one
    launch on CUDA tensors (two on the two-pass route), the plain version
    on CPU tensors; a table of no block launches nothing. ``scalars`` is
    an (R, 8) f32 tensor, ``rows`` a row index per leaf (default 0). p
    becomes new_p, or p + (new_p - p) with ``apply_delta`` (the
    optimizer's route). ``qmaps``: None for the dynamic maps, or (state1's
    table, state2's table or None) for the LUT codec, which takes no
    uniforms. Counters on the kernel: ``launches`` (every launch),
    ``launches_lut`` (LUT codec), ``launches_two_pass`` (the two-pass
    route), and on K ``launches_resident`` (the resident route)."""
    rows, stochastic, table, on_cuda = _check_leaves(name, leaves, scalars, rows, blocksize)
    if qmaps is not None:
        if qmaps[0] is None or (name in TWO_STATE) != (qmaps[1] is not None):
            raise ValueError(f"optim8 {name}: qmaps needs state1's table, and state2's for a "
                             "2-state optimizer only")
        if stochastic:
            raise ValueError("optim8: stochastic rounding does not combine with the LUT codec")
        qmaps = tuple(None if q is None else lut_parts(q) for q in qmaps)
    dev = leaves[0].p.device
    plan = leaf_plan(tuple(row[7] for row in table), blocksize,
                     _sm_count(dev) if on_cuda else 1, name in ONE_STATE, qmaps is not None)
    if plan.total == 0:
        return
    if not on_cuda:
        _grouped_plain(name, leaves, scalars, rows, plan, blocksize, apply_delta, qmaps)
        return
    kname = "optim8_2state" if name in TWO_STATE else "optim8_1state"
    n = _launch(kname, name, table, scalars, rows, plan, blocksize, apply_delta, stochastic, dev,
                qmaps)
    fn = _KERNEL_OF[kname]
    fn.launches += n
    fn.launches_lut += n if qmaps is not None else 0
    fn.launches_two_pass += n if plan.route == "two_pass" else 0
    if plan.route == "resident":
        fn.launches_resident += n


def _rows_launch(kname, name, g, p, states, scalars, u, qmaps):
    """The JAX entry's (nb, bs) rows through the leaf-table body: a
    one-leaf table over copies of p and the states."""
    _check_rows(kname, g, p, states, scalars, u)
    out = [p.clone()] + [s.clone() for s in states]
    leaf = Optim8Leaf(g, *out, *((None, None) if len(states) == 2 else ()), u=u)
    optim8_update(name, [leaf], scalars.reshape(-1)[:8].reshape(1, 8), None, g.shape[1],
                  qmaps=qmaps)
    return tuple(out)


def optim8_2state(name, g, p, s1, am1, s2, am2, scalars, u=None, qmaps=None):
    """Kernel J on (nb, bs) rows: CUDA tensors through the leaf-table body,
    CPU tensors through the plain version. g, p f32, s1, s2 uint8; am1, am2
    (nb,) f32; scalars (8,) f32; u (nb, bs) f32 uniforms or None; qmaps
    None (dynamic maps) or the two states' tables. Returns new (p, state1,
    absmax1, state2, absmax2). ``launches`` counts every launch of kernel
    J, ``launches_lut`` and ``launches_two_pass`` those of its branches."""
    if name not in TWO_STATE:
        raise ValueError(f"optim8_2state: {name!r} is not a 2-state optimizer")
    if not check_cuda_tensors("optim8_2state", g, p, s1, am1, s2, am2, scalars, u):
        return _kernel2_plain(name, scalars, g, p, s1, am1, s2, am2, u, qmaps)
    return _rows_launch("optim8_2state", name, g, p, (s1, am1, s2, am2), scalars, u, qmaps)


def optim8_1state(name, g, p, s1, am1, scalars, u=None, qmaps=None):
    """Kernel K on (nb, bs) rows, as optim8_2state (qmaps: (state1's table,
    None)); returns new (p, state1, absmax1). ``launches_resident`` counts
    the launches of its resident body (blocks past 2048)."""
    if name not in ONE_STATE:
        raise ValueError(f"optim8_1state: {name!r} is not a 1-state optimizer")
    if not check_cuda_tensors("optim8_1state", g, p, s1, am1, scalars, u):
        return _kernel1_plain(name, scalars, g, p, s1, am1, u, qmaps)
    return _rows_launch("optim8_1state", name, g, p, (s1, am1), scalars, u, qmaps)


for _fn in (optim8_2state, optim8_1state):
    _fn.launches = _fn.launches_lut = _fn.launches_two_pass = 0
optim8_1state.launches_resident = 0
_KERNEL_OF = {"optim8_2state": optim8_2state, "optim8_1state": optim8_1state}


def optim8_blockwise_fused(optimizer_name: str, g, p, state1, absmax1, state2, absmax2,
                           scalars, u=None, qmap1=None, qmap2=None):
    """The JAX package's entry: rows (nb, bs) in, (p, state1, absmax1[,
    state2, absmax2]) out, through kernel J (2-state) or K (1-state) on
    CUDA tensors: the dynamic maps, or with ``qmap1`` (and ``qmap2`` for a
    2-state call) the LUT codec over tables that ``lut_table_ok`` accepts.
    Where the JAX entry returns None on a table (stochastic rounding, a
    2-state call without qmap2, a table it does not take) this raises
    ValueError; any row count and blocksize run."""
    two = state2 is not None
    qmaps = None
    if qmap1 is not None:
        if u is not None:
            raise ValueError("optim8_blockwise_fused: stochastic rounding (u) does not combine "
                             "with a table (qmap1)")
        if two and qmap2 is None:
            raise ValueError("optim8_blockwise_fused: a 2-state call with qmap1 needs qmap2")
        for q in (qmap1, qmap2) if two else (qmap1,):
            if not lut_table_ok(q):
                raise ValueError("optim8_blockwise_fused: a table must be (256,) finite and "
                                 "non-decreasing with at least two distinct values")
        qmaps = (qmap1, qmap2 if two else None)
    if two:
        return optim8_2state(optimizer_name, g, p, state1, absmax1, state2, absmax2, scalars, u,
                             qmaps)
    return optim8_1state(optimizer_name, g, p, state1, absmax1, scalars, u, qmaps)


def encode_sweep(device) -> tuple:
    """On the card: the codes of the kernels' encode (exponent-bit decade
    search, n / 0.9 rounded once) against the edge-by-edge encode with a
    division per value (the earlier body's), over all 2^32 f32 bit
    patterns of each map. Returns the mismatch counts (signed, unsigned)."""
    dev = torch.device(device)
    consts = torch.tensor(encode_consts(), dtype=torch.float32, device=dev)
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    fn = _build.kernel_fn("optim8_2state", "dyn8_encode_sweep", 4)
    _build.check("dyn8_encode_sweep", fn(kernel_table(dev).data_ptr(), consts.data_ptr(),
                                         out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    return tuple(int(v) for v in out.cpu())


def lut_rank_sweep(device, qmap1, qmap2) -> tuple:
    """On the card: the kernels' bucketed rank (csrc/dynamic8.cuh lut_rank)
    against the binary search over the midpoints (lut_rank_search) on all
    2^32 f32 bit patterns, for the LUT codecs of two tables. Returns the
    mismatch counts (one per table)."""
    dev = torch.device(device)
    table = _lut_table((_table_bytes(qmap1), _table_bytes(qmap2)), str(dev))
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    fn = _build.kernel_fn("optim8_2state", "lut_rank_sweep", 3)
    _build.check("lut_rank_sweep", fn(table.data_ptr(), out.data_ptr(),
                                      torch.cuda.current_stream(dev).cuda_stream))
    return tuple(int(v) for v in out.cpu())
