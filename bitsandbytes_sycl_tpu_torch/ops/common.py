"""Shared pieces of the ops: device choice, the kernel-layout 4-bit weight,
its quantizer, and small helpers.

A 4-bit linear weight W of logical shape (N out, K in), quantized in
blocks of ``blocksize`` along K, is stored as (the JAX package's layout,
kept as the interchange format so both packages hold identical bytes):

- ``packed``: uint8 (K//2, N), transposed planar: byte (j, n) holds the
  code of element (n, j) in the high nibble and of element (n, j + K//2)
  in the low nibble;
- ``absmax``: (2, K//(2*blocksize), N) float32 or bfloat16 block scales,
  plane 0 for elements [0, K/2), plane 1 for [K/2, K); or, with compressed
  statistics, uint8 dynamic-map codes of the same shape beside the f32
  (2, 1, N) sidecars ``absmax_scale`` and ``absmax_offset``
  (``compress_absmax``, ``decode_absmax``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import codebooks
from .. import functional as F
from ..types import QuantState

__all__ = [
    "resolve_device",
    "check_cuda_tensors",
    "QLinearWeight",
    "quantize_4bit_native",
    "pick_tile",
    "LaunchPlan",
    "split_k",
    "sm_count",
    "safe_inv",
    "ticket_buffer",
    "scratch_buffer",
    "decode_4bit",
    "compress_absmax",
    "decode_absmax",
    "fma_f32",
    "to_kernel_layout",
    "from_kernel_layout",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a CUDA device the caller must ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels"
        )
    return dev


def check_cuda_tensors(name: str, *tensors) -> bool:
    """True when every tensor lies on a CUDA device (the kernel runs),
    False when every tensor lies on the CPU (the plain version runs);
    raises on a mix or another device type."""
    types = {t.device.type for t in tensors if t is not None}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"{name}: tensors must all lie on the CPU or all on CUDA, got {types}")


def pick_tile(dim: int, candidates) -> Optional[int]:
    """Largest candidate dividing dim, or None (dim <= 0 is untileable)."""
    if dim <= 0:
        return None
    for c in candidates:
        if dim % c == 0:
            return c
    return None


safe_inv = F._safe_inv

H100_SMS = 132  # streaming multiprocessors of the H100 SXM


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once)."""
    return _sm_count(torch.cuda.current_device() if dev.index is None else dev.index)


_tickets = {}
_scratch = {}


def ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    """The per-tile counters of a kernel whose last CTA merges the others'
    partials (the split bodies of D, H and A): zeroed once per device and
    size; every launch leaves them at 0, so launches on one stream may
    share them."""
    key = (device.index, n)
    buf = _tickets.get(key)
    if buf is None:
        buf = _tickets[key] = torch.zeros((n,), dtype=torch.int32, device=device)
    return buf


def scratch_buffer(device: torch.device, n: int) -> torch.Tensor:
    """An f32 scratch of at least n floats for a kernel's split partials:
    one buffer per device, grown to the largest request. A launch writes
    its scratch before it reads it, and launches on one stream run one
    after another, so they may share it."""
    buf = _scratch.get(device.index)
    if buf is None or buf.numel() < n:
        buf = _scratch[device.index] = torch.empty((n,), dtype=torch.float32, device=device)
    return buf


def _ksplit(nbh: int, n_col_blocks: int, m_tiles: int, warps: int = 8):
    """(quant blocks per warp, K splits) so that the grid holds a few
    blocks per SM."""
    want = max(1, -(-264 // (n_col_blocks * m_tiles)))
    g = max(1, nbh // (warps * want))
    return g, -(-nbh // (warps * g))


class LaunchPlan(NamedTuple):
    """How a wrapper launches a kernel with more than one body: the body,
    rows and columns per CTA, K steps per split and the number of K
    splits. Split s covers steps [s * per, min((s + 1) * per, steps)) of
    each plane's packed rows; the grid is (N / bn, ceil(M / bm), ksplit)."""

    body: str
    bm: int
    per: int
    ksplit: int
    bn: int = 128


def split_k(tiles: int, steps: int, unit: int, sms: int, ctas_per_sm: int, step_us: float,
            split_us: float, part_us: float, min_per: int = 4):
    """(per, ksplit, est_us): K steps per split and the number of splits for
    ``tiles`` output tiles of ``steps`` K steps on ``sms`` SMs, each split a
    whole number of ``unit`` steps (one quantization block) and at least
    ``min_per`` steps. A launch is modelled as waves x per x ``step_us`` (a
    CTA's time per step) plus, with a split, ``split_us`` and ``part_us``
    for each split's partial tile; the constants are fitted to timed plans
    (``chip_smoke.py --probe``). The cheapest launch wins, the fewest
    splits among equals. The estimate ranks launches; it is no
    measurement."""
    best = None
    for ks in range(1, 17):
        per = -(-steps // ks)
        per = -(-per // unit) * unit
        if ks > 1 and per < min_per:
            break
        kse = -(-steps // per)
        waves = -(-(tiles * kse) // (sms * ctas_per_sm))
        est = waves * per * step_us
        if kse > 1:
            est += split_us + kse * tiles * part_us
        if best is None or (est, kse) < (best[2], best[1]):
            best = (per, kse, est)
    return best


def decode_4bit(codes: torch.Tensor, table, dtype=torch.float32) -> torch.Tensor:
    """16-entry table decode of uint8 nibble codes (values in [0, 16))."""
    t = torch.as_tensor(np.asarray(table, np.float32)).to(device=codes.device, dtype=dtype)
    return t[codes.long()]


def compress_absmax(absmax: torch.Tensor):
    """Compressed statistics (the JAX package's ``compress_absmax``): f32
    per-plane scales (2, nbh, N) -> uint8 signed dynamic-map codes of the
    scales less their column mean, and f32 (2, 1, N) sidecars: the range
    (largest centred magnitude) and the mean of each plane and column.
    The mean is ``torch.mean``'s, whose summation order can differ from
    JAX's in the last bit, and then a code by one step."""
    from .dynamic8 import dynamic_encode

    a = absmax.float()
    offset = a.mean(dim=1, keepdim=True)  # (2, 1, N)
    centered = a - offset
    scale = centered.abs().amax(dim=1, keepdim=True)  # (2, 1, N)
    codes = dynamic_encode(centered * safe_inv(scale), signed=True)
    return codes, scale, offset


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors rounded once to f32, as CUDA's
    ``__fmaf_rn``. The product is exact in float64; the float64 sum's
    rounding error comes back exactly by TwoSum, and decides the one case
    where rounding the float64 sum to f32 would round twice: a sum that
    lands exactly halfway between two f32 values."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    r = s.float()
    d = s - r.double()  # exact
    other = r.double() + 2.0 * d  # the neighbour across s, when s is a midpoint
    mid = (d != 0) & (other.float().double() == other)
    away = mid & (e != 0) & ((e > 0) == (d > 0))
    return torch.where(away, other.float(), r)


def decode_absmax(codes: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Inverse of ``compress_absmax``: ``fma(table[code], scale, offset)``
    rounded once, with ``table`` the port's dynamic-map decode
    (``ops.dynamic8.decode_table``, equal to the JAX package's eager
    decode). Kernels B and E compute the same with ``__fmaf_rn``, bit for
    bit. The JAX package's jitted decode differs by at most 2 ulps of the
    table value in 62 of the 256 codes (XLA contracts its decode chain
    into FMAs), and its eager decode rounds the product and the sum apart."""
    from .dynamic8 import decode_table

    table = decode_table(codes.device)[:256]
    return fma_f32(table[codes.long()], scale.float(), offset.float())


@dataclasses.dataclass(frozen=True)
class QLinearWeight:
    """Kernel-layout 4-bit linear weight (see the module docstring)."""

    packed: torch.Tensor  # uint8 (K//2, N), transposed planar
    absmax: torch.Tensor  # f32/bf16 (2, K//(2*blocksize), N) scales, or uint8 codes
    shape: Tuple[int, int]  # (N, K)
    blocksize: int
    quant_type: str
    dtype: str  # original dtype name, e.g. "float32"
    # compressed statistics only (absmax holds uint8 codes): the f32
    # (2, 1, N) range and mean of each plane and column
    absmax_scale: Optional[torch.Tensor] = None
    absmax_offset: Optional[torch.Tensor] = None

    @property
    def compressed(self) -> bool:
        return self.absmax_scale is not None

    @property
    def code(self) -> np.ndarray:
        return codebooks.get_4bit_type(self.quant_type, blocksize=self.blocksize)

    def to(self, device) -> "QLinearWeight":
        mv = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, packed=mv(self.packed), absmax=mv(self.absmax),
            absmax_scale=mv(self.absmax_scale), absmax_offset=mv(self.absmax_offset),
        )

    def scales_f32(self) -> torch.Tensor:
        """Per-plane f32 scales (2, nbh, N), decoding compression if any."""
        if self.compressed:
            return decode_absmax(self.absmax, self.absmax_scale, self.absmax_offset)
        return self.absmax.float()

    def dequantize(self) -> torch.Tensor:
        N, K = self.shape
        hi = decode_4bit(self.packed >> 4, self.code)  # elements [0, K/2)
        lo = decode_4bit(self.packed & 0xF, self.code)  # elements [K/2, K)
        w_t = torch.cat([hi, lo], dim=0)  # (K, N)
        scale = torch.repeat_interleave(
            self.scales_f32().reshape(K // self.blocksize, N), self.blocksize, dim=0)
        return (w_t * scale).T.to(getattr(torch, self.dtype))  # (N, K)


def quantize_4bit_native(
    W: torch.Tensor,
    blocksize: int = 64,
    quant_type: str = "nf4",
    compress_statistics: bool = False,
    absmax_dtype=torch.float32,
) -> QLinearWeight:
    """Quantize a (N, K) weight directly into kernel layout, bit-identical
    to the JAX package: it multiplies by safe_inv(absmax) (no division),
    and with bf16 or compressed scales (``compress_statistics``: uint8
    dynamic-map codes and two f32 sidecars per plane and column, the QLoRA
    paper's double quantization) it renormalizes against the decoded
    scales and clips to [-1, 1] so the codes absorb the scale rounding.
    Compressed, the codes can differ from the JAX package's where the two
    decoded scales do (``decode_absmax``)."""
    N, K = W.shape
    if K % (2 * blocksize) != 0:
        raise ValueError(f"K={K} must be divisible by 2*blocksize={2*blocksize}")
    _table, _s, order, mids = F._code_arrays(None, quant_type)
    blocks = W.float().reshape(N, K // blocksize, blocksize)
    absmax = blocks.abs().amax(dim=2)  # (N, K//bs)
    normed = blocks * F._safe_inv(absmax)[:, :, None]
    amax = absmax.T.reshape(2, K // (2 * blocksize), N)
    am_scale = am_offset = None
    if compress_statistics or absmax_dtype != torch.float32:
        if compress_statistics:
            amax, am_scale, am_offset = compress_absmax(amax)
            dec = decode_absmax(amax, am_scale, am_offset)
        else:
            amax = amax.to(absmax_dtype)
            dec = amax.float()
        absmax_d = dec.reshape(K // blocksize, N).T  # (N, K//bs)
        normed = (blocks * F._safe_inv(absmax_d)[:, :, None]).clamp(-1.0, 1.0)
    codes = F._encode_nearest(normed.reshape(N, K), mids, order)
    packed = (codes[:, : K // 2].T << 4 | codes[:, K // 2:].T).to(torch.uint8).contiguous()
    return QLinearWeight(
        packed=packed,
        absmax=amax.contiguous(),
        shape=(N, K),
        blocksize=blocksize,
        quant_type=quant_type,
        dtype=F._dtype_name(W.dtype),
        absmax_scale=am_scale,
        absmax_offset=am_offset,
    )


def to_kernel_layout(data: torch.Tensor, quant_state: QuantState,
                     compress: Optional[bool] = None) -> QLinearWeight:
    """Lossless repack of a bnb-format 4-bit weight (flat paired nibbles,
    flat absmax) into the kernel layout. ``compress`` keeps the scales
    8-bit (default: the state's own nesting): the decoded absmax is
    recompressed per plane and column by ``compress_absmax``. The nibble
    codes are kept exactly, and so are raw f32 scales."""
    if compress is None:
        compress = quant_state.nested
    N, K = quant_state.shape
    bs = quant_state.blocksize
    codes = F.unpack_4bit(data.reshape(-1), N * K).reshape(N, K)
    packed = (codes[:, : K // 2].T << 4 | codes[:, K // 2:].T).to(torch.uint8).contiguous()
    absmax = quant_state.dequant_absmax().float().reshape(N, K // bs)
    amax = absmax.T.reshape(2, K // (2 * bs), N).contiguous()
    am_scale = am_offset = None
    if compress:
        amax, am_scale, am_offset = compress_absmax(amax)
        amax = amax.contiguous()
    return QLinearWeight(packed=packed, absmax=amax, shape=(N, K), blocksize=bs,
                         quant_type=quant_state.quant_type, dtype=quant_state.dtype,
                         absmax_scale=am_scale, absmax_offset=am_offset)


def from_kernel_layout(w: QLinearWeight):
    """Inverse of to_kernel_layout: (flat paired nibbles, QuantState with
    the decoded f32 absmax) in bnb format."""
    N, K = w.shape
    codes = torch.cat([(w.packed >> 4).T, (w.packed & 0xF).T], dim=1).reshape(-1)
    qs = QuantState(
        absmax=w.scales_f32().reshape(K // w.blocksize, N).T.reshape(-1).contiguous(),
        code=torch.from_numpy(np.array(w.code, np.float32)).to(w.packed.device),
        shape=(N, K), dtype=w.dtype, blocksize=w.blocksize, quant_type=w.quant_type)
    return F.pack_4bit(codes.to(torch.uint8)), qs
