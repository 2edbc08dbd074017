"""Shared pieces of the ops: device choice, the kernel-layout 4-bit weight,
its quantizer, and small helpers.

A 4-bit linear weight W of logical shape (N out, K in), quantized in
blocks of ``blocksize`` along K, is stored as (the JAX package's layout,
kept as the interchange format so both packages hold identical bytes):

- ``packed``: uint8 (K//2, N), transposed planar: byte (j, n) holds the
  code of element (n, j) in the high nibble and of element (n, j + K//2)
  in the low nibble;
- ``absmax``: (2, K//(2*blocksize), N) float32 or bfloat16 block scales,
  plane 0 for elements [0, K/2), plane 1 for [K/2, K).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import codebooks
from .. import functional as F

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
    raise NotImplementedError(
        "compressed statistics (dynamic-8 absmax codes) are not ported yet (ROADMAP Queue A #1)")


def decode_absmax(codes, scale, offset):
    raise NotImplementedError(
        "compressed statistics (dynamic-8 absmax codes) are not ported yet (ROADMAP Queue A #1)")


@dataclasses.dataclass(frozen=True)
class QLinearWeight:
    """Kernel-layout 4-bit linear weight (see the module docstring)."""

    packed: torch.Tensor  # uint8 (K//2, N), transposed planar
    absmax: torch.Tensor  # f32/bf16 (2, K//(2*blocksize), N)
    shape: Tuple[int, int]  # (N, K)
    blocksize: int
    quant_type: str
    dtype: str  # original dtype name, e.g. "float32"
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
        """Per-plane f32 scales (2, nbh, N)."""
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
    and with bf16 scales it renormalizes against the rounded scales and
    clips to [-1, 1] so the codes absorb the scale rounding."""
    N, K = W.shape
    if K % (2 * blocksize) != 0:
        raise ValueError(f"K={K} must be divisible by 2*blocksize={2*blocksize}")
    if compress_statistics:
        compress_absmax(None)
    _table, _s, order, mids = F._code_arrays(quant_type)
    blocks = W.float().reshape(N, K // blocksize, blocksize)
    absmax = blocks.abs().amax(dim=2)  # (N, K//bs)
    normed = blocks * F._safe_inv(absmax)[:, :, None]
    amax = absmax.T.reshape(2, K // (2 * blocksize), N)
    if absmax_dtype != torch.float32:
        amax = amax.to(absmax_dtype)
        absmax_d = amax.float().reshape(K // blocksize, N).T  # (N, K//bs)
        normed = (blocks * F._safe_inv(absmax_d)[:, :, None]).clamp(-1.0, 1.0)
    codes = F._encode_nearest(normed.reshape(N, K), mids, order)
    packed = (codes[:, : K // 2].T << 4 | codes[:, K // 2:].T).to(torch.uint8).contiguous()
    return QLinearWeight(
        packed=packed,
        absmax=amax.contiguous(),
        shape=(N, K),
        blocksize=blocksize,
        quant_type=quant_type,
        dtype=str(W.dtype).replace("torch.", ""),
    )
