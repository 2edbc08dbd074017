"""Arithmetic codec of the 8-bit dynamic map, the port of the JAX package's
``ops/dynamic8.py``.

The dynamic map (arxiv 1511.04561, ``codebooks.create_dynamic_map``) is
sign x 10^(decade - 6) x a linear fraction. In the ascending table the
positive rank r encodes (decade i, fraction j) positionally:

  signed   : i = floor(log2 r),       j = r - 2^i,       n = 2^i
  unsigned : i = floor(log2(r+1)) - 1, j = r - (2^(i+1) - 1), n = 2^(i+1)
  value    = 10^(i-6) * (0.1 + (j + 0.5) * 0.9 / n)
  rank 0 -> 0.0; the top rank (128 signed, 255 unsigned) -> 1.0

Decode is that formula in f32; its values differ from the float64-built
table by up to 2 ulps, so every consumer (the optimizer kernels J and K
included) decodes through this arithmetic, or through a table made by
running it on all 256 codes (``decode_table``), never through
``create_dynamic_map``. Encode rounds to nearest by the same arithmetic
(decade by comparison with the decade edges, then ``ceil(y) - 1`` on the
uniform in-decade grid), whose ties differ from a search over midpoints.

Every division is by a tensor on the operand's device: PyTorch's CUDA
division by a Python scalar multiplies by its rounded reciprocal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import codebooks

__all__ = ["dynamic_decode", "dynamic_encode", "stochastic_adjust", "decode_table", "encode_consts",
           "binade_table", "decade_table", "edge_count", "kernel_table"]


@functools.lru_cache(maxsize=None)
def _consts(signed: bool):
    """(decade edges (7,) f32, top edge, top rank) from the table's structure."""
    table = codebooks.create_dynamic_map(signed=signed)
    assert table.shape == (256,) and np.all(np.diff(table) > 0)
    zero_idx = int(np.where(table == 0.0)[0][0])
    assert zero_idx == (127 if signed else 0)
    assert table[-1] == 1.0
    pos = table[zero_idx:]  # pos[r] = value at positive rank r
    top_rank = len(pos) - 1
    decade_last = [2 ** (i + 1) - 1 if signed else 2 ** (i + 2) - 2 for i in range(7)]
    edges = [0.5 * (pos[0] + pos[1])]
    for i in range(6):
        r = decade_last[i]
        edges.append(0.5 * (pos[r] + pos[r + 1]))
    top_edge = 0.5 * (pos[top_rank - 1] + pos[top_rank])
    return np.float32(edges), np.float32(top_edge), top_rank


_POW10 = tuple(float(np.float32(10.0) ** (k - 6)) for k in range(8))
_POW10_INV = tuple(float(np.float32(10.0) ** (6 - k)) for k in range(8))


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _exp2i(i: torch.Tensor) -> torch.Tensor:
    """Exact 2^i (f32) for small non-negative int32 i, from exponent bits."""
    return ((i + 127) << 23).to(torch.int32).view(torch.float32)


def _floor_log2(r: torch.Tensor) -> torch.Tensor:
    """floor(log2 r) for int r >= 1, from the f32 exponent field."""
    return ((r.to(torch.float32).view(torch.int32) >> 23) & 0xFF) - 127


def _take(values, i: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=i.device)[i.long()]


def dynamic_decode(codes: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """uint8 sorted-table index -> f32 value of the dynamic map."""
    _, _, top_rank = _consts(signed)
    c = codes.to(torch.int32)
    if signed:
        r = (c - 127).abs()
        sgn = torch.where(c < 127, _f32(-1.0, c), _f32(1.0, c))
    else:
        r = c
        sgn = _f32(1.0, c)
    r1 = r.clamp_min(1)
    if signed:
        i = _floor_log2(r1)
        n = _exp2i(i)
        j = r1.to(torch.float32) - n
    else:
        i = _floor_log2(r1 + 1) - 1
        n = _exp2i(i + 1)
        j = r1.to(torch.float32) - (n - 1.0)
    frac = _f32(0.1, c) + (j + 0.5) * (_f32(0.9, c) / n)
    val = sgn * _take(_POW10, i) * frac
    val = torch.where(r == 0, _f32(0.0, c), val)
    return torch.where(r >= top_rank, sgn * 1.0, val)


def dynamic_encode(x: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """f32 value in [-1, 1] ([0, 1] unsigned) -> uint8 sorted-table index,
    to nearest (a value exactly on an in-decade threshold goes down)."""
    edges, top_edge, top_rank = _consts(signed)
    x = x.to(torch.float32)
    a = x.abs() if signed else torch.maximum(x, _f32(0.0, x))
    a = torch.minimum(a, _f32(1.0, x))
    cnt = sum((_f32(float(e), x) < a).to(torch.int32) for e in edges)
    i = (cnt - 1).clamp_min(0)
    if signed:
        n = _exp2i(i)
        base = n
    else:
        n = _exp2i(i + 1)
        base = n - 1.0
    y = (a * _take(_POW10_INV, i) - _f32(0.1, x)) * (n / _f32(0.9, x))
    j = torch.minimum(torch.maximum(torch.ceil(y) - 1.0, _f32(0.0, x)), n - 1.0)
    r = (base + j).to(torch.int32)
    r = torch.where(cnt == 0, torch.zeros_like(r), r)
    r = torch.where(a > float(top_edge), torch.full_like(r, top_rank), r)
    if signed:
        # the table has +1.0 (rank 128) but no -1.0: negative magnitudes
        # clamp at rank 127, code 0
        r = torch.where(x < 0, 127 - r.clamp_max(127), 127 + r)
    return r.to(torch.uint8)


def stochastic_adjust(codes: torch.Tensor, x: torch.Tensor, u: torch.Tensor,
                      signed: bool = True) -> torch.Tensor:
    """Unbiased stochastic rounding over the dynamic map: ``codes`` are the
    round-to-nearest codes of ``x`` and ``u`` is uniform in [0, 1); the
    code steps to the bracketing neighbour with probability
    |x - v_near| / |v_next - v_near|, so E[decode(result)] == x. Values
    outside the grid keep the clamped nearest code."""
    c = codes.to(torch.int32)
    v_c = dynamic_decode(codes, signed=signed)
    xf = x.to(torch.float32)
    step = torch.where(xf > v_c, 1, -1).to(torch.int32)
    c2 = (c + step).clamp(0, 255)
    v_n = dynamic_decode(c2.to(torch.uint8), signed=signed)
    denom = v_n - v_c
    prob = torch.where(denom != 0.0, (xf - v_c) / torch.where(denom != 0.0, denom, _f32(1.0, x)),
                       _f32(0.0, x))
    prob = prob.clamp(0.0, 1.0)
    return torch.where(u < prob, c2, c).to(torch.uint8)


_TABLES: dict = {}


def decode_table(device) -> torch.Tensor:
    """(512,) f32 on ``device``: dynamic_decode of codes 0..255 signed, then
    unsigned, computed on that device (the first words of ``kernel_table``)."""
    dev = torch.device(device)
    key = str(dev)
    t = _TABLES.get(key)
    if t is None:
        codes = torch.arange(256, dtype=torch.int32, device=dev).to(torch.uint8)
        t = torch.cat([dynamic_decode(codes, True), dynamic_decode(codes, False)]).contiguous()
        _TABLES[key] = t
    return t


@functools.lru_cache(maxsize=None)
def encode_consts() -> tuple:
    """The constants of the edge-by-edge encode, 23 floats: the signed
    map's 7 decade edges and top edge, the unsigned map's, and 10^(6-i)
    for decades i = 0..6 (the card's exhaustive check of ``binade_table``
    runs that encode beside the kernels' one)."""
    out = []
    for signed in (True, False):
        edges, top_edge, _ = _consts(signed)
        out += [float(e) for e in edges] + [float(top_edge)]
    return tuple(out + list(_POW10_INV[:7]))


NAN_BINADE = 128  # the binade_table row every NaN reads


@functools.lru_cache(maxsize=None)
def binade_table(signed: bool) -> np.ndarray:
    """(129, 2) f32: the decade search by exponent bits. Row e (the f32
    exponent field of a magnitude in [0, 1]) holds the number of decade
    edges below the binade [2^(e-127), 2^(e-126)) (row 0: [0, 2^-126)) and
    the one edge inside it, or +inf; row 128 (0, +inf) serves NaN. The
    edges lie more than a factor 2 apart, so a binade holds at most one,
    and count_lo + (a > edge) equals the number of edges below a."""
    edges, _, _ = _consts(signed)
    out = np.zeros((NAN_BINADE + 1, 2), np.float32)
    out[:, 1] = np.inf
    for e in range(NAN_BINADE):
        lo = np.float32(0.0) if e == 0 else np.uint32(e << 23).view(np.float32)
        hi = np.uint32((e + 1) << 23).view(np.float32)
        inside = [x for x in edges if lo <= x < hi]
        assert len(inside) <= 1, (e, inside)
        out[e, 0] = np.sum(edges < lo)
        if inside:
            out[e, 1] = inside[0]
    return out


def edge_count(a: np.ndarray, signed: bool) -> np.ndarray:
    """The number of decade edges below each magnitude a (f32 in [0, 1] or
    NaN) by ``binade_table``, as the kernels compute it."""
    a = np.asarray(a, np.float32)
    tab = binade_table(signed)
    e = np.minimum((a.view(np.uint32) >> 23) & 0xFF, NAN_BINADE)
    return tab[e, 0].astype(np.int32) + (a > tab[e, 1])


@functools.lru_cache(maxsize=None)
def decade_table(signed: bool) -> np.ndarray:
    """(7, 2) f32: per decade i, 10^(6-i) and n / 0.9 rounded once in f32
    (n = 2^i signed, 2^(i+1) unsigned), the factors of the in-decade grid
    y = (a * 10^(6-i) - 0.1) * (n / 0.9)."""
    n = np.float32([2.0 ** (i if signed else i + 1) for i in range(7)])
    return np.stack([np.float32(_POW10_INV[:7]), n / np.float32(0.9)], axis=1).astype(np.float32)


# word offsets of kernel_table's parts (csrc/dynamic8.cuh mirrors them)
KERNEL_TABLE_PARTS = dict(dec_s=0, dec_u=256, bin_s=512, bin_u=770, decade_s=1028, decade_u=1042,
                          top_s=1056, top_u=1057, words=1058)


def kernel_table(device) -> torch.Tensor:
    """(1058,) f32 on ``device``, what kernels J and K copy into shared
    memory once per CTA: ``decode_table``, then ``binade_table`` (its
    counts stored as int32 bits) and ``decade_table`` of the signed and the
    unsigned map, then their top edges (KERNEL_TABLE_PARTS)."""
    dev = torch.device(device)
    key = ("kernel", str(dev))
    t = _TABLES.get(key)
    if t is None:
        def bins(signed):  # the counts as int32 bits, which the kernels read as ints
            t = binade_table(signed).copy()
            t[:, 0] = t[:, 0].astype(np.int32).view(np.float32)
            return t.reshape(-1)

        host = np.concatenate(
            [bins(True), bins(False),
             decade_table(True).reshape(-1), decade_table(False).reshape(-1),
             np.float32([_consts(True)[1], _consts(False)[1]])]).astype(np.float32)
        t = torch.cat([decode_table(dev), torch.from_numpy(host).to(dev)]).contiguous()
        assert t.numel() == KERNEL_TABLE_PARTS["words"]
        _TABLES[key] = t
    return t
