"""Quantization codebooks (numpy, host side).

The port's own copy of the JAX package's ``codebooks.py``. The 16-entry
tables are in code order (index = 4-bit code), normalized to [-1, 1]; FP4
is non-monotone, NF4/int4/af4 are monotone. The 256-entry maps of the
8-bit optimizer states (dynamic, linear, normal, fp8, quantile) are sorted
ascending; a sub-256 map is padded with zeros (``_pad_sorted_to_256``).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

__all__ = ["NF4_CODE", "FP4_CODE", "FP4_SORT_ORDER", "get_4bit_type", "code_midpoints",
           "create_dynamic_map", "create_linear_map", "create_normal_map", "create_fp8_map",
           "create_quantile_map"]

# NF4 of the QLoRA paper (arxiv 2305.14314): equal-area bins under N(0, 1)
NF4_CODE = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)

# FP4 (e2m1, bias 3) in code order, normalized by its absmax (12)
FP4_CODE = np.array([0.0, 0.0625, 8.0, 12.0, 4.0, 6.0, 2.0, 3.0], dtype=np.float32) / 12.0
FP4_CODE = np.concatenate([FP4_CODE, -FP4_CODE]).astype(np.float32)

# the 3-bit codes of FP4's positive half in ascending value order (sorted
# rank -> code)
FP4_SORT_ORDER = np.argsort(FP4_CODE[:8]).astype(np.int32)

# AF4 (arxiv 2306.06965), blocksize-64 table, stored in code order
_AF4_RAW = np.array(
    [
        -1.0,
        -0.69441008,
        -0.51243739,
        -0.3736951,
        -0.25607552,
        -0.14982478,
        -0.04934812,
        0.0,
        0.04273164,
        0.12934483,
        0.21961274,
        0.31675666,
        0.42563882,
        0.55496234,
        0.72424863,
        1.0,
    ],
    dtype=np.float32,
)[::-1]


def get_4bit_type(typename: str, blocksize: int = 64) -> np.ndarray:
    """16-entry 4-bit codebook in code order, normalized to [-1, 1]."""
    if typename == "nf4":
        data = NF4_CODE
    elif typename == "fp4":
        data = FP4_CODE
    elif typename == "int4":
        # index 8 holds -0.0, so the table's sort order puts it before +0.0
        data = np.array(
            [7, 6, 5, 4, 3, 2, 1, 0, -0.0, -1, -2, -3, -4, -5, -6, -7],
            dtype=np.float32,
        )
    elif typename == "af4":
        if blocksize != 64:
            raise NotImplementedError("AF4 only supports blocksize 64.")
        data = _AF4_RAW
    else:
        raise NotImplementedError(f"4-bit type {typename!r} not supported")
    data = np.asarray(data, dtype=np.float32)
    return data / np.abs(data).max()


def code_midpoints(code_sorted: np.ndarray) -> np.ndarray:
    """Decision boundaries between adjacent sorted entries; encoding is
    ``searchsorted(mids, x, side='left')``, so ties go to the lower code."""
    code_sorted = np.asarray(code_sorted, dtype=np.float32)
    return ((code_sorted[1:] + code_sorted[:-1]) / 2.0).astype(np.float32)


def _pad_sorted_to_256(values) -> np.ndarray:
    """A sub-256 map padded with zeros and sorted, as f32 (256,)."""
    values = list(values)
    values.extend([0.0] * (256 - len(values)))
    return np.sort(np.asarray(values, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def create_dynamic_map(signed: bool = True, max_exponent_bits: int = 7,
                       total_bits: int = 8) -> np.ndarray:
    """Dynamic-exponent 8-bit data type (arxiv 1511.04561), sorted ascending,
    256 entries: a sign bit (if signed), a unary decade prefix and linear
    fraction bits, built in float64 and stored as float32."""
    non_sign_bits = total_bits - 1
    additional_items = 2 ** (non_sign_bits - max_exponent_bits) - 1
    data: list = []
    for i in range(max_exponent_bits):
        n_frac = 2 ** (i + non_sign_bits - max_exponent_bits + (0 if signed else 1))
        boundaries = np.linspace(0.1, 1.0, n_frac + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        scale = 10.0 ** (-(max_exponent_bits - 1) + i)
        data.extend((scale * means).tolist())
        if signed:
            data.extend((-scale * means).tolist())
    if additional_items > 0:
        boundaries = np.linspace(0.1, 1.0, additional_items + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data.extend(means.tolist())
        if signed:
            data.extend((-means).tolist())
    data.extend([0.0, 1.0])
    assert len(data) == 2 ** total_bits
    return _pad_sorted_to_256(data)


@functools.lru_cache(maxsize=None)
def create_linear_map(signed: bool = True, total_bits: int = 8, add_zero: bool = True) -> np.ndarray:
    """Evenly spaced map over [-1, 1] (or [0, 1] unsigned); fewer than 256
    values get zeros in the middle."""
    sign = -1.0 if signed else 0.0
    total_values = 2 ** total_bits
    if add_zero or total_bits < 8:
        total_values = 2 ** total_bits if not signed else 2 ** total_bits - 1
    values = np.linspace(sign, 1.0, total_values, dtype=np.float64)
    gap = 256 - values.size
    if gap == 0:
        return values.astype(np.float32)
    half = values.size // 2
    return np.concatenate([values[:half], np.zeros(gap), values[half:]]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def create_normal_map(offset: float = 0.9677083, use_extra_value: bool = True) -> np.ndarray:
    """The 256-entry normal-float map NF4 derives from: N(0, 1) quantiles
    with ``offset`` tail mass, an extra positive value, zeros between."""
    from scipy.stats import norm

    if use_extra_value:
        v1 = norm.ppf(np.linspace(offset, 0.5, 9)[:-1]).tolist()
        v2 = [0.0] * (256 - 15)
    else:
        v1 = norm.ppf(np.linspace(offset, 0.5, 8)[:-1]).tolist()
        v2 = [0.0] * (256 - 14)
    v3 = (-norm.ppf(np.linspace(offset, 0.5, 8)[:-1])).tolist()
    values = np.sort(np.asarray(v1 + v2 + v3))
    values = values / values.max()
    assert values.size == 256
    return values.astype(np.float32)


@functools.lru_cache(maxsize=None)
def create_fp8_map(signed: bool = True, exponent_bits: int = 5, precision_bits: int = 2,
                   total_bits: int = 8) -> np.ndarray:
    """An ExMy float map normalized to [-1, 1], zero-padded to 256."""
    e, p = exponent_bits, precision_bits
    assert e + p == total_bits - (1 if signed else 0)
    bias = 2 ** (e - 1)
    values: list = []
    for evalue in range(2 ** e):
        for pattern in itertools.product([0, 1], repeat=p):
            value = 1.0 if evalue != 0 else 0.0
            for i, pbit in enumerate(pattern):
                value += pbit * 2.0 ** (-(i + 1))
            if evalue == 0:
                value = value * 2.0 ** (-bias)  # subnormals
            else:
                value = value * 2.0 ** (-(evalue - bias - 1))  # normals
            values.append(value)
            if signed:
                values.append(-value)
    assert len(values) == 2 ** total_bits
    values.sort()
    if total_bits < 8:
        values.extend([0.0] * (256 - len(values)))
    code = np.sort(np.asarray(values))
    return (code / code.max()).astype(np.float32)


def create_quantile_map(A, total_bits: int = 8) -> np.ndarray:
    """A map from the empirical quantiles of ``A`` (numpy or a tensor) at
    the 2^bits - 1 eCDF midpoints, with 0.0, padded, sorted and normalized
    by the largest magnitude."""
    if hasattr(A, "detach"):
        A = A.detach().cpu().numpy()
    n_q = 2 ** total_bits - 1
    probs = (np.arange(n_q) + 0.5) / n_q
    q = np.quantile(np.asarray(A, dtype=np.float32).ravel(), probs).tolist()
    q.append(0.0)
    q.extend([0.0] * (256 - len(q)))
    q = np.sort(np.asarray(q))
    return (q / np.abs(q).max()).astype(np.float32)
