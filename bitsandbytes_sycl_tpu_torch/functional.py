"""The JAX package's ``functional.py`` in PyTorch: codebook encode and
4-bit packing, blockwise 8-bit quantization (the dynamic maps, the linear
and fp8 maps, any user codebook, nested absmax, stochastic rounding), the
4-bit quantizers in bnb byte order and their dequantizers, whole-tensor
quantization, the 4-bit matmul routes (``gemv_4bit``: kernels B and E
through a cached repack to the kernel layout), the LLM.int8 functions,
``int8_double_quant``, ``estimate_quantiles``, the optimizer updates
(32-bit; blockwise 8-bit with the dynamic maps or any 256-entry table; the
global-max 8-bit update, one block over the whole tensor; percentile
clipping) and ``histogram_scatter_add_2d``.

Codebook encode rounds to nearest with strict-``>`` midpoint thresholds: an
input exactly on a midpoint goes to the lower code, NaN encodes as 0.0.
The dynamic maps encode and decode by their arithmetic codec
(``ops/dynamic8.py``), other codebooks through their table. Stochastic
rounding draws its uniforms from a ``torch.Generator`` on the input's
device, not from the JAX PRNG: the same expectation, other bits.

Nested statistics (``nested=True``, ``compress_statistics=True``) subtract
``torch.mean`` of the absmax, whose summation order can differ from
``jnp.mean``'s in the last bit; a nested code then moves by one step.

LLM.int8 (vector-wise int8 weights ``CB`` (N, K) with row scales ``SCB``,
per-row int8 activations, an fp sidecar over outlier columns) keeps the
JAX package's rounding points: ``round`` is half to even, every ``/ 127``
divides by a tensor (``_div127``), and the int8 product is exact (float64
on the CPU, ``torch._int_mm`` on the card).
"""

from __future__ import annotations

import functools
import warnings
import weakref
from typing import Optional

import numpy as np
import torch

from . import codebooks
from .types import FOUR_BIT_TYPES, QTensor, QuantState, blocks_for

__all__ = [
    "quantize_blockwise", "dequantize_blockwise", "quantize_4bit", "dequantize_4bit",
    "quantize_fp4", "quantize_nf4", "dequantize_fp4", "dequantize_nf4", "quantize",
    "dequantize", "quantize_no_absmax", "dequantize_no_absmax", "pack_4bit", "unpack_4bit", "get_colrow_absmax", "int8_vectorwise_quant", "int8_double_quant",
    "int8_linear_matmul", "int8_mm_dequant", "llm_int8_prepare_outliers", "llm_int8_matmul",
    "matmul_4bit_ref", "gemv_4bit", "estimate_quantiles", "blocks_for", "OPTIMIZER_FUNCS_2STATE",
    "OPTIMIZER_FUNCS_1STATE", "optimizer_update_32bit", "optimizer_update_8bit_blockwise",
    "optimizer_update_8bit_blockwise_sharded",
    "optimizer_update_8bit", "percentile_clipping", "histogram_scatter_add_2d",
]

_DYNAMIC_TYPES = ("dynamic", "dynamic_unsigned")


def _default_8bit_code() -> np.ndarray:
    return codebooks.create_dynamic_map()  # the signed dynamic map, cached


@functools.lru_cache(maxsize=None)
def _sorted_code_and_perm(quant_type: str, blocksize: int = 64):
    """(sorted codebook values, permutation sorted-rank -> code index,
    midpoints between sorted values, code-order table), all numpy."""
    if quant_type in FOUR_BIT_TYPES:
        code = codebooks.get_4bit_type(quant_type, blocksize=blocksize)
    elif quant_type == "dynamic":
        code = _default_8bit_code()
    elif quant_type == "dynamic_unsigned":
        code = codebooks.create_dynamic_map(signed=False)
    elif quant_type == "linear":
        code = codebooks.create_linear_map()
    elif quant_type == "fp8":
        code = codebooks.create_fp8_map()
    else:
        raise ValueError(f"unknown quant_type {quant_type!r}")
    order = np.argsort(code, kind="stable").astype(np.int32)
    sorted_code = code[order]
    mids = codebooks.code_midpoints(sorted_code)
    return sorted_code, order, mids, code


def _code_arrays(code, quant_type: str):
    """(code-order table, sorted values, rank->code perm, midpoints), all
    numpy, of the named codebook or of ``code`` (numpy or a tensor)."""
    if code is None:
        sorted_code, order, mids, table = _sorted_code_and_perm(quant_type)
        return table, sorted_code, order, mids
    if isinstance(code, torch.Tensor):
        code = code.detach().cpu().numpy()
    cnp = np.asarray(code, np.float32)
    order = np.argsort(cnp, kind="stable").astype(np.int32)
    sorted_code = cnp[order]
    mids = ((sorted_code[1:] + sorted_code[:-1]) / 2.0).astype(np.float32)
    return cnp, sorted_code, order, mids


def _is_identity(order: np.ndarray) -> bool:
    return np.array_equal(order, np.arange(order.shape[0]))


def _encode_nearest(x: torch.Tensor, mids: np.ndarray, order: np.ndarray) -> torch.Tensor:
    """Nearest-codebook encode of f32 ``x`` to uint8 codes.

    rank = #{mids < x} (``searchsorted`` side left); ``order`` maps the
    rank to the code index (identity for monotone codebooks)."""
    x = torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype, device=x.device), x)
    m = torch.from_numpy(np.ascontiguousarray(mids)).to(x.device)
    rank = torch.searchsorted(m, x.contiguous(), right=False)
    if not _is_identity(order):
        rank = torch.from_numpy(order.astype(np.int64)).to(x.device)[rank]
    return rank.to(torch.uint8)


def _encode_stochastic(x: torch.Tensor, sorted_code: np.ndarray, order: np.ndarray,
                       generator: torch.Generator) -> torch.Tensor:
    """Stochastic codebook encode: each value goes to one of its two
    bracketing entries with probability proportional to proximity, so the
    expectation is the value (within the codebook's range). The uniforms
    come from ``generator``, on x's device. NaN encodes as 0.0."""
    x = torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype, device=x.device), x)
    s = torch.from_numpy(np.ascontiguousarray(sorted_code)).to(x.device)
    last = s.shape[0] - 1
    lo_rank = torch.clamp(torch.searchsorted(s, x.contiguous(), right=True) - 1, 0, last)
    hi_rank = torch.clamp(lo_rank + 1, max=last)
    lo, hi = s[lo_rank], s[hi_rank]
    span = hi - lo
    p = torch.where(span > 0, (x - lo) / torch.where(span > 0, span, torch.ones_like(span)),
                    torch.zeros_like(span))
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    rank = torch.where(u < p.clamp(0.0, 1.0), hi_rank, lo_rank)
    if not _is_identity(order):
        rank = torch.from_numpy(order.astype(np.int64)).to(x.device)[rank]
    return rank.to(torch.uint8)


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    ok = x > 0
    return torch.where(ok, 1.0 / torch.where(ok, x, torch.ones_like(x)), torch.zeros_like(x))


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, correctly rounded on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its rounded reciprocal instead."""
    return t / torch.tensor(127.0, dtype=t.dtype, device=t.device)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _as_torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _table_on(code, device) -> torch.Tensor:
    """A codebook (None: the signed dynamic map; numpy or a tensor) as f32
    on ``device``."""
    if code is None:
        code = _default_8bit_code()
    if isinstance(code, torch.Tensor):
        return code.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(code, np.float32)).to(device)


def pack_4bit(codes: torch.Tensor) -> torch.Tensor:
    """Pack flat 4-bit codes two per byte: element 2i high, 2i+1 low."""
    if codes.shape[0] % 2:
        codes = torch.cat([codes, codes.new_zeros(1)])
    pairs = codes.reshape(-1, 2)
    return (pairs[:, 0] << 4 | pairs[:, 1]).to(torch.uint8)


def unpack_4bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of pack_4bit; returns flat (n,) uint8 codes."""
    codes = torch.stack([packed >> 4, packed & 0x0F], dim=-1).reshape(-1)
    return codes[:n]


def _blockwise_stats(A: torch.Tensor, blocksize: int):
    """Flatten to f32, zero-pad to whole blocks: (blocks (nb, bs), absmax
    (nb,), n)."""
    flat = A.reshape(-1).float()
    n = flat.shape[0]
    pad = blocks_for(n, blocksize) * blocksize - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, blocksize)
    return blocks, blocks.abs().amax(dim=1), n


def _nest_absmax(absmax: torch.Tensor):
    """The nested level: (uint8 codes of absmax less its mean, blockwise
    8-bit at blocksize 256, their QuantState, the mean)."""
    offset = absmax.mean()
    qabsmax, state2 = quantize_blockwise(absmax - offset, blocksize=256)
    return qabsmax, state2, offset


# ---------------------------------------------------------------------------
# blockwise 8-bit quantization
# ---------------------------------------------------------------------------


def quantize_blockwise(
    A: torch.Tensor,
    code=None,
    blocksize: int = 4096,
    nested: bool = False,
    quant_type: str = "dynamic",
    generator: Optional[torch.Generator] = None,
):
    """Blockwise 8-bit quantization with a per-block f32 absmax: (uint8
    codes in A's shape, QuantState). ``quant_type`` names the codebook
    ("dynamic", "dynamic_unsigned", "linear", "fp8") unless ``code`` (256
    values) is given, which the state records as "custom". ``nested``
    requantizes the absmax less its mean blockwise at 256. A ``generator``
    rounds stochastically between the bracketing entries."""
    table, sorted_code, order, mids = _code_arrays(code, quant_type)
    blocks, absmax, n = _blockwise_stats(A, blocksize)
    normed = blocks * _safe_inv(absmax)[:, None]
    if generator is not None:
        codes = _encode_stochastic(normed, sorted_code, order, generator)
    elif code is None and quant_type in _DYNAMIC_TYPES:
        from .ops.dynamic8 import dynamic_encode

        codes = dynamic_encode(normed, signed=quant_type == "dynamic")
    else:
        codes = _encode_nearest(normed, mids, order)
    out = codes.reshape(-1)[:n].reshape(A.shape)
    offset = state2 = None
    qabsmax = absmax
    if nested:
        qabsmax, state2, offset = _nest_absmax(absmax)
    state = QuantState(
        absmax=qabsmax, code=_table_on(table, A.device),
        shape=tuple(A.shape), dtype=_dtype_name(A.dtype), blocksize=blocksize,
        quant_type=quant_type if code is None else "custom", offset=offset, state2=state2)
    return out, state


def dequantize_blockwise(
    data: torch.Tensor,
    quant_state: Optional[QuantState] = None,
    absmax: Optional[torch.Tensor] = None,
    code=None,
    blocksize: int = 4096,
    dtype=None,
) -> torch.Tensor:
    """Inverse of quantize_blockwise: out[i] = code[q[i]] * absmax[i // bs],
    from a QuantState or from ``absmax`` (and ``code``, the signed dynamic
    map when not given) in f32 or ``dtype``."""
    if quant_state is not None:
        absmax = quant_state.dequant_absmax()
        code_arr = quant_state.code
        blocksize = quant_state.blocksize
        out_dtype = quant_state.torch_dtype
        shape = quant_state.shape
        qt = quant_state.quant_type
    else:
        if absmax is None:
            raise ValueError("dequantize_blockwise: give a quant_state or an absmax")
        code_arr = code
        out_dtype = _as_torch_dtype(dtype) if dtype is not None else torch.float32
        shape = data.shape
        qt = "dynamic" if code is None else None
    flat = data.reshape(-1)
    n = flat.shape[0]
    scale = absmax.float().repeat_interleave(blocksize)[:n]
    if qt in _DYNAMIC_TYPES:
        from .ops.dynamic8 import dynamic_decode

        vals = dynamic_decode(flat, signed=qt == "dynamic") * scale
    else:
        vals = _table_on(code_arr, flat.device)[flat.long()] * scale
    return vals.reshape(shape).to(out_dtype)


# ---------------------------------------------------------------------------
# 4-bit quantization, bnb byte order
# ---------------------------------------------------------------------------


def quantize_4bit(A: torch.Tensor, blocksize: int = 64, compress_statistics: bool = False,
                  quant_type: str = "nf4"):
    """Blockwise 4-bit quantization (NF4, FP4, int4, AF4): flat uint8
    (ceil(n/2),) in bnb byte order (element 2i in the high nibble, an odd
    n's last low nibble the code of 0.0) and the QuantState.
    ``compress_statistics`` nests the absmax (the QLoRA paper's double
    quantization)."""
    if quant_type not in FOUR_BIT_TYPES:
        raise NotImplementedError(f"4-bit quant_type {quant_type!r} not implemented")
    table, _sorted, order, mids = _code_arrays(None, quant_type)
    blocks, absmax, n = _blockwise_stats(A, blocksize)
    normed = blocks * _safe_inv(absmax)[:, None]
    codes = _encode_nearest(normed, mids, order).reshape(-1)
    packed = pack_4bit(codes)[: (n + 1) // 2]
    offset = state2 = None
    qabsmax = absmax
    if compress_statistics:
        qabsmax, state2, offset = _nest_absmax(absmax)
    state = QuantState(
        absmax=qabsmax, code=_table_on(table, A.device),
        shape=tuple(A.shape), dtype=_dtype_name(A.dtype), blocksize=blocksize,
        quant_type=quant_type, offset=offset, state2=state2)
    return packed, state


def dequantize_4bit(data: torch.Tensor, quant_state: QuantState) -> torch.Tensor:
    """Unpack the nibbles, decode through the table, scale by the block's
    absmax, in the state's dtype and shape."""
    n = int(np.prod(quant_state.shape))
    codes = unpack_4bit(data.reshape(-1), n)
    absmax = quant_state.dequant_absmax()
    scale = absmax.float().repeat_interleave(quant_state.blocksize)[:n]
    vals = quant_state.code.float().to(codes.device)[codes.long()] * scale
    return vals.reshape(quant_state.shape).to(quant_state.torch_dtype)


def quantize_fp4(A, blocksize=64, compress_statistics=False):
    return quantize_4bit(A, blocksize, compress_statistics, "fp4")


def quantize_nf4(A, blocksize=64, compress_statistics=False):
    return quantize_4bit(A, blocksize, compress_statistics, "nf4")


def dequantize_fp4(data, quant_state):
    return dequantize_4bit(data, quant_state)


def dequantize_nf4(data, quant_state):
    return dequantize_4bit(data, quant_state)


# ---------------------------------------------------------------------------
# whole-tensor quantization (one absmax, the dynamic map's table)
# ---------------------------------------------------------------------------


def quantize(A: torch.Tensor, code=None):
    """(uint8 codes, (absmax, code table)) with one f32 absmax for A."""
    table, _s, order, mids = _code_arrays(code, "dynamic")
    absmax = A.float().abs().amax()
    out = _encode_nearest(A.float() * _safe_inv(absmax), mids, order)
    return out, (absmax, _table_on(table, A.device))


def dequantize(A: torch.Tensor, state=None, absmax=None, code=None) -> torch.Tensor:
    if state is not None:
        absmax, code = state
    return _table_on(code, A.device)[A.long()] * absmax


def quantize_no_absmax(A: torch.Tensor, code=None) -> torch.Tensor:
    _t, _s, order, mids = _code_arrays(code, "dynamic")
    return _encode_nearest(A.float(), mids, order)


def dequantize_no_absmax(A: torch.Tensor, code=None) -> torch.Tensor:
    return _table_on(code, A.device)[A.long()]


# ---------------------------------------------------------------------------
# LLM.int8: vector-wise int8 matmul with outlier decomposition
# ---------------------------------------------------------------------------


def get_colrow_absmax(A: torch.Tensor, threshold: float = 0.0):
    """(row_absmax, col_absmax, outlier_cols) of a 2D array; with threshold
    > 0, entries >= threshold leave the row statistics and a column whose
    absmax reaches it is an outlier column."""
    absA = A.float().abs()
    col_absmax = absA.amax(dim=0)
    if threshold > 0.0:
        outlier_cols = col_absmax >= threshold
        row_absmax = torch.where(absA >= threshold, torch.zeros_like(absA), absA).amax(dim=1)
    else:
        outlier_cols = torch.zeros(A.shape[1], dtype=torch.bool, device=A.device)
        row_absmax = absA.amax(dim=1)
    return row_absmax, col_absmax, outlier_cols


def _quant_int8(A32: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """clip(round(A * 127 * safe_inv(absmax)), +-127) as row-major int8
    (the layout kernel I and torch._int_mm take, whatever A's strides);
    absmax broadcasts against A."""
    q = torch.clamp(torch.round(A32 * (127.0 * _safe_inv(absmax))), -127.0, 127.0)
    return q.to(torch.int8).contiguous()


def int8_vectorwise_quant(A: torch.Tensor, axis: int = 1):
    """Symmetric per-vector int8 quantization: (codes, absmax along axis)."""
    A32 = A.float()
    absmax = A32.abs().amax(dim=axis, keepdim=True)
    return _quant_int8(A32, absmax), absmax.squeeze(axis)


def int8_double_quant(A: torch.Tensor, threshold: float = 0.0):
    """Row- and column-wise int8 quantization of a 2D array: (CA, CAt, row
    absmax, column absmax, outlier-column mask). With threshold > 0 the
    outlier columns are zeroed in both code arrays and their entries leave
    the row statistics. Codes multiply by 127 * safe_inv(absmax), as the
    JAX package does; nothing divides."""
    A32 = A.float()
    row_absmax, col_absmax, outlier_cols = get_colrow_absmax(A, threshold)
    if threshold > 0.0:
        A32 = A32 * (~outlier_cols).float()[None, :]
    CA = _quant_int8(A32, row_absmax[:, None])
    CAt = _quant_int8(A32, col_absmax[None, :])
    return CA, CAt, row_absmax, col_absmax, outlier_cols


def int8_linear_matmul(CA: torch.Tensor, CB: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exact: in float64 on the
    CPU, which holds every sum of K products of +-127 codes, and as
    torch._int_mm on the card, whose rule M > 16 zero rows padding M to 32
    meet (they are dropped)."""
    if not CA.is_cuda:
        return (CA.double() @ CB.double().T).to(torch.int32)
    M = CA.shape[0]
    if M <= 16:
        CA = torch.cat([CA, CA.new_zeros((32 - M, CA.shape[1]))])
    return torch._int_mm(CA.contiguous(), CB.t())[:M]


def int8_mm_dequant(out32: torch.Tensor, SCA: torch.Tensor, SCB: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, dtype=torch.bfloat16) -> torch.Tensor:
    """int32 -> float epilogue: out32 * (SCA x SCB) / 127^2 (+ bias)."""
    scale = (SCA.float()[:, None] * SCB.float()[None, :]) * np.float32(1.0 / (127.0 * 127.0))
    out = out32.float() * scale
    if bias is not None:
        out = out + bias.float()[None, :]
    return out.to(dtype)


def llm_int8_prepare_outliers(CB: torch.Tensor, SCB: torch.Tensor, outlier_idx) -> dict:
    """Static outlier state of a weight: {"idx" (B,) int32, "keep" (K,) f32
    zero at idx, "subB" (B, N) f32 dequantized outlier columns}."""
    K = CB.shape[1]
    idx = torch.as_tensor(outlier_idx, device=CB.device).to(torch.int32)
    keep = torch.ones((K,), dtype=torch.float32, device=CB.device)
    keep[idx.long()] = 0.0
    subB = (CB[:, idx.long()].float() * _div127(SCB.float())[:, None]).T.contiguous()
    return {"idx": idx, "keep": keep, "subB": subB}


def llm_int8_matmul(
    A: torch.Tensor,
    CB: torch.Tensor,
    SCB: torch.Tensor,
    threshold: float = 6.0,
    bias: Optional[torch.Tensor] = None,
    outlier_budget: int = 64,
    use_fused: bool = True,
    outliers: Optional[dict] = None,
) -> torch.Tensor:
    """The LLM.int8 forward: per-row int8 activations times CB (N, K), the
    dequant epilogue, and an fp sidecar over the outlier columns (static
    ``outliers`` from llm_int8_prepare_outliers, or per call the
    ``outlier_budget`` columns of largest absmax that reach ``threshold``).

    ``use_fused`` sends up to 128 rows, without per-call outliers, through
    kernel I (``ops.matmul_int8``); other calls quantize, multiply in int8
    and dequantize as three steps. The JAX package defaults to the fused
    route on a TPU only; its two routes round the epilogue differently."""
    lead, K = A.shape[:-1], A.shape[-1]
    N = CB.shape[0]
    A2 = A.reshape(-1, K)
    out_dtype = A.dtype

    def fused(x, row_absmax):
        if not use_fused:
            return None
        from .ops.matmul_int8 import int8_matmul_fused

        return int8_matmul_fused(x, CB, SCB, row_absmax, bias=bias, out_dtype=out_dtype)

    if threshold <= 0.0:
        out = fused(A2, A2.float().abs().amax(dim=1))
        if out is None:
            CA, SCA = int8_vectorwise_quant(A2)
            out = int8_mm_dequant(int8_linear_matmul(CA, CB), SCA, SCB, bias, out_dtype)
        return out.reshape(*lead, N)

    if outliers is not None:
        x_kept = A2 * outliers["keep"].to(A2.dtype)[None, :]
        row_absmax = x_kept.float().abs().amax(dim=1)
        out = fused(x_kept, row_absmax)
        if out is None:
            CA = _quant_int8(x_kept.float(), row_absmax[:, None])
            out = int8_mm_dequant(int8_linear_matmul(CA, CB), row_absmax, SCB, bias, out_dtype)
        subA = A2[:, outliers["idx"].long()].float()
        out = out + (subA @ outliers["subB"].float()).to(out_dtype)
        return out.reshape(*lead, N)

    budget = min(outlier_budget, K)
    A32 = A2.float()
    top_vals, idx = torch.topk(A32.abs().amax(dim=0), budget)
    is_outlier = (top_vals >= threshold).float()
    keep = torch.ones((K,), dtype=torch.float32, device=A.device)
    keep[idx] = 1.0 - is_outlier
    A_kept = A32 * keep[None, :]
    row_absmax = A_kept.abs().amax(dim=1)
    CA = _quant_int8(A_kept, row_absmax[:, None])
    out = int8_mm_dequant(int8_linear_matmul(CA, CB), row_absmax, SCB, bias, out_dtype)
    subA = A32[:, idx] * is_outlier[None, :]
    subB = CB[:, idx].float() * _div127(SCB.float())[:, None]  # (N, budget)
    out = out + (subA @ subB.T).to(out_dtype)
    return out.reshape(*lead, N)


# ---------------------------------------------------------------------------
# 4-bit matmul from a bnb-format weight: kernels B and E through the kernel
# layout, repacked once per weight
# ---------------------------------------------------------------------------


def matmul_4bit_ref(A: torch.Tensor, data: torch.Tensor, quant_state: QuantState,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain route: W = dequantize_4bit in A's dtype, A @ W^T with f32
    products and sums, cast to A's dtype, then + bias."""
    W = dequantize_4bit(data, quant_state).to(A.dtype)
    out = torch.matmul(A.float(), W.float().T).to(A.dtype)
    if bias is not None:
        out = out + bias
    return out


_KERNEL_LAYOUT_CACHE: dict = {}


def _cached_kernel_layout(data: torch.Tensor, quant_state: QuantState):
    """The kernel layout (``ops.common.to_kernel_layout``) of a bnb-format
    weight, repacked once per weight: keyed by the identity and the
    version counter of ``data`` and ``quant_state.absmax``, so a write into
    either in place repacks again. Weak references drop an entry when
    either tensor is freed."""
    from .ops.common import to_kernel_layout

    absmax = quant_state.absmax
    key = (id(data), id(absmax))
    hit = _KERNEL_LAYOUT_CACHE.get(key)
    if hit is not None:
        dref, aref, versions, qw = hit
        if dref() is data and aref() is absmax and versions == (data._version, absmax._version):
            return qw
    qw = to_kernel_layout(data, quant_state)
    drop = lambda _ref, key=key: _KERNEL_LAYOUT_CACHE.pop(key, None)  # noqa: E731
    _KERNEL_LAYOUT_CACHE[key] = (weakref.ref(data, drop), weakref.ref(absmax, drop),
                                 (data._version, absmax._version), qw)
    return qw


def _route_fused_4bit(A: torch.Tensor, data: torch.Tensor, quant_state: QuantState):
    """The cached kernel-layout weight when the kernel route applies (a 2D
    weight, K a multiple of 2 * blocksize, A's last dimension K), else
    None."""
    if quant_state.shape is None or len(quant_state.shape) != 2:
        return None
    N, K = quant_state.shape
    if K % (2 * quant_state.blocksize) != 0 or A.shape[-1] != K:
        return None
    return _cached_kernel_layout(data, quant_state)


def gemv_4bit(A: torch.Tensor, data: torch.Tensor, quant_state: QuantState,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A @ W^T (+ bias) of a bnb-format 4-bit weight, in A's dtype: kernel
    B (fewer than 2048 rows) or E and one dense matmul (``ops.
    matmul_4bit_fused``) where the kernel route applies, else the plain
    route."""
    qw = _route_fused_4bit(A, data, quant_state)
    if qw is not None:
        from .ops.matmul_4bit import matmul_4bit_fused

        return matmul_4bit_fused(A, qw, bias, compute_dtype=A.dtype)
    return matmul_4bit_ref(A, data, quant_state, bias)


def estimate_quantiles(A: torch.Tensor, offset: Optional[float] = None,
                       num_quantiles: int = 256) -> torch.Tensor:
    """Empirical quantiles of A at ``num_quantiles`` evenly spaced eCDF
    positions from ``offset`` to 1 - offset (numpy's and jnp.quantile's
    "linear" method), zero-padded to 256, f32 on A's device. One sort and
    a linear interpolation between the two neighbours of each position,
    both in float64, so any size works (``torch.quantile`` refuses more
    than 2^24 elements). jnp.quantile rounds the positions to f32, so at n
    elements its quantiles sit up to n * 2^-24 sorted places from these
    (within the gap to a neighbour). A NaN in A makes every quantile NaN,
    as in jnp.quantile."""
    if offset is None:
        offset = 1.0 / (2.0 * num_quantiles)
    x = A.reshape(-1).float()
    if x.numel() == 0:
        raise ValueError("estimate_quantiles: empty input")
    xs = torch.sort(x).values
    n = xs.numel()
    pos = torch.linspace(offset, 1.0 - offset, num_quantiles, dtype=torch.float64,
                         device=x.device) * (n - 1)
    lo = pos.floor().clamp(0, n - 1)
    w = pos - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=n - 1)
    q = (xs[lo].double() * (1.0 - w) + xs[hi].double() * w).float()
    q = torch.where(torch.isnan(xs[-1]), torch.full_like(q, float("nan")), q)
    if num_quantiles < 256:
        q = torch.cat([q, q.new_zeros(256 - num_quantiles)])
    return q


# ---------------------------------------------------------------------------
# optimizer updates: take states, return new states. Python-float
# hyperparameters round to f32 where they meet an f32 tensor, as the JAX
# package's weakly typed scalars do; scalars it computes in f32 (the bias
# corrections) are computed here in numpy f32.
# ---------------------------------------------------------------------------


def _bias_corrections(beta1: float, beta2: float, step: int):
    """(c1 as a Python float, c2 = sqrt(1 - beta2^step) in f32)."""
    return 1.0 - beta1 ** step, np.sqrt(np.float32(1.0 - beta2 ** step))


def _adam2(g, p, s1, s2, beta1, beta2, eps, step, lr, weight_decay):
    c1, c2 = _bias_corrections(beta1, beta2, step)
    step_size = float(np.float32(-lr) * c2 / np.float32(c1))
    s1 = s1 * beta1 + (1.0 - beta1) * g
    s2 = s2 * beta2 + (1.0 - beta2) * g * g
    p = p + step_size * (s1 / (torch.sqrt(s2) + float(np.float32(eps) * c2)))
    if weight_decay > 0.0:
        p = p * (1.0 - lr * weight_decay)
    return p, s1, s2


def _momentum1(g, p, s1, beta1, eps, step, lr, weight_decay):
    if weight_decay > 0.0:
        g = g + p * weight_decay
    s1 = g if step == 1 else s1 * beta1 + g
    return p - lr * s1, s1


def _lion1(g, p, s1, beta1, beta2, eps, step, lr, weight_decay):
    if weight_decay > 0.0:
        g = g + p * weight_decay
    p = p - lr * torch.sign(s1 * beta1 + (1.0 - beta1) * g)
    return p, s1 * beta2 + (1.0 - beta2) * g


def _rmsprop1(g, p, s1, beta1, eps, step, lr, weight_decay):
    if weight_decay > 0.0:
        g = g + p * weight_decay
    s1 = s1 * beta1 + (1.0 - beta1) * g * g
    return p - lr * g / (torch.sqrt(s1) + eps), s1


def _adagrad1(g, p, s1, beta1, eps, step, lr, weight_decay):
    if weight_decay > 0.0:
        g = g + p * weight_decay
    s1 = s1 + g * g
    return p - lr * g / (torch.sqrt(s1) + eps), s1


OPTIMIZER_FUNCS_2STATE = {"adam": _adam2, "lamb": _adam2}
OPTIMIZER_FUNCS_1STATE = {
    "momentum": _momentum1,
    "lion": _lion1,
    "rmsprop": _rmsprop1,
    "adagrad": _adagrad1,
}


def optimizer_update_32bit(
    optimizer_name: str,
    g: torch.Tensor,
    p: torch.Tensor,
    state1: torch.Tensor,
    state2: Optional[torch.Tensor],
    beta1: float,
    beta2: float = 0.0,
    eps: float = 1e-8,
    step: int = 1,
    lr: float = 1e-3,
    weight_decay: float = 0.0,
    gnorm_scale=1.0,
    max_unorm: float = 0.0,
    skip_zeros: bool = False,
):
    """32-bit optimizer step: returns (p, state1, state2). ``max_unorm > 0``
    clips the raw (lr-less) update's norm to max_unorm * ||p|| + eps before
    the learning rate applies (LAMB, LARS)."""
    gf = g.float() * gnorm_scale
    pf = p.float()
    nonzero = gf != 0.0 if skip_zeros else None

    def _clip(u):
        if max_unorm <= 0.0:
            return 1.0
        unorm = torch.linalg.vector_norm(u)
        limit = max_unorm * torch.linalg.vector_norm(pf) + eps
        return torch.where(unorm > limit, limit / unorm.clamp_min(1e-12), torch.ones_like(unorm))

    if optimizer_name in OPTIMIZER_FUNCS_2STATE:
        s1, s2 = state1.float(), state2.float()
        c1, c2 = _bias_corrections(beta1, beta2, step)
        new_s1 = s1 * beta1 + (1.0 - beta1) * gf
        new_s2 = s2 * beta2 + (1.0 - beta2) * gf * gf
        u = new_s1 / (torch.sqrt(new_s2) + float(np.float32(eps) * c2))
        new_p = pf - float(np.float32(lr) * c2 / np.float32(c1)) * _clip(u) * u
        if weight_decay > 0.0:
            new_p = new_p * (1.0 - lr * weight_decay)
        if skip_zeros:
            new_p = torch.where(nonzero, new_p, pf)
            new_s1 = torch.where(nonzero, new_s1, state1)
            new_s2 = torch.where(nonzero, new_s2, state2)
        return new_p.to(p.dtype), new_s1, new_s2

    s1 = state1.float()
    gw = gf + pf * weight_decay if weight_decay > 0.0 else gf
    if optimizer_name == "momentum":
        new_s1 = gw if step == 1 else s1 * beta1 + gw
        u = new_s1
    elif optimizer_name == "lion":
        u = torch.sign(s1 * beta1 + (1.0 - beta1) * gw)
        new_s1 = s1 * beta2 + (1.0 - beta2) * gw
    elif optimizer_name == "rmsprop":
        new_s1 = s1 * beta1 + (1.0 - beta1) * gw * gw
        u = gw / (torch.sqrt(new_s1) + eps)
    elif optimizer_name == "adagrad":
        new_s1 = s1 + gw * gw
        u = gw / (torch.sqrt(new_s1) + eps)
    else:
        raise NotImplementedError(optimizer_name)
    new_p = pf - lr * _clip(u) * u
    if skip_zeros:
        new_p = torch.where(nonzero, new_p, pf)
        new_s1 = torch.where(nonzero, new_s1, state1)
    return new_p.to(p.dtype), new_s1, None


def _optim8_scalars(optimizer_name, beta1, beta2, eps, step, lr, weight_decay, gnorm_scale,
                    device) -> torch.Tensor:
    """The eight f32 scalars of kernels J and K (ops/optim8.py), computed
    on the host as the JAX package's dispatch computes them, once per step:
    every leaf of a step shares one device copy (a copy per leaf would
    wait for the device each time). A tensor ``gnorm_scale`` (percentile
    clipping) joins on its device."""
    if not isinstance(gnorm_scale, torch.Tensor):
        return _optim8_scalars_shared(optimizer_name, beta1, beta2, eps, int(step), lr,
                                      weight_decay, float(gnorm_scale), str(torch.device(device)))
    return _scalars_tensor(optimizer_name, beta1, beta2, eps, step, lr, weight_decay, gnorm_scale,
                           device)


def _scalars_tensor(optimizer_name, beta1, beta2, eps, step, lr, weight_decay, gnorm_scale,
                    device) -> torch.Tensor:
    if optimizer_name in OPTIMIZER_FUNCS_2STATE:
        c1, c2 = _bias_corrections(beta1, beta2, step)
        step_size = np.float32(-lr) * c2 / np.float32(c1)
        decay = 1.0 - lr * weight_decay if weight_decay > 0.0 else 1.0
        vals = [beta1, beta2, np.float32(eps) * c2, step_size, decay]
    else:
        vals = [beta1, beta2, eps, lr, weight_decay]
    tail = [1.0 if step == 1 else 0.0, 0.0] if optimizer_name not in OPTIMIZER_FUNCS_2STATE \
        else [0.0, 0.0]
    if isinstance(gnorm_scale, torch.Tensor):
        head = torch.tensor(np.float32(vals), device=device)
        rest = torch.tensor(np.float32(tail), device=device)
        return torch.cat([head, gnorm_scale.float().reshape(1).to(device), rest])
    return torch.tensor(np.float32(vals + [gnorm_scale] + tail), device=device)


@functools.lru_cache(maxsize=16)
def _optim8_scalars_shared(*key) -> torch.Tensor:
    return _scalars_tensor(*key)


def _optim8_fused_dispatch(
    optimizer_name, state1, absmax1, state2, absmax2,
    beta1, beta2, eps, step, lr, weight_decay, gnorm_scale,
    blocksize, p_orig, g_orig, noise=None, qmaps=None,
):
    """The 8-bit blockwise update of one leaf through kernel J or K
    (ops/optim8.py) on CUDA tensors, their plain versions on CPU tensors: a
    one-leaf table over copies of p and the states, which the body updates
    in place. A ragged last block reads as the JAX package's kernel route
    pads it: g and p 0, state1's codes 127 and state2's 0 (0.0 under the
    dynamic maps, the tables' entries under ``qmaps``)."""
    from .ops.optim8 import Optim8Leaf, optim8_update

    two = optimizer_name in OPTIMIZER_FUNCS_2STATE
    scalars = _optim8_scalars(optimizer_name, beta1, beta2, eps, step, lr, weight_decay,
                              gnorm_scale, p_orig.device).reshape(1, 8)
    out = [p_orig.float().reshape(-1).clone(), state1.reshape(-1).clone(),
           absmax1.float().reshape(-1).clone()]
    if two:
        out += [state2.reshape(-1).clone(), absmax2.float().reshape(-1).clone()]
    optim8_update(optimizer_name, [Optim8Leaf(g_orig.float().reshape(-1).contiguous(), *out,
                                              u=noise)],
                  scalars, blocksize=blocksize, qmaps=qmaps)
    res = [out[0].reshape(p_orig.shape).to(p_orig.dtype), out[1].reshape(state1.shape), out[2]]
    if two:
        res += [out[3].reshape(state2.shape), out[4]]
    else:
        res += [None, None]
    return tuple(res)


_NOISE_SEED = 0xB17B


def _optim8_noise(size: int, step: int, device) -> torch.Tensor:
    """The uniforms of stochastic rounding: ``size`` from a generator seeded
    from the step, the same for every leaf of that size."""
    gen = torch.Generator(device=device).manual_seed((_NOISE_SEED << 32) + int(step))
    return torch.rand((size,), generator=gen, device=device, dtype=torch.float32)


def optimizer_update_8bit_blockwise(
    optimizer_name: str,
    g: torch.Tensor,
    p: torch.Tensor,
    state1: torch.Tensor,  # uint8
    absmax1: torch.Tensor,
    state2: Optional[torch.Tensor],  # uint8
    absmax2: Optional[torch.Tensor],
    qmap1=None,
    qmap2=None,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    step: int = 1,
    lr: float = 1e-3,
    weight_decay: float = 0.0,
    gnorm_scale=1.0,
    skip_zeros: bool = False,
    blocksize: int = 2048,
    codec: Optional[str] = None,
    stochastic_rounding: bool = False,
):
    """Blockwise 8-bit optimizer step: decode the uint8 states, update,
    requantize per ``blocksize`` block (any size) with a fresh absmax
    (kernel J or K on the card). The states' codec: the dynamic maps when
    ``codec`` is "dynamic" or neither codec nor ``qmap1`` is given (the
    tables are then ignored), else the LUT codec over ``qmap1`` (and
    ``qmap2`` for adam and lamb), numpy or tensors of 256 finite entries,
    sorted or not (``ops.optim8.LutCodec``). Non-finite gradient entries
    leave p and the states unchanged. Returns (p, state1, absmax1, state2,
    absmax2). ``stochastic_rounding`` requantizes with uniforms from a
    ``torch.Generator`` seeded from ``step``, so a step is deterministic
    given (state, step); the JAX package's PRNG bits are not reproduced.
    With a table it warns and rounds to nearest, as the JAX package does.
    ``skip_zeros`` is accepted and unused, as in the JAX package."""
    del skip_zeros
    if codec is None and qmap1 is None:
        codec = "dynamic"
    qmaps = None
    if codec != "dynamic":
        if stochastic_rounding:
            warnings.warn("stochastic_rounding requires the dynamic codec; custom-qmap optimizer "
                          "states requantize deterministically (round-to-nearest)", stacklevel=2)
            stochastic_rounding = False
        qmaps = (qmap1, qmap2 if optimizer_name in OPTIMIZER_FUNCS_2STATE else None)
    noise = _optim8_noise(blocks_for(g.numel(), blocksize) * blocksize, step, p.device) \
        if stochastic_rounding else None
    return _optim8_fused_dispatch(
        optimizer_name, state1, absmax1, state2, absmax2,
        beta1, beta2, eps, step, lr, weight_decay, gnorm_scale,
        blocksize, p, g, noise=noise, qmaps=qmaps,
    )


def _shard_rows(t: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Rank r's dim-0 slice of t (of n), a view."""
    rows = t.shape[0] // n
    return t[r * rows:(r + 1) * rows]


def optimizer_update_8bit_blockwise_sharded(
    optimizer_name: str,
    g: torch.Tensor,
    p: torch.Tensor,
    state1: torch.Tensor,
    absmax1: torch.Tensor,
    state2: Optional[torch.Tensor],
    absmax2: Optional[torch.Tensor],
    qmap1=None,
    qmap2=None,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    step: int = 1,
    lr: float = 1e-3,
    mesh=None,
    axis: str = "data",
    weight_decay: float = 0.0,
    gnorm_scale=1.0,
    blocksize: int = 2048,
    codec: Optional[str] = None,
    stochastic_rounding: bool = False,
):
    """``optimizer_update_8bit_blockwise`` with the states sharded on dim 0
    over a mesh dim (ZeRO style). ``g`` and ``p`` are the whole leaf, as
    every rank of ``axis`` holds it; ``state1``/``state2`` this rank's
    dim-0 rows and ``absmax1``/``absmax2`` their blocks. The blockwise
    update is elementwise per block, so with each rank's element count a
    multiple of the blocksize every rank runs kernel J or K on its own
    contiguous range and nothing moves: it returns (its rows of the new p,
    state1, absmax1, state2, absmax2), bit for bit the unsharded update's
    slices (the uniforms of ``stochastic_rounding`` are drawn per rank)."""
    from .parallel.mesh import axis_rank, axis_size

    ndev = axis_size(mesh, axis)
    n = g.numel()
    if g.shape[0] % ndev != 0:
        raise ValueError(f"dim0 ({g.shape[0]}) must divide by mesh axis {axis} ({ndev})")
    if (n // ndev) % blocksize != 0:
        raise ValueError(
            f"per-device size ({n // ndev}) must be a multiple of blocksize "
            f"({blocksize}) so quantization blocks never cross shards"
        )
    r = axis_rank(mesh, axis)
    return optimizer_update_8bit_blockwise(
        optimizer_name, _shard_rows(g, ndev, r), _shard_rows(p, ndev, r), state1, absmax1,
        state2, absmax2, qmap1, qmap2, beta1, beta2, eps, step, lr, weight_decay=weight_decay,
        gnorm_scale=gnorm_scale, blocksize=blocksize, codec=codec,
        stochastic_rounding=stochastic_rounding)


def optimizer_update_8bit(
    optimizer_name: str,
    g: torch.Tensor,
    p: torch.Tensor,
    state1: torch.Tensor,
    state2: Optional[torch.Tensor],
    beta1: float,
    beta2: float,
    eps: float,
    step: int,
    lr: float,
    qmap1=None,
    qmap2=None,
    max1: Optional[torch.Tensor] = None,
    max2: Optional[torch.Tensor] = None,
    weight_decay: float = 0.0,
    gnorm_scale=1.0,
    codec: Optional[str] = None,
):
    """The global-max ("static") 8-bit step: the blockwise update with one
    block of ceil(n / 2048) * 2048 elements over the whole tensor (kernel
    J's or K's two-pass body on the card), either codec. ``max1``/``max2``
    are the per-tensor scales, shape (1,) (zero when not given). Returns
    (p, state1, new_max1, state2, new_max2), the maxima of shape (1,), the
    fresh absmax of the updated states (not a running maximum)."""
    n = g.numel()
    bs = blocks_for(n, 2048) * 2048
    zero = torch.zeros((1,), dtype=torch.float32, device=p.device)
    m1 = max1.reshape(1) if max1 is not None else zero
    m2 = max2.reshape(1) if max2 is not None else (zero.clone() if state2 is not None else None)
    return optimizer_update_8bit_blockwise(
        optimizer_name, g, p, state1, m1, state2, m2, qmap1, qmap2,
        beta1, beta2, eps, step, lr,
        weight_decay=weight_decay, gnorm_scale=gnorm_scale, blocksize=bs, codec=codec,
    )


def optimizer_update_8bit_grouped(
    optimizer_name: str,
    leaves,
    hypers,
    step: int,
    gnorm_scales=None,
    blocksize: int = 2048,
    stochastic_rounding: bool = False,
) -> None:
    """The blockwise 8-bit update of many leaves at once, in place: one
    launch of kernel J or K (ops/optim8.optim8_update) on CUDA tensors,
    the plain version on CPU tensors. ``leaves`` are (g, p, state) with
    contiguous f32 g and p and the state's ``state1``, ``absmax1``[,
    ``state2``, ``absmax2``]; ``hypers`` one (lr, beta1, beta2, eps,
    weight_decay) per leaf; ``gnorm_scales`` None or one scale tensor per
    leaf (percentile clipping). p becomes p + (new_p - p), so each leaf
    ends bit for bit where ``optimizer_update_8bit_blockwise`` followed by
    ``p.add_(new_p - p)`` puts it; the uniforms of stochastic rounding are
    that function's."""
    from .ops.optim8 import Optim8Leaf, optim8_update

    dev = leaves[0][1].device
    rows, uniq = [], {}
    for lr, beta1, beta2, eps, wd in hypers:
        key = (lr, beta1, beta2, eps, wd)
        if key not in uniq:
            uniq[key] = _optim8_scalars(optimizer_name, beta1, beta2, eps, step, lr, wd, 1.0, dev)
        rows.append(key)
    keys = list(uniq)
    if gnorm_scales is None:
        scalars = uniq[keys[0]].reshape(1, 8) if len(keys) == 1 else \
            torch.stack([uniq[k] for k in keys])
        rows = [keys.index(k) for k in rows]
    else:  # one row per leaf, its own gnorm_scale
        scalars = torch.stack([uniq[k] for k in rows])
        scalars[:, 5] = torch.stack([s.float().reshape(()) for s in gnorm_scales])
        rows = list(range(len(leaves)))
    noise = {}
    table = []
    for g, p, s in leaves:
        u = None
        if stochastic_rounding:
            size = blocks_for(p.numel(), blocksize) * blocksize
            if size not in noise:
                noise[size] = _optim8_noise(size, step, dev)
            u = noise[size]
        two = "state2" in s
        table.append(Optim8Leaf(g, p, s["state1"], s["absmax1"], s["state2"] if two else None,
                                s["absmax2"] if two else None, u))
    optim8_update(optimizer_name, table, scalars, rows, blocksize=blocksize, apply_delta=True)


def percentile_clipping(grad_norm: torch.Tensor, gnorm_vec: torch.Tensor, step: int,
                        percentile: int = 5):
    """Running 100-step gradient-norm history clipping. Returns (new
    gnorm_vec of squared norms, gnorm_scale)."""
    g2 = grad_norm.float() ** 2
    new_vec = gnorm_vec.clone()
    new_vec[(step - 1) % 100] = g2
    filled = min(step, 100)
    inf = torch.full_like(new_vec, float("inf"))
    clip2 = torch.sort(torch.where(new_vec > 0, new_vec, inf)).values[
        min(max(percentile * filled // 100, 0), 99)]
    clip2 = torch.where(torch.isfinite(clip2), clip2, g2)
    gnorm, clip = torch.sqrt(g2), torch.sqrt(clip2)
    return new_vec, torch.where(gnorm > clip, clip / gnorm, torch.ones_like(gnorm))


def histogram_scatter_add_2d(hist: torch.Tensor, index1: torch.Tensor, index2: torch.Tensor,
                             src: torch.Tensor) -> torch.Tensor:
    """A copy of hist with hist[i1, i2] += src (repeated indices add, in no
    defined order)."""
    return hist.index_put((index1.long(), index2.long()), src.to(hist.dtype), accumulate=True)
