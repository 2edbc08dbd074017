"""The legacy op surface (the JAX package's ``legacy.py``): functions a
migrating bitsandbytes user may call that the serving and training paths
do not need.

- the vectorwise int8 quantization family (``vectorwise_quant`` and its
  dequantizers), behind ``autograd.matmul_cublas``;
- ``igemm`` / ``batched_igemm``: int8 products accumulated exactly in
  int32 (``torch._int_mm`` on the card where its shapes allow, float64
  products otherwise, which are exact for int8 inputs; int64 on the CPU);
- COO/CSR/CSC sparse containers and ``spmm_coo``/``spmm_coo_very_sparse``;
- ``transform`` (the tiled GPU orders are plain row-major here: only the
  transpose is kept) and ``extract_outliers``;
- the paged-memory API as ordinary tensors (no CUDA unified memory, as in
  the JAX package): ``get_paged`` allocates, ``prefetch_tensor`` does
  nothing.

Every division by a constant divides by a tensor, so it rounds once on
every device (PyTorch's CUDA division by a Python scalar multiplies by the
rounded reciprocal).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import functional as F
from .ops.common import fma_f32

__all__ = [
    "vectorwise_quant",
    "vectorwise_dequant",
    "vectorwise_mm_dequant",
    "dequant_min_max",
    "igemm",
    "batched_igemm",
    "COOSparseTensor",
    "CSRSparseTensor",
    "CSCSparseTensor",
    "coo2csr",
    "coo2csc",
    "coo_zeros",
    "spmm_coo",
    "spmm_coo_very_sparse",
    "transform",
    "extract_outliers",
    "GlobalPageManager",
    "get_paged",
    "prefetch_tensor",
    "fill",
    "arange",
    "_mul",
]


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c rounded once on every device."""
    return t / torch.tensor(c, dtype=t.dtype, device=t.device)


# ---------------------------------------------------------------------------
# vectorwise quantization
# ---------------------------------------------------------------------------


def _quantile96(a: torch.Tensor, dim: int) -> torch.Tensor:
    """The 0.96 quantile along ``dim`` (kept), linear interpolation in f32
    as the JAX package computes it on the CPU: q = 0.96 (n - 1), w = q -
    floor(q), fma(low, 1 - w, high * w) (XLA contracts ``jnp.quantile``'s
    sum of products into that FMA)."""
    s = torch.sort(a, dim=dim).values
    n = s.shape[dim]
    q = torch.tensor(0.96, dtype=torch.float32) * torch.tensor(n - 1, dtype=torch.float32)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = torch.tensor(1.0, dtype=torch.float32) - w_hi
    low = s.narrow(dim, int(lo), 1)
    high = s.narrow(dim, int(hi), 1)
    return fma_f32(low, w_lo.to(a.device).expand_as(low), high * w_hi.to(a.device))


def vectorwise_quant(x: torch.Tensor, dim: int = 0, quant_type: str = "vector"):
    """(int8 codes, scale). quant_type: "linear" (one absmax for the
    tensor), "vector"/"row" (absmax along ``dim``), "truncated-vector" (the
    0.96 quantile of |x| along ``dim``), "zeropoint"/"vector-zeropoint"
    (asymmetric; the scale is (qx, zpx))."""
    xf = x.float()
    if quant_type == "linear":
        maxv = xf.abs().amax()
        xq = torch.clamp(torch.round(xf / maxv * 127), -127, 127).to(torch.int8)
        return xq, maxv
    if quant_type in ("vector", "row"):
        maxv = xf.abs().amax(dim=dim, keepdim=True)
        xq = torch.clamp(torch.round(xf * (127.0 * F._safe_inv(maxv))), -127, 127).to(torch.int8)
        return xq, maxv
    if quant_type == "truncated-vector":
        maxv = _quantile96(xf.abs(), dim)
        xq = torch.clamp(torch.round(xf * (127.0 * F._safe_inv(maxv))), -127, 127).to(torch.int8)
        return xq, maxv
    if quant_type in ("zeropoint", "vector-zeropoint"):
        if quant_type == "zeropoint":
            minv = xf.amin()
            dyna = xf.amax() - minv
        else:
            minv = xf.amin(dim=dim, keepdim=True)
            dyna = xf.amax(dim=dim, keepdim=True) - minv
        dyna = torch.where(dyna == 0, torch.ones_like(dyna), dyna)
        qx = torch.tensor(255.0, device=xf.device) / dyna
        zpx = torch.round(minv * qx) - 128
        xq = torch.clamp(torch.round(xf * qx + zpx) - zpx - 128, -128, 127).to(torch.int8)
        return xq, (qx, zpx)
    raise ValueError(f"unknown quant_type {quant_type!r}")


def vectorwise_dequant(xq: torch.Tensor, max1, quant_type: str = "vector") -> torch.Tensor:
    if quant_type in ("vector", "linear"):
        return _div(xq.float() * max1, 127.0)
    raise ValueError(quant_type)


def vectorwise_mm_dequant(xq: torch.Tensor, S1, S2, dtype=torch.bfloat16,
                          quant_type: str = "vector") -> torch.Tensor:
    """An int32 product's result with per-row S1 and per-column S2 scales
    ("vector")."""
    if quant_type == "vector":
        return _div(xq.float() * (S1 * S2), 127.0 * 127.0).to(dtype)
    raise ValueError(quant_type)


def dequant_min_max(xq, A, B, SA, SB, dtype=torch.bfloat16):
    """The zeropoint variant's epilogue."""
    offset = B.float().sum(0) * (SA[0] + SA[1])
    x = _div(xq.float() * SB[0] * SA[0], 127.0 * 127.0)
    return (x + offset).to(dtype)


# ---------------------------------------------------------------------------
# int8 products
# ---------------------------------------------------------------------------


def _int_mm_ok(A: torch.Tensor, B: torch.Tensor) -> bool:
    M, K = A.shape
    return (A.is_cuda and A.dtype == torch.int8 and B.dtype == torch.int8 and M > 16
            and K % 8 == 0 and B.shape[1] % 8 == 0)


def _mm_exact(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) integers -> int32, accumulated exactly."""
    if A.device.type == "cpu":
        return torch.matmul(A.long(), B.long()).to(torch.int32)
    if _int_mm_ok(A, B):
        return torch._int_mm(A.contiguous(), B.contiguous())
    # float64 holds every partial sum of int8 products exactly (|sum| < 2^53)
    return torch.matmul(A.double(), B.double()).to(torch.int32)


def igemm(A: torch.Tensor, B: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 product -> int32. A (..., K) x B (K, N); 3-D x 3-D: A (B, S, I),
    B (B, S, O) -> (I, O), summed over batch and sequence (``einsum
    'bsi,bso->io'``)."""
    del out
    if A.dim() == 3 and B.dim() == 3:
        return _mm_exact(A.reshape(-1, A.shape[-1]).T, B.reshape(-1, B.shape[-1]))
    lead = A.shape[:-1]
    return _mm_exact(A.reshape(-1, A.shape[-1]), B).reshape(*lead, B.shape[-1])


def batched_igemm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched int8 product (b, M, K) x (b, K, N) -> int32 (b, M, N)."""
    assert A.dim() == 3 and B.dim() == 3
    if A.device.type == "cpu":
        return torch.bmm(A.long(), B.long()).to(torch.int32)
    return torch.stack([_mm_exact(a, b) for a, b in zip(A, B)])


# ---------------------------------------------------------------------------
# sparse containers: fixed capacity, padding entries carry value 0
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class COOSparseTensor:
    rows: int
    cols: int
    nnz: int
    rowidx: torch.Tensor  # (nnz,) int32
    colidx: torch.Tensor  # (nnz,) int32
    values: torch.Tensor  # (nnz,)


@dataclasses.dataclass
class CSRSparseTensor:
    rows: int
    cols: int
    nnz: int
    rowptr: torch.Tensor  # (rows + 1,)
    colidx: torch.Tensor
    values: torch.Tensor


@dataclasses.dataclass
class CSCSparseTensor:
    rows: int
    cols: int
    nnz: int
    colptr: torch.Tensor  # (cols + 1,)
    rowidx: torch.Tensor
    values: torch.Tensor


def coo_zeros(rows: int, cols: int, nnz: int, dtype=torch.float32, device=None) -> COOSparseTensor:
    z = torch.zeros((nnz,), dtype=torch.int32, device=device)
    return COOSparseTensor(rows, cols, nnz, z, z.clone(),
                           torch.zeros((nnz,), dtype=dtype, device=device))


def _compress(idx: torch.Tensor, n: int):
    """(stable order by idx, pointer array (n + 1,) int32)."""
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx.long(), minlength=n).to(torch.int32)
    ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0).to(torch.int32)])
    return order, ptr


def coo2csr(coo: COOSparseTensor) -> CSRSparseTensor:
    order, rowptr = _compress(coo.rowidx, coo.rows)
    return CSRSparseTensor(coo.rows, coo.cols, coo.nnz, rowptr, coo.colidx[order],
                           coo.values[order])


def coo2csc(coo: COOSparseTensor) -> CSCSparseTensor:
    order, colptr = _compress(coo.colidx, coo.cols)
    return CSCSparseTensor(coo.rows, coo.cols, coo.nnz, colptr, coo.rowidx[order],
                           coo.values[order])


def spmm_coo(coo: COOSparseTensor, B: torch.Tensor) -> torch.Tensor:
    """Sparse (rows x cols) @ dense (cols x N): rows of B gathered by
    column index, scaled, and added into their output rows."""
    gathered = B[coo.colidx.long()] * coo.values[:, None].to(B.dtype)
    out = torch.zeros((coo.rows, B.shape[1]), dtype=gathered.dtype, device=B.device)
    return out.index_add_(0, coo.rowidx.long(), gathered)


def spmm_coo_very_sparse(coo: COOSparseTensor, B: torch.Tensor,
                         dequant_stats=None) -> torch.Tensor:
    """spmm_coo in f32, B's int8 rows first dequantized by their
    ``dequant_stats / 127`` where given."""
    Bf = B.float()
    if dequant_stats is not None:
        Bf = _div(Bf * dequant_stats[:, None].float(), 127.0)
    gathered = Bf[coo.colidx.long()] * coo.values[:, None].float()
    out = torch.zeros((coo.rows, B.shape[1]), dtype=torch.float32, device=B.device)
    return out.index_add_(0, coo.rowidx.long(), gathered)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def transform(A: torch.Tensor, to_order: str = "col32", from_order: str = "row",
              transpose: bool = False, state=None) -> Tuple[torch.Tensor, Tuple]:
    """Layout converter with bitsandbytes' (out, (shape, order)) contract.
    The tiled orders (col32, col_turing, col_ampere) existed to feed
    cublasLt; here every order is row-major and only ``transpose`` acts."""
    out = A.T if transpose else A
    return out, (tuple(out.shape), to_order)


def extract_outliers(A: torch.Tensor, state, idx: torch.Tensor) -> torch.Tensor:
    """The outlier columns ``idx`` of a row-major int8 weight."""
    return torch.index_select(A, 1, idx.long())


# ---------------------------------------------------------------------------
# the paged-memory API: ordinary tensors
# ---------------------------------------------------------------------------


class GlobalPageManager:
    """bitsandbytes' page manager with nothing to page: it records the
    tensors ``get_paged`` made."""

    _instance = None

    def __init__(self):
        self.paged_tensors = []

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def prefetch_all(self, to_cpu: bool = False) -> None:
        return None


def get_paged(*shape, dtype=torch.float32, device=None, **kw) -> torch.Tensor:
    arr = torch.zeros(shape, dtype=dtype, device=device)
    GlobalPageManager.get_instance().paged_tensors.append(arr)
    return arr


def prefetch_tensor(A: torch.Tensor, to_cpu: bool = False) -> None:
    return None


def fill(A: torch.Tensor, value) -> torch.Tensor:
    """A new tensor like A filled with ``value`` (A is not written)."""
    return torch.full_like(A, value)


def arange(A: torch.Tensor) -> torch.Tensor:
    return torch.arange(A.numel(), dtype=A.dtype, device=A.device).reshape(A.shape)


def _mul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A * B
