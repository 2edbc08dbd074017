"""W4A8 matmul: 4-bit weights times int8 activations (kernel A, ``w4a8_gemv``).

Numerics of the JAX package's ``ops/matmul_w4a8.py``: activations are
quantized to int8 per row (``round(x * 127 * safe_inv(row_absmax))``, half
to even, clipped to +-127), the 4-bit codes decode to the int8 table
``round(code * 127)``, each quantization block's dot is an exact int32 sum,
scaled by ``absmax / 127`` and summed in f32 across blocks, and the row
scale ``row_absmax / 127`` and the bias apply last.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build
from .common import QLinearWeight, check_cuda_tensors, safe_inv

__all__ = ["matmul_4bit_w4a8", "w4a8_gemv", "grouped_min_m", "W8A8_PREFILL_MIN_M"]

# routing thresholds of the JAX package (models/llama.apply_linear reads them)
W8A8_PREFILL_MIN_M = 4096


def grouped_min_m(blocksize: int) -> int:
    """Row count above which apply_linear sends a weight to the grouped
    W4A8 route."""
    return 128 if blocksize == 128 else 256


def _int8_code_table(code) -> tuple:
    return tuple(int(round(float(v) * 127.0)) for v in code)


def _w4a8_plain(x2: torch.Tensor, w: QLinearWeight, bias, out_dtype) -> torch.Tensor:
    """Plain PyTorch version of kernel A; the integer block dots run in
    float64, which holds them exactly."""
    M, K = x2.shape
    N = w.shape[0]
    bs = w.blocksize
    nbh = K // (2 * bs)
    x2 = x2.float()
    ra = x2.abs().amax(dim=1)
    xq = torch.clamp(torch.round(x2 * (127.0 * safe_inv(ra)).reshape(M, 1)), -127.0, 127.0)
    table = torch.tensor(_int8_code_table(w.code), dtype=torch.float64, device=x2.device)
    wq = torch.cat([table[(w.packed >> 4).long()], table[(w.packed & 0xF).long()]], dim=0)
    # (2*nbh, bs, N) blocks, plane-major; x blocks to match
    d = torch.einsum(
        "mgb,gbn->gmn",
        xq.double().reshape(M, 2 * nbh, bs),
        wq.reshape(2 * nbh, bs, N),
    ).float()  # exact int sums, (2*nbh, M, N)
    s = (w.scales_f32() * (1.0 / 127.0)).reshape(2 * nbh, 1, N)
    out = (d * s).sum(dim=0)
    out = out * (ra.reshape(M, 1) / 127.0)
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def _ksplit(nbh: int, n_col_blocks: int, m_tiles: int, warps: int = 8):
    """(quant blocks per warp, K splits) so that the grid holds a few
    blocks per SM."""
    want = max(1, -(-264 // (n_col_blocks * m_tiles)))
    g = max(1, nbh // (warps * want))
    return g, -(-nbh // (warps * g))


def w4a8_gemv(x2: torch.Tensor, w: QLinearWeight, bias: Optional[torch.Tensor],
              out_dtype) -> torch.Tensor:
    """Kernel A on CUDA tensors; the plain version on CPU tensors.
    x2 (M, K) f32/bf16 -> (M, N) in out_dtype (f32 or bf16)."""
    if not check_cuda_tensors("w4a8_gemv", x2, w.packed, w.absmax, bias):
        return _w4a8_plain(x2, w, bias, out_dtype)
    M, K = x2.shape
    N = w.shape[0]
    bs = w.blocksize
    if x2.dtype not in (torch.float32, torch.bfloat16) or not x2.is_contiguous():
        raise ValueError(f"w4a8_gemv: x must be contiguous f32/bf16, got {x2.dtype}")
    if w.absmax.dtype not in (torch.float32, torch.bfloat16) or w.compressed:
        raise ValueError("w4a8_gemv: raw f32/bf16 scales only")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w4a8_gemv: out_dtype must be f32 or bf16, got {out_dtype}")
    if N % 128 or K % (2 * bs) or bs % 4 or w.shape[1] != K or M == 0:
        raise ValueError(f"w4a8_gemv: untileable shape M={M} N={N} K={K} bs={bs}")
    if not (w.packed.is_contiguous() and w.absmax.is_contiguous()):
        raise ValueError("w4a8_gemv: weight tensors must be contiguous")
    nbh = K // (2 * bs)
    m_tiles = -(-M // 4)
    g, ksplit = _ksplit(nbh, N // 128, m_tiles)
    dev = x2.device
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    ra = torch.empty((M,), dtype=torch.float32, device=dev)
    part = torch.empty((ksplit, M, N), dtype=torch.float32, device=dev)
    b = None if bias is None else bias.float().contiguous()
    table = (ctypes.c_int8 * 16)(*_int8_code_table(w.code))
    fn = _build.kernel_fn("w4a8_gemv", "w4a8_gemv", 19, int_args=range(9, 18))
    err = fn(
        x2.data_ptr(), w.packed.data_ptr(), w.absmax.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), xq.data_ptr(),
        ra.data_ptr(), part.data_ptr(), ctypes.addressof(table),
        M, N, K, bs, g, ksplit,
        int(x2.dtype == torch.bfloat16), int(w.absmax.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("w4a8_gemv", err)
    w4a8_gemv.launches += 1
    return out


w4a8_gemv.launches = 0


def matmul_4bit_w4a8(
    x: torch.Tensor,
    w: QLinearWeight,
    bias: Optional[torch.Tensor] = None,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """out ~= x @ dequant(W)^T with int8 activations and int8 weight codes.
    Compressed scales and untileable shapes take the exact path
    (matmul_4bit_fused), as in the JAX package."""
    from .matmul_4bit import _nk_tiles, matmul_4bit_fused

    N, K = w.shape
    lead = x.shape[:-1]
    M = int(np.prod(lead)) if lead else 1
    tn, tkb = _nk_tiles(w, N, K)
    if M == 0 or tn is None or tkb is None or w.compressed or K % (2 * w.blocksize) != 0:
        return matmul_4bit_fused(x, w, bias, compute_dtype=out_dtype)
    x2 = x.reshape(M, K)
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.float()
    out = w4a8_gemv(x2.contiguous(), w, bias, out_dtype)
    return out.reshape(*lead, N)
