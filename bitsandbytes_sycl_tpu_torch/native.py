"""The host quantization library: ``csrc/quant_cpu.cpp`` built by ``g++``
at first use and bound with ctypes (the JAX package's ``native.py``).

The library speeds up host-side work only (quantizing or converting a
multi-GB checkpoint on the CPU); device compute is the CUDA kernels. It is
compiled into ``build/bnb_torch_native/<hash>/`` beside the package (the
hash covers the source and the flags), never into the source tree. The
flags keep its bytes independent of the machine that built it: no
``-march=native`` and no FMA contraction (``-ffp-contract=off``), so its
codes equal the port's torch quantizers' bit for bit. Where ``g++`` is
missing or fails, every function falls back to numpy with the same bytes.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["get_native_library", "build_native", "quantize_blockwise_np", "quantize_4bit_np",
           "bf16_to_f32", "fp16_to_f32"]

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "csrc" / "quant_cpu.cpp"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "bnb_torch_native"
GXX_FLAGS = ["-O3", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_REQUIRED_VERSION = 2
_lib: Optional[ct.CDLL] = None
_tried = False


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def _load(path: Path) -> ct.CDLL:
    lib = ct.CDLL(str(path))
    lib.quant_cpu_version.restype = ct.c_int
    if lib.quant_cpu_version() < _REQUIRED_VERSION:
        raise RuntimeError(f"{path}: stale host library")
    return lib


def build_native() -> float:
    """Compile the library anew with ``g++`` and load it, whether or not a
    build exists (a fresh build on this machine). Raises when ``g++`` is
    missing or fails. Returns the seconds it took."""
    global _lib, _tried
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: it is needed to build the host library")
    t0 = time.perf_counter()
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libquant_cpu.so"
    tmp = out / f"libquant_cpu.{os.getpid()}.tmp.so"
    proc = subprocess.run([gxx, *GXX_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    _lib, _tried = _load(so), True
    return time.perf_counter() - t0


def get_native_library() -> Optional[ct.CDLL]:
    """The host library, built on first use; None where it cannot be built
    or loaded (the callers then take their numpy paths)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build_dir() / "libquant_cpu.so"
    try:
        if so.exists():
            _lib = _load(so)
        else:
            build_native()
    except Exception as e:  # noqa: BLE001 - any failure leaves the numpy paths
        logger.warning("host library unavailable (%s); using numpy", e)
        _lib = None
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ct.c_void_p)


def _mids(sorted_vals: np.ndarray) -> np.ndarray:
    # 0.5 * (a + b) in f32, as the C++ computes it
    return (np.float32(0.5) * (sorted_vals[1:] + sorted_vals[:-1])).astype(np.float32)


def _inv(absmax: np.ndarray) -> np.ndarray:
    ok = absmax > 0
    return np.where(ok, np.float32(1.0) / np.where(ok, absmax, np.float32(1.0)),
                    np.float32(0.0)).astype(np.float32)


def quantize_blockwise_np(A: np.ndarray, code_sorted: np.ndarray,
                          blocksize: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host 8-bit blockwise quantization against a sorted 256-entry table:
    (uint8 codes in A's shape, f32 absmax per block)."""
    A = np.ascontiguousarray(A, np.float32)
    n = A.size
    nb = (n + blocksize - 1) // blocksize
    out = np.empty(n, np.uint8)
    absmax = np.empty(nb, np.float32)
    code_sorted = np.ascontiguousarray(code_sorted, np.float32)
    lib = get_native_library()
    if lib is not None:
        lib.quantize_blockwise_cpu_fp32(_ptr(code_sorted), _ptr(A.reshape(-1)), _ptr(absmax),
                                        _ptr(out), ct.c_int(blocksize), ct.c_long(n))
        return out.reshape(A.shape), absmax
    fp = np.pad(A.reshape(-1), (0, nb * blocksize - n)).reshape(nb, blocksize)
    absmax[:] = np.abs(fp).max(1)
    codes = np.searchsorted(_mids(code_sorted), fp * _inv(absmax)[:, None], side="left")
    return codes.astype(np.uint8).reshape(-1)[:n].reshape(A.shape), absmax


def quantize_4bit_np(A: np.ndarray, code16: np.ndarray,
                     blocksize: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host 4-bit blockwise quantization against a 16-entry table in code
    order: (packed bytes in bnb order, element 2i in the high nibble; f32
    absmax per block)."""
    A = np.ascontiguousarray(A, np.float32)
    n = A.size
    nb = (n + blocksize - 1) // blocksize
    code16 = np.ascontiguousarray(code16, np.float32)
    lib = get_native_library()
    if lib is not None:
        out = np.empty((n + 1) // 2, np.uint8)
        absmax = np.empty(nb, np.float32)
        lib.quantize_4bit_cpu_fp32(_ptr(code16), _ptr(A.reshape(-1)), _ptr(absmax), _ptr(out),
                                   ct.c_int(blocksize), ct.c_long(n))
        return out, absmax
    order = np.argsort(code16, kind="stable")
    fp = np.pad(A.reshape(-1), (0, nb * blocksize - n)).reshape(nb, blocksize)
    absmax = np.abs(fp).max(1).astype(np.float32)
    rank = np.searchsorted(_mids(code16[order]), fp * _inv(absmax)[:, None], side="left")
    codes = order[rank].astype(np.uint8).reshape(-1)[:n]
    if n % 2:
        codes = np.pad(codes, (0, 1))
    pairs = codes.reshape(-1, 2)
    return (pairs[:, 0] << 4 | pairs[:, 1]).astype(np.uint8), absmax


def _has(name: str) -> bool:
    lib = get_native_library()
    return lib is not None and hasattr(lib, name)


def bf16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) -> float32, multithreaded in the library."""
    raw_u16 = np.ascontiguousarray(raw_u16, np.uint16)
    if _has("bf16_to_f32_cpu"):
        out = np.empty(raw_u16.size, np.float32)
        get_native_library().bf16_to_f32_cpu(_ptr(raw_u16), _ptr(out), ct.c_long(raw_u16.size))
        return out.reshape(raw_u16.shape)
    return (raw_u16.astype(np.uint32) << 16).view(np.float32).reshape(raw_u16.shape)


def fp16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    """fp16 bit patterns (uint16) -> float32, multithreaded in the library."""
    raw_u16 = np.ascontiguousarray(raw_u16, np.uint16)
    if _has("fp16_to_f32_cpu"):
        out = np.empty(raw_u16.size, np.float32)
        get_native_library().fp16_to_f32_cpu(_ptr(raw_u16), _ptr(out), ct.c_long(raw_u16.size))
        return out.reshape(raw_u16.shape)
    return raw_u16.view(np.float16).astype(np.float32).reshape(raw_u16.shape)
