"""Build and bind the hand-written Hopper kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a source builds in
seconds), all sources at once in parallel, under
``build/bnb_torch_kernels/<hash>/`` beside the package. The hash covers
the sources, the headers and the flags, so an edited source builds anew.
Libraries load through ``ctypes``; each C entry launches on the stream it
is given and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["build_all", "build_variants", "use_library", "kernel_fn", "check"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "bnb_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def _start(src: Path, so: Path, extra=(), verbose: bool = False):
    """Start one nvcc of ``src`` into ``so`` (through a temporary file)."""
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-I", str(_CSRC), "-o", str(tmp), str(src)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return src, so, tmp, proc


def _finish(jobs, verbose: bool = False) -> None:
    """Wait for started nvcc jobs; raise with every failure's errors."""
    errors = []
    for src, so, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        if verbose and (stdout or stderr):
            print(f"[nvcc {src.name}]\n{stdout}{stderr}")
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))


def build_all(verbose: bool = False) -> float:
    """Compile every source not yet built (one nvcc each, all started
    together) and load the libraries. Returns the seconds it took."""
    t0 = time.perf_counter()
    if len(_libs) == len(list(_CSRC.glob("*.cu"))) and _libs:
        return 0.0
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    _finish([_start(src, out / f"lib{src.stem}.so", verbose=verbose)
             for src in sorted(_CSRC.glob("*.cu")) if not (out / f"lib{src.stem}.so").exists()],
            verbose)
    for src in sorted(_CSRC.glob("*.cu")):
        _libs[src.stem] = ctypes.CDLL(str(out / f"lib{src.stem}.so"))
    return time.perf_counter() - t0


def build_variants(variants: Dict[str, tuple]) -> Dict[str, ctypes.CDLL]:
    """Single sources built with extra ``-D`` macros, all at once, beside
    the package's own build: {key: (stem, macros)} -> {key: library}. The
    macros are the BNB_PROBE_* switches that ``chip_smoke.py --probe``
    uses to time a kernel with one part switched off."""
    out = _build_dir() / "variants"
    out.mkdir(parents=True, exist_ok=True)
    sos = {key: out / f"lib{stem}.{'.'.join(macros)}.so" for key, (stem, macros) in variants.items()}
    _finish([_start(_CSRC / f"{stem}.cu", sos[key], [f"-D{m}" for m in macros])
             for key, (stem, macros) in variants.items() if not sos[key].exists()])
    return {key: ctypes.CDLL(str(so)) for key, so in sos.items()}


def use_library(stem: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Make the wrappers call ``lib`` for ``csrc/<stem>.cu`` (a build of
    ``build_variants``, or the library this returned to put it back);
    returns the library used before."""
    build_all()
    old = _libs[stem]
    _libs[stem] = lib
    for key in [k for k in _fns if k.startswith(f"{stem}.")]:
        del _fns[key]
    return old


def kernel_fn(lib: str, name: str, nargs: int, int_args=(), float_args=(), long_args=()):
    """The C entry ``name`` of ``lib{lib}.so`` with its argtypes set:
    ``c_int`` at the positions in ``int_args``, ``c_float`` at those in
    ``float_args``, ``c_longlong`` at those in ``long_args``, ``c_void_p``
    (pointers and the stream) elsewhere."""
    key = f"{lib}.{name}"
    fn = _fns.get(key)
    if fn is None:
        build_all()
        fn = getattr(_libs[lib], name)
        fn.argtypes = [
            ctypes.c_int if i in int_args else ctypes.c_float if i in float_args
            else ctypes.c_longlong if i in long_args else ctypes.c_void_p
            for i in range(nargs)
        ]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
