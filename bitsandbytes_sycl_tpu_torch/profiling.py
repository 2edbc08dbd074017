"""Tracing, timing and roofline reporting (the JAX package's
``profiling.py``) on ``torch.profiler`` and CUDA events.

- ``trace(log_dir)``: a ``torch.profiler`` context (CPU and, where there
  is one, CUDA activity) that writes a Chrome trace into ``log_dir``.
- ``device_time(op, *args)``: the time of one call of ``op(*args)``, as the
  difference of two loops of ``lo_iters`` and ``hi_iters`` calls divided by
  the difference of the counts, the fastest of ``reps`` runs of each. On
  the card each loop is timed with CUDA events after a spin kernel long
  enough for the host to queue the whole loop, so neither the host's
  enqueue time nor the fixed costs of a loop are counted. On the CPU,
  ``time.perf_counter``. ``cold=True`` flushes the L2 cache before every
  call and subtracts a loop of the flushes alone.
- ``roofline_report``: that time beside the card's peaks (``ChipSpec``,
  ``current_chip()``), as achieved TFLOP/s and GB/s and fractions of the
  peaks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

logger = logging.getLogger("bitsandbytes_sycl_tpu_torch")

__all__ = ["trace", "device_time", "roofline_report", "ChipSpec", "CHIP_SPECS", "current_chip",
           "log_metrics"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float  # memory bandwidth, GB/s
    bf16_tflops: float  # dense bf16 tensor-core peak
    int8_tops: float  # dense int8 tensor-core peak
    vmem_mb: float = 0.0  # on-chip cache a kernel reuses from (the L2), MB


CHIP_SPECS = {
    # H100 SXM5 data sheet: HBM3 3.35 TB/s, dense bf16 989 TFLOP/s, dense
    # int8 1979 TOPS, 50 MB L2
    "H100": ChipSpec("H100", hbm_gbps=3350.0, bf16_tflops=989.0, int8_tops=1979.0,
                     vmem_mb=50.0),
    "cpu": ChipSpec("cpu", hbm_gbps=50.0, bf16_tflops=1.0, int8_tops=2.0),
}

_L2_FLUSH_BYTES = 2 * 50 * 1024 * 1024  # twice the H100's L2
_SPIN_CYCLES_PER_S = 1.98e9  # the H100's boost clock; the spin only needs to be long enough


def current_chip() -> ChipSpec:
    """The entry of CUDA device 0 (matched by name), or the CPU's."""
    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
        for key, spec in CHIP_SPECS.items():
            if key.lower() in kind.lower():
                return spec
    return CHIP_SPECS["cpu"]


def _default_trace_dir() -> str:
    return str(Path(__file__).resolve().parent.parent / "build" / "bnb_torch_trace")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block, written as a Chrome trace
    (``trace.json``) into ``log_dir`` (default: ``build/bnb_torch_trace``
    beside the package); yields the profiler."""
    log_dir = log_dir or _default_trace_dir()
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _on_cuda(args) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.device
    return None


def _loop_cuda(call: Callable, iters: int, host_s: float, device) -> float:
    """Seconds of ``iters`` calls on the device, the host having queued them
    all behind a spin kernel before the start event runs."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    torch.cuda._sleep(int(min(2.0 * iters * host_s + 1e-4, 0.5) * _SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def _loop_cpu(call: Callable, iters: int) -> float:
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return time.perf_counter() - t0


def device_time(op: Callable, *args, lo_iters: int = 50, hi_iters: int = 350, reps: int = 5,
                cold: bool = False) -> float:
    """Seconds of one ``op(*args)`` call: (t(hi_iters) - t(lo_iters)) /
    (hi_iters - lo_iters), each t the fastest of ``reps`` loops. On the
    card (any CUDA tensor argument) the loops run on CUDA events behind a
    spin kernel; on the CPU on ``time.perf_counter``. ``cold`` (card only):
    every call follows a write of twice the L2, and the same loop of the
    writes alone is subtracted."""
    device = _on_cuda(args)
    flush = None
    if cold and device is not None:
        flush = torch.empty(_L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)

    def call():
        if flush is not None:
            flush.fill_(1.0)
        op(*args)

    def flush_only():
        flush.fill_(1.0)

    def per_call(fn) -> float:
        for _ in range(3):  # warm-up: builds, caches, allocations
            fn()
        if device is None:
            times = {n: min(_loop_cpu(fn, n) for _ in range(reps)) for n in (lo_iters, hi_iters)}
        else:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(8):
                fn()
            host_s = (time.perf_counter() - t0) / 8
            times = {n: min(_loop_cuda(fn, n, host_s, device) for _ in range(reps))
                     for n in (lo_iters, hi_iters)}
        return (times[hi_iters] - times[lo_iters]) / (hi_iters - lo_iters)

    t = per_call(call)
    if flush is not None:
        t -= per_call(flush_only)
    return t


def roofline_report(name: str, op: Callable, *args, flops: float = 0.0,
                    bytes_accessed: float = 0.0, chip: Optional[ChipSpec] = None,
                    **kw) -> Dict[str, float]:
    """Time ``op(*args)`` (``device_time``, its keywords in ``kw``) and
    report achieved TFLOP/s and GB/s as fractions of the chip's peaks
    (``frac_mxu_roofline``: of the bf16 tensor-core peak;
    ``frac_hbm_roofline``: of the memory bandwidth)."""
    chip = chip or current_chip()
    t = device_time(op, *args, **kw)
    out = {
        "name": name,
        "chip": chip.name,
        "time_us": t * 1e6,
        "achieved_tflops": flops / t / 1e12 if flops else 0.0,
        "achieved_gbps": bytes_accessed / t / 1e9 if bytes_accessed else 0.0,
        "frac_mxu_roofline": (flops / t / 1e12) / chip.bf16_tflops if flops else 0.0,
        "frac_hbm_roofline": (bytes_accessed / t / 1e9) / chip.hbm_gbps if bytes_accessed else 0.0,
    }
    logger.info("roofline %s", json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                           for k, v in out.items()}))
    return out


def log_metrics(step: int, **metrics) -> None:
    """One JSON line of per-step metrics (tokens/s, loss, ...) on the
    package's logger."""
    logger.info(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}))
