"""AnalysisAdam: a diagnostic of 8-bit quantization error, the JAX
package's ``optim/analysis.py`` as a ``torch.optim.Optimizer``.

Each step runs exact f32 Adam, round-trips the update through 8 bits in
one of three modes ("dynamic-blockwise": the dynamic map in blocks of
2048; "linear": one block over the whole update; "quantile": the update's
own quantiles as the codebook), applies the round-tripped update and
accumulates, per parameter, the absolute and relative error against the
exact update (``abserr``, ``relerr``) and the elements counted
(``counts``). The statistics are scalars in the parameter's state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import functional as F

__all__ = ["AnalysisAdam", "analysis_adam", "AnalysisAdamState"]


class AnalysisAdamState(NamedTuple):
    """The JAX package's state layout: the step count and, per parameter,
    ``exp_avg``, ``exp_avg_sq``, ``abserr``, ``relerr`` and ``counts``."""

    count: int
    inner: dict


def _quantize_update(u: torch.Tensor, analysis: str) -> torch.Tensor:
    """The 8-bit quantize-dequantize round trip of the update."""
    if analysis == "dynamic-blockwise":
        q, qs = F.quantize_blockwise(u, blocksize=2048)
        return F.dequantize_blockwise(q, qs)
    if analysis == "linear":
        q, qs = F.quantize_blockwise(u, blocksize=u.numel(), quant_type="linear")
        return F.dequantize_blockwise(q, qs)
    if analysis == "quantile":
        code = F.estimate_quantiles(u)
        q, qs = F.quantize_blockwise(u, code=code, blocksize=u.numel())
        return F.dequantize_blockwise(q, qs)
    raise ValueError(f"unknown analysis {analysis!r}")


class AnalysisAdam(torch.optim.Optimizer):
    """Exact f32 Adam whose applied update is the 8-bit round trip of the
    exact one, with the round trip's error statistics in each parameter's
    state."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, analysis: str = "dynamic-blockwise"):
        if analysis not in ("dynamic-blockwise", "linear", "quantile"):
            raise ValueError(f"unknown analysis {analysis!r}")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, analysis=analysis))
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.count += 1
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            # the bias corrections in f32, as the JAX package's b ** count
            c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** self.count
            c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** self.count
            for p in group["params"]:
                if p.grad is None:
                    continue
                s = self.state[p]
                if not s:
                    s["exp_avg"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    s["exp_avg_sq"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    s["abserr"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    s["relerr"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    s["counts"] = torch.zeros((), dtype=torch.int32, device=p.device)
                g = p.grad.float()
                m = s["exp_avg"] * b1 + (1.0 - b1) * g
                v = s["exp_avg_sq"] * b2 + (1.0 - b2) * g * g
                # a tensor over a tensor: PyTorch takes a Python scalar over
                # a tensor as the tensor's rounded reciprocal times the scalar
                step_size = torch.tensor(lr, dtype=torch.float32, device=p.device) / c1.to(p.device)
                denom = torch.sqrt(v / c2.to(p.device)) + eps
                u = -step_size * (m / denom)  # the exact f32 Adam update
                uq = _quantize_update(u, group["analysis"])
                err = torch.abs(uq - u)
                rel = err / (torch.abs(u) + 1e-15)
                upd = uq
                if wd > 0.0:
                    upd = upd - lr * wd * p.float()
                p.add_(upd.to(p.dtype))
                s["exp_avg"], s["exp_avg_sq"] = m, v
                s["abserr"] = s["abserr"] + err.sum()
                s["relerr"] = s["relerr"] + rel.sum()
                s["counts"] = s["counts"] + u.numel()
        return loss

    def analysis_state(self) -> AnalysisAdamState:
        """The JAX package's ``AnalysisAdamState`` view: the count and each
        parameter's state, in parameter order."""
        return AnalysisAdamState(self.count, [dict(self.state[p]) for g in self.param_groups
                                              for p in g["params"]])


def analysis_adam(params, learning_rate: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                  weight_decay: float = 0.0, analysis: str = "dynamic-blockwise") -> AnalysisAdam:
    """The JAX package's ``analysis_adam`` with the parameters first."""
    return AnalysisAdam(params, learning_rate, betas, eps, weight_decay, analysis)
