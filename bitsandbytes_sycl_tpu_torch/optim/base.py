"""bnb-family 8-bit / 32-bit optimizers as ``torch.optim.Optimizer``s, the
port of the JAX package's ``optim/base.py`` (there optax transforms).

Per-parameter state: ``state1``, ``absmax1``[, ``state2``, ``absmax2``] for
an 8-bit leaf (uint8 codes of the dynamic maps, one f32 absmax per 2048
block, or with ``block_wise=False`` one block over the whole leaf),
``state1``[, ``state2``] in f32 otherwise, and ``gnorm_vec`` under
percentile clipping. A leaf is 8-bit when ``optim_bits == 8`` and its
``numel >= min_8bit_size``. One step count per optimizer (``count``), as
the JAX package's ``BnbOptimizerState.count``.

A step computes each leaf's new value and applies it as ``p + (new_p - p)``
in p's dtype, as ``optax.apply_updates`` adds the update the JAX
transform returns (it rounds otherwise than storing new_p). ``is_paged`` is
accepted and ignored, as in the JAX package.

A step takes three routes (``_route``), each leaf ending bit for bit where
its own update would put it:
- "grouped": every 8-bit leaf with contiguous f32 p and grad (not a view)
  goes through one launch of kernel J or K per device and blocksize, in
  place (a leaf of one block past 2048 elements, ``block_wise=False``,
  takes the two-pass body: a launch pair per device and leaf size)
  (``functional.optimizer_update_8bit_grouped``; param groups and
  percentile clipping as rows of the launch's scalars, stochastic
  rounding's uniforms in its leaf table);
- "batched": the 32-bit leaves of the same kind, without percentile
  clipping, go through one ``optimizer_update_32bit`` per device and param
  group over their concatenation, scattered back (every operation there is
  elementwise);
- "per_leaf": the rest (``max_unorm > 0``, whose norm is per leaf;
  percentile clipping of a 32-bit leaf; other dtypes, non-contiguous
  tensors and views), one update each.
``route_leaves`` counts the leaves each route has stepped.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from .. import functional as F

__all__ = ["BnbOptimizer", "make_optimizer"]

_2STATE = ("adam", "lamb")


def _leaf_is_8bit(p: torch.Tensor, optim_bits: int, min_8bit_size: int) -> bool:
    return optim_bits == 8 and p.numel() >= min_8bit_size


class BnbOptimizer(torch.optim.Optimizer):
    """One bnb-family optimizer over ``params``; ``name`` in {"adam",
    "lamb", "momentum", "lion", "rmsprop", "adagrad"}. ``lr`` may be a
    callable of the step count."""

    def __init__(
        self,
        params,
        name: str,
        lr: Union[float, Callable] = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        optim_bits: int = 32,
        min_8bit_size: int = 4096,
        percentile_clipping: int = 100,
        block_wise: bool = True,
        max_unorm: float = 0.0,
        is_paged: bool = False,
        mesh=None,
        shard_axis: str = "data",
        stochastic_rounding: bool = False,
    ):
        if name not in _2STATE and name not in F.OPTIMIZER_FUNCS_1STATE:
            raise NotImplementedError(f"optimizer {name!r} not implemented")
        if mesh is not None:
            raise NotImplementedError(
                "sharded optimizer states (mesh=) are not ported yet (ROADMAP Queue A #13)")
        del is_paged, shard_axis
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.name = name
        self.optim_bits = optim_bits
        self.min_8bit_size = min_8bit_size
        self.percentile_clipping = percentile_clipping
        self.max_unorm = max_unorm
        self.stochastic_rounding = stochastic_rounding
        self.block_wise = block_wise
        self.count = 0
        self.route_leaves = {"grouped": 0, "batched": 0, "per_leaf": 0}

    def blocksize(self, p: torch.Tensor) -> int:
        """The quantization block of an 8-bit leaf: 2048, or with
        ``block_wise=False`` the whole leaf."""
        return 2048 if self.block_wise else max(p.numel(), 1)

    def init_state(self, p: torch.Tensor) -> dict:
        """The leaf's zero state on p's device, as the JAX package's
        ``_init_leaf``."""
        dev = p.device
        two = self.name in _2STATE
        s: dict = {}
        if _leaf_is_8bit(p, self.optim_bits, self.min_8bit_size):
            nb = F.blocks_for(p.numel(), self.blocksize(p))
            s["state1"] = torch.zeros(p.shape, dtype=torch.uint8, device=dev)
            s["absmax1"] = torch.zeros((nb,), dtype=torch.float32, device=dev)
            if two:
                s["state2"] = torch.zeros(p.shape, dtype=torch.uint8, device=dev)
                s["absmax2"] = torch.zeros((nb,), dtype=torch.float32, device=dev)
        else:
            s["state1"] = torch.zeros(p.shape, dtype=torch.float32, device=dev)
            if two:
                s["state2"] = torch.zeros(p.shape, dtype=torch.float32, device=dev)
        if self.percentile_clipping < 100:
            s["gnorm_vec"] = torch.zeros((100,), dtype=torch.float32, device=dev)
        return s

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.count += 1
        count = self.count
        grouped, batched, single = {}, {}, []
        for gi, group in enumerate(self.param_groups):
            lr = group["lr"](count) if callable(group["lr"]) else group["lr"]
            beta1, beta2 = group["betas"]
            hyper = (lr, beta1, beta2, group["eps"], group["weight_decay"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                s = self.state[p]
                if not s:
                    s.update(self.init_state(p))
                route = self._route(p, s)
                self.route_leaves[route] += 1
                if route == "grouped":
                    grouped.setdefault((p.device, self.blocksize(p)), []).append((p, s, hyper))
                elif route == "batched":
                    batched.setdefault((p.device, gi), []).append((p, s, hyper))
                else:
                    single.append((p, s, hyper))
        for (_, bs), items in grouped.items():
            self._step_grouped(items, count, bs)
        for items in batched.values():
            self._step_batched(items, count)
        for p, s, hyper in single:
            self._step_leaf(p, p.grad, s, count, *hyper)
        return loss

    def _route(self, p: torch.Tensor, s: dict) -> str:
        """The route of leaf p with state s this step: "grouped" (8-bit),
        "batched" (32-bit) or "per_leaf" (see the module's docstring)."""
        g, s1, s2 = p.grad, s["state1"], s.get("state2")
        plain = (self.max_unorm == 0.0 and p.dtype == torch.float32 and g.dtype == torch.float32
                 and p.is_contiguous() and g.is_contiguous() and not p._is_view()
                 and s1.is_contiguous() and (s2 is None or s2.is_contiguous()))
        if not plain:
            return "per_leaf"
        if s1.dtype == torch.uint8:
            return "grouped"
        return "batched" if self.percentile_clipping >= 100 else "per_leaf"

    def _step_grouped(self, items, count, blocksize):
        """The 8-bit leaves of one device and blocksize: one launch of
        kernel J or K (a pair past 2048)."""
        scales = None
        if self.percentile_clipping < 100:
            scales = []
            for p, s, _ in items:
                gnorm = torch.linalg.vector_norm(p.grad.float())
                s["gnorm_vec"], scale = F.percentile_clipping(
                    gnorm, s["gnorm_vec"], count, self.percentile_clipping)
                scales.append(scale)
        F.optimizer_update_8bit_grouped(
            self.name, [(p.grad, p, s) for p, s, _ in items], [h for _, _, h in items], count,
            gnorm_scales=scales, blocksize=blocksize,
            stochastic_rounding=self.stochastic_rounding)

    def _step_batched(self, items, count):
        """The 32-bit leaves of one device and param group: one update over
        their concatenation, p + (new_p - p) and the states scattered back."""
        lr, beta1, beta2, eps, wd = items[0][2]
        ps = [p for p, _, _ in items]
        sizes = [p.numel() for p in ps]

        def cat(ts):
            return torch.cat([t.reshape(-1) for t in ts])

        two = self.name in _2STATE
        pc = cat(ps)
        new_p, s1, s2 = F.optimizer_update_32bit(
            self.name, cat([p.grad for p in ps]), pc, cat([s["state1"] for _, s, _ in items]),
            cat([s["state2"] for _, s, _ in items]) if two else None, beta1, beta2, eps, count,
            lr, weight_decay=wd)
        torch._foreach_add_([p.view(-1) for p in ps], list((new_p - pc).split(sizes)))
        for name, new in (("state1", s1), ("state2", s2)):
            if new is not None:
                for (p, s, _), part in zip(items, new.split(sizes)):
                    s[name] = part.view(p.shape)

    def _step_leaf(self, p, g, s, count, lr, beta1, beta2, eps, wd):
        gnorm_scale = 1.0
        if self.percentile_clipping < 100:
            gnorm = torch.linalg.vector_norm(g.float())
            s["gnorm_vec"], gnorm_scale = F.percentile_clipping(
                gnorm, s["gnorm_vec"], count, self.percentile_clipping)
        eight = s["state1"].dtype == torch.uint8
        if eight:
            new_p, s["state1"], s["absmax1"], st2, am2 = F.optimizer_update_8bit_blockwise(
                self.name, g, p, s["state1"], s["absmax1"], s.get("state2"), s.get("absmax2"),
                None, None, beta1, beta2, eps, count, lr, weight_decay=wd,
                gnorm_scale=gnorm_scale, blocksize=self.blocksize(p), codec="dynamic",
                stochastic_rounding=self.stochastic_rounding,
            )
            if self.name in _2STATE:
                s["state2"], s["absmax2"] = st2, am2
        else:
            new_p, s["state1"], s2 = F.optimizer_update_32bit(
                self.name, g, p, s["state1"], s.get("state2"), beta1, beta2, eps, count, lr,
                weight_decay=wd, gnorm_scale=gnorm_scale, max_unorm=self.max_unorm,
            )
            if self.name in _2STATE:
                s["state2"] = s2
        delta = new_p.float() - p.float()
        if self.max_unorm > 0.0 and eight:
            # the blockwise 8-bit update has no unorm machinery: clip the
            # realized update post hoc (+eps so zero-norm params move)
            unorm = torch.linalg.vector_norm(delta)
            limit = (self.max_unorm * torch.linalg.vector_norm(p.float()) + eps) * lr
            delta = delta * torch.where(unorm > limit, limit / unorm.clamp_min(1e-12),
                                        torch.ones_like(unorm))
        p.add_(delta.to(p.dtype))


def make_optimizer(params, name: str, learning_rate: Union[float, Callable] = 1e-3,
                   **kw) -> BnbOptimizer:
    """The JAX package's ``make_optimizer`` with the parameters first, as a
    ``torch.optim.Optimizer``."""
    return BnbOptimizer(params, name, lr=learning_rate, **kw)
