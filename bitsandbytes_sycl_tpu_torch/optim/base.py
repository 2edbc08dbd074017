"""bnb-family 8-bit / 32-bit optimizers as ``torch.optim.Optimizer``s, the
port of the JAX package's ``optim/base.py`` (there optax transforms).

Per-parameter state: ``state1``, ``absmax1``[, ``state2``, ``absmax2``] for
an 8-bit leaf (uint8 codes of the dynamic maps, one f32 absmax per 2048
block, or with ``block_wise=False`` one block over the whole leaf),
``state1``[, ``state2``] in f32 otherwise, and ``gnorm_vec`` under
percentile clipping. A leaf is 8-bit when ``optim_bits == 8`` and its
``numel >= min_8bit_size``. One step count per optimizer (``count``), as
the JAX package's ``BnbOptimizerState.count``.

``optim_bits``, ``min_8bit_size``, ``percentile_clipping``, ``block_wise``,
``max_unorm`` and ``stochastic_rounding`` are param-group settings whose
defaults the constructor's values give, so one optimizer holds groups of
different configurations (``GlobalOptimManager.build``, the JAX package's
``multi_transform`` of one transform per override).

A step computes each leaf's new value and applies it as ``p + (new_p - p)``
in p's dtype, as ``optax.apply_updates`` adds the update the JAX
transform returns (it rounds otherwise than storing new_p). ``is_paged`` is
accepted and ignored, as in the JAX package.

A step takes three routes (``_route``), each leaf ending bit for bit where
its own update would put it:
- "grouped": every 8-bit leaf with contiguous f32 p and grad (not a view)
  goes through one launch of kernel J or K per device, blocksize and
  group configuration (the settings above; groups that differ only in
  lr, betas, eps or weight decay share a launch, their scalars in rows), in
  place (leaves of one block past 2048 elements, ``block_wise=False``,
  take kernel K's resident body, one launch per device and leaf size,
  where ``ops.optim8.leaf_plan`` routes them there, else the two-pass
  body, a launch pair)
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

Sharded states (``mesh=``, ``shard_axis``; ZeRO style): every rank holds
the whole params and gradients (data parallelism: the caller sums the
gradients over the ranks first), and a contiguous 8-bit leaf whose dim 0
divides by the mesh dim's size, with each rank's element count a multiple
of the blocksize (and no ``max_unorm``, whose norm is the whole leaf's),
keeps only this rank's dim-0 rows of its states. A step updates those
rows of p through the leaf's route (the slices of
``functional.optimizer_update_8bit_blockwise_sharded``) and all-gathers
the new rows into every rank's p, one all-gather per step; percentile
clipping reads the norm of the whole gradient (the ranks' squared norms
all-reduced). The other leaves take the unsharded routes, as in the JAX
package.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from .. import functional as F

__all__ = ["BnbOptimizer", "make_optimizer", "GlobalOptimManager"]

_2STATE = ("adam", "lamb")
# the param-group settings beside lr, betas, eps and weight_decay
_SETTINGS = ("optim_bits", "min_8bit_size", "percentile_clipping", "block_wise", "max_unorm",
             "stochastic_rounding")


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
        del is_paged
        self._shard = None
        if mesh is not None:
            from ..parallel.mesh import axis_group, axis_rank, axis_size

            # (group, size, rank) of the dim the states shard over
            self._shard = (axis_group(mesh, shard_axis), axis_size(mesh, shard_axis),
                           axis_rank(mesh, shard_axis))
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        optim_bits=optim_bits, min_8bit_size=min_8bit_size,
                        percentile_clipping=percentile_clipping, block_wise=block_wise,
                        max_unorm=max_unorm, stochastic_rounding=stochastic_rounding)
        self._by_param = None
        super().__init__(params, defaults)
        self.name = name
        self.count = 0
        self.route_leaves = {"grouped": 0, "batched": 0, "per_leaf": 0}

    def add_param_group(self, param_group: dict) -> None:
        super().add_param_group(param_group)
        self._by_param = None

    def state_dict(self) -> dict:
        """torch's optimizer state dict with the step count (``count``)."""
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore a ``state_dict()``: the param groups as torch restores
        them, each leaf's states as saved (torch would cast them to the
        param's dtype, turning uint8 codes into floats) on the param's
        device, and the step count."""
        sd = dict(state_dict)
        count = int(sd.pop("count", 0))
        saved = sd.pop("state")
        super().load_state_dict({**sd, "state": {}})
        self._by_param = None
        params = [p for g in self.param_groups for p in g["params"]]
        for idx, st in saved.items():
            p = params[int(idx)]
            self.state[p] = {k: v.to(p.device) if isinstance(v, torch.Tensor) else v
                             for k, v in st.items()}
        self.count = count

    def group_of(self, p: torch.Tensor) -> dict:
        """The param group that holds p."""
        if self._by_param is None:
            self._by_param = {id(q): g for g in self.param_groups for q in g["params"]}
        return self._by_param[id(p)]

    def setting(self, p: torch.Tensor, key: str):
        """A per-group setting (``_SETTINGS``) of leaf p."""
        return self.group_of(p)[key]

    def blocksize(self, p: torch.Tensor) -> int:
        """The quantization block of an 8-bit leaf: 2048, or with
        ``block_wise=False`` the whole leaf."""
        return 2048 if self.setting(p, "block_wise") else max(p.numel(), 1)

    def sharded(self, p: torch.Tensor) -> bool:
        """Whether leaf p's states are sharded over the mesh dim (see the
        module docstring)."""
        if self._shard is None or self.setting(p, "max_unorm") != 0.0 or not _leaf_is_8bit(
                p, self.setting(p, "optim_bits"), self.setting(p, "min_8bit_size")):
            return False
        n = self._shard[1]
        return (p.dim() > 0 and p.is_contiguous() and p.shape[0] % n == 0
                and (p.numel() // n) % self.blocksize(p) == 0)

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's dim-0 rows of a sharded leaf's tensor, a view."""
        _, n, r = self._shard
        rows = t.shape[0] // n
        return t[r * rows:(r + 1) * rows]

    def init_state(self, p: torch.Tensor) -> dict:
        """The leaf's zero state on p's device, as the JAX package's
        ``_init_leaf``; a sharded leaf's 8-bit states are this rank's rows."""
        dev = p.device
        two = self.name in _2STATE
        s: dict = {}
        if _leaf_is_8bit(p, self.setting(p, "optim_bits"), self.setting(p, "min_8bit_size")):
            shape = self._local(p).shape if self.sharded(p) else p.shape
            nb = F.blocks_for(shape.numel(), self.blocksize(p))
            s["state1"] = torch.zeros(shape, dtype=torch.uint8, device=dev)
            s["absmax1"] = torch.zeros((nb,), dtype=torch.float32, device=dev)
            if two:
                s["state2"] = torch.zeros(shape, dtype=torch.uint8, device=dev)
                s["absmax2"] = torch.zeros((nb,), dtype=torch.float32, device=dev)
        else:
            s["state1"] = torch.zeros(p.shape, dtype=torch.float32, device=dev)
            if two:
                s["state2"] = torch.zeros(p.shape, dtype=torch.float32, device=dev)
        if self.setting(p, "percentile_clipping") < 100:
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
        grouped, batched, single, gather = {}, {}, [], []
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
                # (param, the p and g the update reads and writes, state, hypers,
                # sharded): a sharded leaf's update reads and writes its rows
                item = (p, p, p.grad, s, hyper, False)
                if self.sharded(p):
                    item = (p, self._local(p.data), self._local(p.grad), s, hyper, True)
                    gather.append(p)
                if route == "grouped":
                    key = (p.device, self.blocksize(p), tuple(group[k] for k in _SETTINGS))
                    grouped.setdefault(key, []).append(item)
                elif route == "batched":
                    batched.setdefault((p.device, gi), []).append(item)
                else:
                    single.append(item)
        for (_, bs, _), items in grouped.items():
            self._step_grouped(items, count, bs)
        for items in batched.values():
            self._step_batched(items, count)
        for param, p, g, s, hyper, sharded in single:
            self._step_leaf(p, g, s, count, *hyper, param=param, sharded=sharded)
        if gather:
            self._gather_rows(gather)
        return loss

    def _gather_rows(self, params) -> None:
        """Every rank's new rows of the sharded leaves into every rank's
        params: one all-gather of the rows laid end to end."""
        from ..parallel.mesh import all_gather

        group, n, _ = self._shard
        by_dev = {}
        for p in params:
            by_dev.setdefault(p.device, []).append(p)
        for ps in by_dev.values():
            flat = torch.cat([self._local(p.data).reshape(-1) for p in ps])
            got = all_gather(flat, group, dim=0).reshape(n, -1)
            off = 0
            for p in ps:
                k = p.numel() // n
                p.data.view(n, k).copy_(got[:, off:off + k])
                off += k

    def _gnorms(self, grads, sharded) -> list:
        """The norm of each gradient, of the whole gradient for a sharded
        leaf's rows (the ranks' squared norms, all-reduced in one call)."""
        norms = [torch.linalg.vector_norm(g.float()) for g in grads]
        idx = [i for i, sh in enumerate(sharded) if sh]
        if idx:
            from ..parallel.mesh import psum

            sq = psum(torch.stack([norms[i] for i in idx]).square(), self._shard[0])
            for j, i in enumerate(idx):
                norms[i] = torch.sqrt(sq[j])
        return norms

    def _route(self, p: torch.Tensor, s: dict) -> str:
        """The route of leaf p with state s this step: "grouped" (8-bit),
        "batched" (32-bit) or "per_leaf" (see the module's docstring)."""
        g, s1, s2 = p.grad, s["state1"], s.get("state2")
        plain = (self.setting(p, "max_unorm") == 0.0 and p.dtype == torch.float32
                 and g.dtype == torch.float32 and p.is_contiguous() and g.is_contiguous()
                 and not p._is_view()
                 and s1.is_contiguous() and (s2 is None or s2.is_contiguous()))
        if not plain:
            return "per_leaf"
        if s1.dtype == torch.uint8:
            return "grouped"
        return "batched" if self.setting(p, "percentile_clipping") >= 100 else "per_leaf"

    def _step_grouped(self, items, count, blocksize):
        """The 8-bit leaves of one device, blocksize and group configuration:
        one launch of kernel J or K (a pair past 2048)."""
        p0 = items[0][0]
        clip = self.setting(p0, "percentile_clipping")
        scales = None
        if clip < 100:
            scales = []
            norms = self._gnorms([it[2] for it in items], [it[5] for it in items])
            for it, gnorm in zip(items, norms):
                s = it[3]
                s["gnorm_vec"], scale = F.percentile_clipping(gnorm, s["gnorm_vec"], count, clip)
                scales.append(scale)
        F.optimizer_update_8bit_grouped(
            self.name, [(g, p, s) for _, p, g, s, _, _ in items], [it[4] for it in items],
            count, gnorm_scales=scales, blocksize=blocksize,
            stochastic_rounding=self.setting(p0, "stochastic_rounding"))

    def _step_batched(self, items, count):
        """The 32-bit leaves of one device and param group: one update over
        their concatenation, p + (new_p - p) and the states scattered back."""
        lr, beta1, beta2, eps, wd = items[0][4]
        ps = [p for _, p, _, _, _, _ in items]
        sizes = [p.numel() for p in ps]

        def cat(ts):
            return torch.cat([t.reshape(-1) for t in ts])

        two = self.name in _2STATE
        pc = cat(ps)
        new_p, s1, s2 = F.optimizer_update_32bit(
            self.name, cat([p.grad for p in ps]), pc, cat([it[3]["state1"] for it in items]),
            cat([it[3]["state2"] for it in items]) if two else None, beta1, beta2, eps, count,
            lr, weight_decay=wd)
        torch._foreach_add_([p.view(-1) for p in ps], list((new_p - pc).split(sizes)))
        for name, new in (("state1", s1), ("state2", s2)):
            if new is not None:
                for (_, p, _, s, _, _), part in zip(items, new.split(sizes)):
                    s[name] = part.view(p.shape)

    def _step_leaf(self, p, g, s, count, lr, beta1, beta2, eps, wd, param=None, sharded=False):
        """One leaf's update of p from g: the param itself, or with
        ``sharded`` the rows of ``param`` this rank updates."""
        param = p if param is None else param
        gnorm_scale = 1.0
        clip = self.setting(param, "percentile_clipping")
        max_unorm = self.setting(param, "max_unorm")
        if clip < 100:
            gnorm = self._gnorms([g], [sharded])[0]
            s["gnorm_vec"], gnorm_scale = F.percentile_clipping(gnorm, s["gnorm_vec"], count, clip)
        eight = s["state1"].dtype == torch.uint8
        if eight:
            new_p, s["state1"], s["absmax1"], st2, am2 = F.optimizer_update_8bit_blockwise(
                self.name, g, p, s["state1"], s["absmax1"], s.get("state2"), s.get("absmax2"),
                None, None, beta1, beta2, eps, count, lr, weight_decay=wd,
                gnorm_scale=gnorm_scale, blocksize=self.blocksize(param), codec="dynamic",
                stochastic_rounding=self.setting(param, "stochastic_rounding"),
            )
            if self.name in _2STATE:
                s["state2"], s["absmax2"] = st2, am2
        else:
            new_p, s["state1"], s2 = F.optimizer_update_32bit(
                self.name, g, p, s["state1"], s.get("state2"), beta1, beta2, eps, count, lr,
                weight_decay=wd, gnorm_scale=gnorm_scale, max_unorm=max_unorm,
            )
            if self.name in _2STATE:
                s["state2"] = s2
        delta = new_p.float() - p.float()
        if max_unorm > 0.0 and eight:
            # the blockwise 8-bit update has no unorm machinery: clip the
            # realized update post hoc (+eps so zero-norm params move)
            unorm = torch.linalg.vector_norm(delta)
            limit = (max_unorm * torch.linalg.vector_norm(p.float()) + eps) * lr
            delta = delta * torch.where(unorm > limit, limit / unorm.clamp_min(1e-12),
                                        torch.ones_like(unorm))
        p.add_(delta.to(p.dtype))


def make_optimizer(params, name: str, learning_rate: Union[float, Callable] = 1e-3,
                   **kw) -> BnbOptimizer:
    """The JAX package's ``make_optimizer`` with the parameters first, as a
    ``torch.optim.Optimizer``."""
    return BnbOptimizer(params, name, lr=learning_rate, **kw)


# make_optimizer's keyword for the learning rate -> the param group's key
_GROUP_KEYS = {"learning_rate": "lr"}


class GlobalOptimManager:
    """Per-parameter optimizer overrides, the JAX package's
    GlobalOptimManager (the reference's registry that StableEmbedding uses
    to keep 32-bit states): register predicates over parameter paths, then
    ``build`` one optimizer whose param groups carry each override's
    configuration (the JAX package builds an ``optax.multi_transform`` of
    one transform per override)."""

    _instance: "GlobalOptimManager" = None

    def __init__(self):
        self.overrides: list = []

    @classmethod
    def get_instance(cls) -> "GlobalOptimManager":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def register_module_override(self, match, **config):
        """``match``: a substring of the parameter's path, or a predicate
        over the path; ``config``: make_optimizer keywords for the leaves
        it matches (the last matching override wins)."""
        if isinstance(match, str):
            needle = match
            match = lambda path: needle in path  # noqa: E731
        self.overrides.append((match, config))

    def override_config(self, match, **config):
        self.register_module_override(match, **config)

    @staticmethod
    def _paths(params):
        """(path, tensor) of every parameter: a dict/list tree's keys joined
        by "/", or an nn.Module's ``named_parameters`` with "/" for "."."""
        if isinstance(params, torch.nn.Module):
            return [(n.replace(".", "/"), p) for n, p in params.named_parameters()]
        out = []

        def walk(obj, prefix):
            if isinstance(obj, torch.Tensor):
                out.append(("/".join(prefix), obj))
            elif isinstance(obj, dict):
                for k, v in obj.items():
                    walk(v, prefix + [str(k)])
            else:
                for i, v in enumerate(obj):
                    walk(v, prefix + [str(i)])

        walk(params, [])
        return out

    def build(self, name: str, params, **default_kwargs) -> BnbOptimizer:
        """One BnbOptimizer over ``params`` (a dict/list tree of tensors, or
        an nn.Module): a param group per override that matches a leaf, with
        ``{**default_kwargs, **override}`` as its configuration, beside the
        default group."""
        labels: dict = {}
        for path, p in self._paths(params):
            label = 0
            for j, (pred, _) in enumerate(self.overrides, start=1):
                if pred(path):
                    label = j
            labels.setdefault(label, []).append(p)
        groups = []
        for label in sorted(labels):
            group = {"params": labels[label]}
            if label:
                for k, v in self.overrides[label - 1][1].items():
                    group[_GROUP_KEYS.get(k, k)] = tuple(v) if k == "betas" else v
            groups.append(group)
        return make_optimizer(groups, name, **default_kwargs)
