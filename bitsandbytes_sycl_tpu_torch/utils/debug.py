"""Numerical checks (the JAX package's ``utils/debug.py``): ``checked``
runs a function under a dispatch mode that raises on the first
non-finite float result of any PyTorch op inside it, as
``checkify.float_checks`` does; ``nan_guard`` and ``check_quant_state``
raise at once on what they find. Debug tools: the mode reads every
result, which synchronizes a CUDA stream per op."""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["FloatCheckError", "nan_guard", "check_quant_state", "checked"]

# ops whose result holds no computed values: new uninitialized memory
_UNINITIALIZED = ("empty", "new_empty", "empty_like", "empty_strided", "new_empty_strided",
                  "resize_", "set_")


class FloatCheckError(RuntimeError):
    """A float check failed: a NaN or an infinity where it was checked."""


class _FloatChecks(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] not in _UNINITIALIZED:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel() \
                        and not bool(torch.isfinite(t).all()):
                    raise FloatCheckError(f"non-finite values in the result of {func}")
        return out


def checked(fn: Callable) -> Callable:
    """``fn`` whose float errors (a NaN or an infinity in any op's result
    inside it) raise FloatCheckError at the op instead of propagating."""

    @functools.wraps(fn)
    def run(*args, **kw):
        with _FloatChecks():
            return fn(*args, **kw)

    return run


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def nan_guard(tree, name: str = "tree") -> None:
    """Raise FloatCheckError unless every float tensor of a tree of dicts
    and lists is finite."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                and not bool(torch.isfinite(leaf).all()):
            raise FloatCheckError(f"non-finite values in {name}{path}")


def check_quant_state(packed, quant_state, name: str = "weight") -> None:
    """Invariants of a quantized tensor: its absmax is finite and not
    negative (an all-zero absmax block silently zeroes its weights)."""
    am = quant_state.dequant_absmax() if hasattr(quant_state, "dequant_absmax") else quant_state
    if not bool(torch.isfinite(am).all()):
        raise FloatCheckError(f"{name}: non-finite absmax")
    if not bool((am >= 0).all()):
        raise FloatCheckError(f"{name}: negative absmax")
