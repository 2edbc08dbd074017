"""Optimizer families of the JAX package's ``optim/__init__.py`` as
``torch.optim.Optimizer``s: every family has base, 8bit, 32bit (and
``paged_*``, the paging flag ignored) constructors under the JAX names,
with the parameters first, plus the class-name aliases; the per-parameter
overrides (``GlobalOptimManager``) and the quantization-error diagnostic
(``analysis_adam``)."""

from __future__ import annotations

from functools import partial as _partial

from .analysis import AnalysisAdam, AnalysisAdamState, analysis_adam
from .base import BnbOptimizer, GlobalOptimManager, make_optimizer


def _family(name, default_betas=(0.9, 0.999), default_eps=1e-8, **fixed):
    def ctor(params, learning_rate=1e-3, betas=default_betas, eps=default_eps, weight_decay=0.0,
             optim_bits=32, min_8bit_size=4096, percentile_clipping=100, block_wise=True,
             is_paged=False, **kw):
        return make_optimizer(
            params, name, learning_rate=learning_rate, betas=betas, eps=eps,
            weight_decay=weight_decay, optim_bits=optim_bits, min_8bit_size=min_8bit_size,
            percentile_clipping=percentile_clipping, block_wise=block_wise, is_paged=is_paged,
            **{**fixed, **kw},
        )

    return ctor


adam = _family("adam")
adam8bit = _partial(adam, optim_bits=8)
adam32bit = _partial(adam, optim_bits=32)
paged_adam = _partial(adam, is_paged=True)
paged_adam8bit = _partial(adam, optim_bits=8, is_paged=True)
paged_adam32bit = _partial(adam, optim_bits=32, is_paged=True)


def adamw(params, learning_rate=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2, **kw):
    """Adam with decoupled weight decay, default 1e-2."""
    return adam(params, learning_rate, betas, eps, weight_decay=weight_decay, **kw)


adamw8bit = _partial(adamw, optim_bits=8)
adamw32bit = _partial(adamw, optim_bits=32)
paged_adamw = _partial(adamw, is_paged=True)
paged_adamw8bit = _partial(adamw, optim_bits=8, is_paged=True)
paged_adamw32bit = _partial(adamw, optim_bits=32, is_paged=True)


def sgd(params, learning_rate=1e-3, momentum=0.9, weight_decay=0.0, **kw):
    kw.setdefault("betas", (momentum, 0.0))
    return make_optimizer(params, "momentum", learning_rate=learning_rate,
                          weight_decay=weight_decay, **kw)


sgd8bit = _partial(sgd, optim_bits=8)
sgd32bit = _partial(sgd, optim_bits=32)
momentum = sgd


def lars(params, learning_rate=1e-3, momentum=0.9, weight_decay=0.0, max_unorm=0.02, **kw):
    """Momentum with per-layer trust-ratio clipping; momentum must be > 0."""
    if momentum == 0:
        raise ValueError("LARS without momentum is not supported")
    kw.setdefault("betas", (momentum, 0.0))
    return make_optimizer(params, "momentum", learning_rate=learning_rate,
                          weight_decay=weight_decay, max_unorm=max_unorm, **kw)


lars8bit = _partial(lars, optim_bits=8)
lars32bit = _partial(lars, optim_bits=32)


def lamb(params, learning_rate=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
         max_unorm=1.0, **kw):
    return make_optimizer(params, "lamb", learning_rate=learning_rate, betas=betas, eps=eps,
                          weight_decay=weight_decay, max_unorm=max_unorm, **kw)


lamb8bit = _partial(lamb, optim_bits=8)
lamb32bit = _partial(lamb, optim_bits=32)

lion = _family("lion", default_betas=(0.9, 0.99))
lion8bit = _partial(lion, optim_bits=8)
lion32bit = _partial(lion, optim_bits=32)
paged_lion = _partial(lion, is_paged=True)
paged_lion8bit = _partial(lion, optim_bits=8, is_paged=True)
paged_lion32bit = _partial(lion, optim_bits=32, is_paged=True)


def rmsprop(params, learning_rate=1e-2, alpha=0.99, eps=1e-8, weight_decay=0.0, **kw):
    kw.setdefault("betas", (alpha, 0.0))
    return make_optimizer(params, "rmsprop", learning_rate=learning_rate, eps=eps,
                          weight_decay=weight_decay, **kw)


rmsprop8bit = _partial(rmsprop, optim_bits=8)
rmsprop32bit = _partial(rmsprop, optim_bits=32)


def adagrad(params, learning_rate=1e-2, eps=1e-10, weight_decay=0.0, **kw):
    kw.setdefault("betas", (0.0, 0.0))
    return make_optimizer(params, "adagrad", learning_rate=learning_rate, eps=eps,
                          weight_decay=weight_decay, **kw)


adagrad8bit = _partial(adagrad, optim_bits=8)
adagrad32bit = _partial(adagrad, optim_bits=32)

Adam, Adam8bit, Adam32bit = adam, adam8bit, adam32bit
PagedAdam, PagedAdam8bit, PagedAdam32bit = paged_adam, paged_adam8bit, paged_adam32bit
AdamW, AdamW8bit, AdamW32bit = adamw, adamw8bit, adamw32bit
PagedAdamW, PagedAdamW8bit, PagedAdamW32bit = paged_adamw, paged_adamw8bit, paged_adamw32bit
SGD, SGD8bit, SGD32bit = sgd, sgd8bit, sgd32bit
LARS, LARS8bit, LARS32bit = lars, lars8bit, lars32bit
LAMB, LAMB8bit, LAMB32bit = lamb, lamb8bit, lamb32bit
Lion, Lion8bit, Lion32bit = lion, lion8bit, lion32bit
PagedLion, PagedLion8bit, PagedLion32bit = paged_lion, paged_lion8bit, paged_lion32bit
RMSprop, RMSprop8bit, RMSprop32bit = rmsprop, rmsprop8bit, rmsprop32bit
Adagrad, Adagrad8bit, Adagrad32bit = adagrad, adagrad8bit, adagrad32bit

__all__ = [
    "BnbOptimizer", "GlobalOptimManager", "make_optimizer",
    "AnalysisAdam", "AnalysisAdamState", "analysis_adam",
    "adam", "adam8bit", "adam32bit", "paged_adam", "paged_adam8bit", "paged_adam32bit",
    "adamw", "adamw8bit", "adamw32bit", "paged_adamw", "paged_adamw8bit", "paged_adamw32bit",
    "sgd", "sgd8bit", "sgd32bit", "momentum",
    "lars", "lars8bit", "lars32bit",
    "lamb", "lamb8bit", "lamb32bit",
    "lion", "lion8bit", "lion32bit", "paged_lion", "paged_lion8bit", "paged_lion32bit",
    "rmsprop", "rmsprop8bit", "rmsprop32bit",
    "adagrad", "adagrad8bit", "adagrad32bit",
]
