"""Fused blockwise 8-bit optimizer step: kernel J (``optim8_2state``: adam,
lamb) and kernel K (``optim8_1state``: momentum, rmsprop, adagrad, lion),
the port of the JAX package's ``ops/optim8.py`` with the dynamic codec.

One pass per step over (nb, bs) rows of one quantization block each: read
g, p, the uint8 states and their per-block absmax, decode the states
(``dynamic8``), run the update, requantize each state with a fresh
per-block absmax, write p, the codes and the absmax. The step's eight f32
scalars (``functional._optim8_scalars``) come as a tensor:

- 2-state: b1, b2, eps * c2, step_size, decay, gnorm_scale, 0, 0 (the bias
  correction folded in, c1 = 1 - b1^step, c2 = sqrt(1 - b2^step),
  step_size = -lr * c2 / c1, decay = 1 - lr * weight_decay);
- 1-state: b1, b2, eps, lr, weight_decay, gnorm_scale, is_step1, 0.

Semantics of the JAX kernel: non-finite gradient entries keep p and the
old decoded states (which still enter the block's new absmax); the absmax
is the block's fresh max |state|, ``safe_inv(0) = 0``; state1's code gets
the sign fix unless rounding is stochastic; stochastic rounding takes the
uniforms ``u`` as an input, and state2 uses them after a golden-ratio
scramble.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import _build
from .common import check_cuda_tensors, safe_inv
from .dynamic8 import decode_table, dynamic_decode, dynamic_encode, encode_consts, stochastic_adjust

__all__ = ["optim8_blockwise_fused", "optim8_2state", "optim8_1state", "ONE_STATE", "TWO_STATE",
           "MAX_BLOCKSIZE"]

TWO_STATE = ("adam", "lamb")
ONE_STATE = ("momentum", "rmsprop", "adagrad", "lion")
MAX_BLOCKSIZE = 2048  # the kernels hold a block in the registers of 256 threads


def _apply_sign_fix(rank: torch.Tensor, normed: torch.Tensor, n_neg: int, top: int) -> torch.Tensor:
    """State1's sign preservation: where sign(table[code]) differs from the
    value's (signbit semantics: -0.0 counts as negative), bump the rank one
    step toward the value's sign, so a small nonzero momentum never
    requantizes to zero or the wrong sign."""
    r = rank.to(torch.int32)
    mism = (r < n_neg) != torch.signbit(normed)
    step = torch.where(normed > 0, 1, -1).to(torch.int32)
    return torch.where(mism, (r + step).clamp(0, top), r)


class _DynamicCodec:
    """The arithmetic dynamic-map codec; ``sign_fix`` for state1 only."""

    def __init__(self, signed: bool, sign_fix: bool = False):
        self.signed = signed
        self.sign_fix = sign_fix and signed

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return dynamic_decode(codes, signed=self.signed)

    def encode(self, normed: torch.Tensor, u: Optional[torch.Tensor] = None) -> torch.Tensor:
        codes = dynamic_encode(normed, signed=self.signed)
        if u is not None:
            return stochastic_adjust(codes, normed, u, signed=self.signed)
        if self.sign_fix:
            return _apply_sign_fix(codes, normed, n_neg=127, top=255).to(torch.uint8)
        return codes


def _requant_rows(s: torch.Tensor, codec: _DynamicCodec, u=None):
    amax = s.abs().amax(dim=1, keepdim=True)
    return codec.encode(s * safe_inv(amax), u=u), amax


def _scalars(sc: torch.Tensor) -> list:
    return [float(v) for v in sc.float().cpu().reshape(-1)[:8]]


def _one_minus(b: float) -> float:
    return float(np.float32(1.0) - np.float32(b))


def _kernel2_plain(name, sc, g, p, s1, am1, s2, am2, u=None):
    """Plain PyTorch version of kernel J: (p, state1, absmax1, state2, absmax2)."""
    b1, b2, eps_c2, step_size, decay, gnorm_scale = _scalars(sc)[:6]
    codec1, codec2 = _DynamicCodec(True, sign_fix=True), _DynamicCodec(False)
    g = g.float() * gnorm_scale
    finite = torch.isfinite(g)
    g = torch.where(finite, g, torch.zeros_like(g))
    p = p.float()
    s1 = codec1.decode(s1) * am1.float()[:, None]
    s2 = codec2.decode(s2) * am2.float()[:, None]
    n1 = s1 * b1 + _one_minus(b1) * g
    n2 = s2 * b2 + _one_minus(b2) * g * g
    np_ = p + step_size * (n1 / (torch.sqrt(n2) + eps_c2))
    np_ = np_ * decay
    np_ = torch.where(finite, np_, p)
    n1 = torch.where(finite, n1, s1)
    n2 = torch.where(finite, n2, s2)
    u2 = None if u is None else torch.remainder(u * 0.6180339887 + 0.3819660113, 1.0)
    c1, a1 = _requant_rows(n1, codec1, u)
    c2, a2 = _requant_rows(n2, codec2, u2)
    return np_, c1, a1.reshape(-1), c2, a2.reshape(-1)


def _kernel1_plain(name, sc, g, p, s1, am1, u=None):
    """Plain PyTorch version of kernel K: (p, state1, absmax1)."""
    b1, b2, eps, lr, wd, gnorm_scale, is_step1 = _scalars(sc)[:7]
    codec1 = _DynamicCodec(True, sign_fix=True)
    g = g.float() * gnorm_scale
    finite = torch.isfinite(g)
    g = torch.where(finite, g, torch.zeros_like(g))
    p = p.float()
    s1 = codec1.decode(s1) * am1.float()[:, None]
    g = g + p * wd  # coupled weight decay
    if name == "momentum":
        n1 = g if is_step1 > 0 else s1 * b1 + g
        np_ = p - lr * n1
    elif name == "rmsprop":
        n1 = s1 * b1 + _one_minus(b1) * g * g
        np_ = p - lr * g / (torch.sqrt(n1) + eps)
    elif name == "adagrad":
        n1 = s1 + g * g
        np_ = p - lr * g / (torch.sqrt(n1) + eps)
    elif name == "lion":
        np_ = p - lr * torch.sign(s1 * b1 + _one_minus(b1) * g)
        n1 = s1 * b2 + _one_minus(b2) * g
    else:
        raise ValueError(name)
    np_ = torch.where(finite, np_, p)
    n1 = torch.where(finite, n1, s1)
    c1, a1 = _requant_rows(n1, codec1, u)
    return np_, c1, a1.reshape(-1)


def _check_rows(name, g, p, states, scalars, u):
    nb, bs = g.shape
    if bs > MAX_BLOCKSIZE or nb == 0:
        raise ValueError(f"{name}: blocksize {bs} (nb {nb}) outside 1..{MAX_BLOCKSIZE}")
    for t, dt in [(g, torch.float32), (p, torch.float32)] + [(s, torch.uint8) for s in states[0::2]]:
        if t.dtype != dt or tuple(t.shape) != (nb, bs) or not t.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous ({nb}, {bs}) {dt}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for a in states[1::2]:
        if a.dtype != torch.float32 or a.numel() != nb or not a.is_contiguous():
            raise ValueError(f"{name}: absmax must be contiguous ({nb},) f32")
    if scalars.dtype != torch.float32 or scalars.numel() < 8 or not scalars.is_contiguous():
        raise ValueError(f"{name}: scalars must be a contiguous (8,) f32 tensor")
    if u is not None and (u.dtype != torch.float32 or tuple(u.shape) != (nb, bs)
                          or not u.is_contiguous()):
        raise ValueError(f"{name}: u must be contiguous ({nb}, {bs}) f32")


@functools.lru_cache(maxsize=None)
def _consts_arg():
    """The encoder's constants as a host array the C entries copy."""
    return (ctypes.c_float * 23)(*encode_consts())


def optim8_2state(name, g, p, s1, am1, s2, am2, scalars, u=None):
    """Kernel J on CUDA tensors; the plain version on CPU tensors.
    Rows (nb, bs): g, p f32, s1, s2 uint8; am1, am2 (nb,) f32; scalars (8,)
    f32; u (nb, bs) f32 uniforms or None. Returns new (p, state1, absmax1,
    state2, absmax2)."""
    if name not in TWO_STATE:
        raise ValueError(f"optim8_2state: {name!r} is not a 2-state optimizer")
    if not check_cuda_tensors("optim8_2state", g, p, s1, am1, s2, am2, scalars, u):
        return _kernel2_plain(name, scalars, g, p, s1, am1, s2, am2, u)
    _check_rows("optim8_2state", g, p, (s1, am1, s2, am2), scalars, u)
    nb, bs = g.shape
    dev = g.device
    po, c1, c2 = torch.empty_like(p), torch.empty_like(s1), torch.empty_like(s2)
    a1 = torch.empty((nb,), dtype=torch.float32, device=dev)
    a2 = torch.empty((nb,), dtype=torch.float32, device=dev)
    fn = _build.kernel_fn("optim8_2state", "optim8_2state", 18, int_args=(15, 16))
    err = fn(
        scalars.data_ptr(), g.data_ptr(), p.data_ptr(), s1.data_ptr(), am1.data_ptr(),
        s2.data_ptr(), am2.data_ptr(), None if u is None else u.data_ptr(),
        po.data_ptr(), c1.data_ptr(), a1.data_ptr(), c2.data_ptr(), a2.data_ptr(),
        decode_table(dev).data_ptr(), ctypes.addressof(_consts_arg()), nb, bs,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("optim8_2state", err)
    optim8_2state.launches += 1
    return po, c1, a1, c2, a2


optim8_2state.launches = 0


def optim8_1state(name, g, p, s1, am1, scalars, u=None):
    """Kernel K on CUDA tensors; the plain version on CPU tensors. Rows as
    for optim8_2state; returns new (p, state1, absmax1)."""
    if name not in ONE_STATE:
        raise ValueError(f"optim8_1state: {name!r} is not a 1-state optimizer")
    if not check_cuda_tensors("optim8_1state", g, p, s1, am1, scalars, u):
        return _kernel1_plain(name, scalars, g, p, s1, am1, u)
    _check_rows("optim8_1state", g, p, (s1, am1), scalars, u)
    nb, bs = g.shape
    dev = g.device
    po, c1 = torch.empty_like(p), torch.empty_like(s1)
    a1 = torch.empty((nb,), dtype=torch.float32, device=dev)
    fn = _build.kernel_fn("optim8_1state", "optim8_1state", 15, int_args=(0, 12, 13))
    err = fn(
        ONE_STATE.index(name), scalars.data_ptr(), g.data_ptr(), p.data_ptr(), s1.data_ptr(),
        am1.data_ptr(), None if u is None else u.data_ptr(), po.data_ptr(), c1.data_ptr(),
        a1.data_ptr(), decode_table(dev).data_ptr(), ctypes.addressof(_consts_arg()), nb, bs,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("optim8_1state", err)
    optim8_1state.launches += 1
    return po, c1, a1


optim8_1state.launches = 0


def optim8_blockwise_fused(optimizer_name: str, g, p, state1, absmax1, state2, absmax2,
                           scalars, u=None, qmap1=None, qmap2=None):
    """The JAX package's entry: rows (nb, bs) in, (p, state1, absmax1[,
    state2, absmax2]) out, through kernel J (2-state) or K (1-state) on
    CUDA tensors. Only the dynamic maps are ported: a custom ``qmap``
    raises."""
    if qmap1 is not None or qmap2 is not None:
        raise NotImplementedError(
            "custom-qmap (LUT codec) optimizer states are not ported yet (ROADMAP Queue B #10)")
    if state2 is not None:
        return optim8_2state(optimizer_name, g, p, state1, absmax1, state2, absmax2, scalars, u)
    return optim8_1state(optimizer_name, g, p, state1, absmax1, scalars, u)
