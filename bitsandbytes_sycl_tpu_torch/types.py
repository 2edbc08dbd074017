"""QuantState and QTensor: what it takes to undo a blockwise quantization,
holding torch tensors (the JAX package's ``types.py``).

A ``QuantState`` is a frozen dataclass: ``.to(device)`` returns a new one.
``dtype`` stays a string (``"bfloat16"``, ``"float32"``) so a state
interchanges with the JAX package's and with bnb checkpoints; ``torch_dtype``
gives the torch type.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["QuantState", "QTensor", "blocks_for", "FOUR_BIT_TYPES"]

FOUR_BIT_TYPES = ("nf4", "fp4", "int4", "af4")


def blocks_for(n: int, blocksize: int) -> int:
    return (n + blocksize - 1) // blocksize


@dataclasses.dataclass(frozen=True)
class QuantState:
    """Everything needed to undo a blockwise quantization.

    absmax:     (n_blocks,) float32, or uint8 codes when nested.
    code:       the codebook, (256,) or (16,) float32, in code order.
    shape:      the original tensor's shape.
    dtype:      the original dtype's name, e.g. "bfloat16".
    blocksize:  elements per quantization block.
    quant_type: "nf4" | "fp4" | "int4" | "af4" | "dynamic" |
                "dynamic_unsigned" | "linear" | "fp8" | "custom".
    offset:     nested only: the f32 mean of absmax removed before the
                absmax was requantized.
    state2:     nested only: the QuantState of the 8-bit requantized absmax.
    """

    absmax: torch.Tensor
    code: torch.Tensor
    shape: Tuple[int, ...]
    dtype: str
    blocksize: int
    quant_type: str
    offset: Optional[torch.Tensor] = None
    state2: Optional["QuantState"] = None

    @property
    def nested(self) -> bool:
        return self.state2 is not None

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def dequant_absmax(self) -> torch.Tensor:
        """The f32 per-block absmax, decoding the nested level if present:
        the dequantized absmax plus ``offset``, added in that order."""
        if not self.nested:
            return self.absmax
        from . import functional as F  # functional imports this module

        absmax = F.dequantize_blockwise(self.absmax, self.state2)
        return (absmax + self.offset).float()

    def to(self, device) -> "QuantState":
        mv = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, absmax=mv(self.absmax), code=mv(self.code), offset=mv(self.offset),
            state2=None if self.state2 is None else self.state2.to(device))


@dataclasses.dataclass(frozen=True)
class QTensor:
    """A quantized tensor: the packed payload and its QuantState.

    ``data``: 8-bit, uint8 codes in the original shape; 4-bit, flat uint8
    (ceil(n/2),), element 2i in the high nibble and 2i+1 in the low one.
    """

    data: torch.Tensor
    quant_state: QuantState

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.quant_state.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_state.torch_dtype

    def dequantize(self) -> torch.Tensor:
        from . import functional as F

        if self.quant_state.quant_type in FOUR_BIT_TYPES:
            return F.dequantize_4bit(self.data, self.quant_state)
        return F.dequantize_blockwise(self.data, self.quant_state)
