"""Quantized layers as ``torch.nn.Module``s (the JAX package's ``nn``)."""

from .modules import (
    Embedding,
    Linear4bit,
    Linear8bitLt,
    LinearFP4,
    LinearNF4,
    OutlierAwareLinear,
    StableEmbedding,
    SwitchBackLinearBnb,
    quantize_linear_params,
)

__all__ = [
    "Linear4bit",
    "LinearNF4",
    "LinearFP4",
    "Linear8bitLt",
    "Embedding",
    "StableEmbedding",
    "OutlierAwareLinear",
    "SwitchBackLinearBnb",
    "quantize_linear_params",
]
