"""Sharding and collectives on ``torch.distributed``: tensor, expert,
pipeline and sequence parallelism over a ``DeviceMesh``, the JAX package's
``parallel/`` (there ``shard_map`` and XLA collectives over a
``jax.sharding.Mesh``). Every rank holds plain local tensors, its own
shard of each sharded weight, cache and state, and communicates with
explicit all-reduces, all-gathers and point-to-point transfers over the
process group of a named mesh dim (``mesh.py``); the hand-written kernels
run on the local shards.
"""

from .mesh import (
    initialize_distributed,
    make_mesh,
    qweight_pspec,
    qweight_sharding,
    shard_qweight,
)
from . import gptj_tp, llama_tp, opt_tp, pipeline, ring
from .gptj_tp import gptj_forward_tp, shard_gptj_params
from .opt_tp import opt_forward_tp, shard_opt_params
from .llama_tp import kv_cache_specs, llama_forward_tp, llama_param_specs, shard_llama_params
from .pipeline import (
    init_stage_kv_cache,
    llama_forward_pp,
    llama_forward_pp_decode,
    stack_stage_params,
)
from .ring import ring_attention
from .collectives import (
    tp_all_gather_matmul_4bit,
    tp_matmul_4bit_col,
    tp_matmul_4bit_row,
    tp_matmul_int8_col,
    tp_matmul_int8_row,
)

__all__ = [
    "gptj_tp", "llama_tp", "opt_tp", "pipeline", "ring",
    "gptj_forward_tp", "shard_gptj_params",
    "opt_forward_tp", "shard_opt_params",
    "kv_cache_specs", "llama_forward_tp", "llama_param_specs", "shard_llama_params",
    "llama_forward_pp", "llama_forward_pp_decode", "init_stage_kv_cache",
    "stack_stage_params", "ring_attention",
    "make_mesh",
    "initialize_distributed",
    "qweight_pspec",
    "qweight_sharding",
    "shard_qweight",
    "tp_matmul_4bit_col",
    "tp_matmul_4bit_row",
    "tp_all_gather_matmul_4bit",
    "tp_matmul_int8_col",
    "tp_matmul_int8_row",
]
