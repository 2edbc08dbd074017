"""Meshes, the sharding of quantized weights, and the collectives the
parallel paths use, on ``torch.distributed``.

The JAX package places global arrays on a ``jax.sharding.Mesh`` and lets
``shard_map`` hand each device its block. Here every rank holds plain local
tensors, its own shard of each sharded weight, cache and state, and moves
data with explicit collectives over the process group of a named mesh dim:

- ``jax.sharding.Mesh`` -> ``torch.distributed.device_mesh.DeviceMesh``
  (``make_mesh``); a mesh dim keeps the JAX axis name ("model", "data",
  "stage", "sp");
- ``psum(x, axis)`` -> ``psum(x, group)``, an ``all_reduce`` over
  ``mesh.get_group(axis)``;
- ``axis_index(axis)`` -> the rank within that group;
- ``ppermute`` -> ``ring_shift``, a point-to-point ring.

Blockwise-absmax sharding rule: scales shard congruently with their data
blocks. A ``QLinearWeight`` is packed (K//2, N) with absmax (2, K//(2bs),
N):

- "col" (output N): packed on dim 1, absmax on dim 2; every rank owns all
  K blocks of its N slice;
- "row" (input K): packed on dim 0 (byte rows), absmax on dim 1 (blocks of
  each plane); valid when the per-rank K is a multiple of 2 * blocksize.
  Compressed-statistics sidecars (2, 1, N) shard with N under "col" and
  are replicated under "row" (per-column reductions over all K blocks).

Under the gloo backend a CUDA tensor is staged through host memory for the
operations that gloo does not take on CUDA tensors (``_GLOO_HOST``: the
point-to-point transfers); under NCCL every tensor stays on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..ops.common import QLinearWeight

__all__ = [
    "retile_qweight_row_tp",
    "make_mesh",
    "initialize_distributed",
    "qweight_pspec",
    "qweight_sharding",
    "shard_qweight",
    "axis_group",
    "axis_size",
    "axis_rank",
    "psum",
    "all_gather",
    "broadcast",
    "ring_shift",
    "shard_tensor",
]


# ---------------------------------------------------------------- set-up


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: str = "nccl",
) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group``
    with torchrun's environment as the fallback (``WORLD_SIZE``, ``RANK``,
    and ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``). A no-op for
    one process and when a group is already up. NCCL by default, which
    needs a GPU; pass ``backend="gloo"`` to run on the CPU."""
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 or dist.is_initialized():
        return
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed: the NCCL backend needs a CUDA device; pass "
                           "backend='gloo' to run on the CPU")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend,
        init_method=init_method or "env://",
        world_size=world_size,
        rank=rank if rank is not None else int(os.environ.get("RANK", "0")),
    )


def make_mesh(shape: Dict[str, int], device_type: str = "cuda"):
    """A named mesh over the ranks of the default process group, e.g.
    ``make_mesh({"data": 2, "model": 4})`` (row-major: the last dim varies
    fastest). The sizes must multiply to the world size. CUDA by default;
    ``device_type="cpu"`` with a gloo group runs on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device_type='cpu' (with a gloo "
                           "process group) to run on the CPU")
    n = 1
    for s in shape.values():
        n *= int(s)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if n != have:
        raise ValueError(f"mesh {shape} needs {n} devices, have {have}")
    return init_device_mesh(device_type, tuple(int(s) for s in shape.values()),
                            mesh_dim_names=tuple(shape.keys()))


def _check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh (parallel.make_mesh), "
                        f"not {type(mesh).__name__}")


def axis_group(mesh, axis: str):
    """The process group of mesh dim ``axis``."""
    _check_mesh(mesh)
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    """The size of mesh dim ``axis`` (JAX ``mesh.shape[axis]``)."""
    _check_mesh(mesh)
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along mesh dim ``axis`` (JAX ``axis_index``)."""
    _check_mesh(mesh)
    return int(mesh.get_local_rank(axis))


# ---------------------------------------------------------- collectives

# whether an operation stages CUDA tensors through host memory under gloo:
# gloo's all_reduce, all_gather_into_tensor and broadcast take CUDA tensors
# (bf16 and f32), its send/recv do not (a send from device memory aborts
# the process; torch 2.11 + CUDA 12.8 on an H100). NCCL takes every one on
# the card.
_GLOO_HOST = {"all_reduce": False, "all_gather": False, "broadcast": False, "p2p": True}


def _staged(op: str, group, *tensors):
    """(host copies, True) when ``op`` must go through host memory: gloo,
    CUDA tensors, and an operation in ``_GLOO_HOST``; else (the tensors,
    False)."""
    if (tensors[0].is_cuda and _GLOO_HOST.get(op)
            and dist.get_backend(group) == dist.Backend.GLOO):
        return [t.cpu() for t in tensors], True
    return list(tensors), False


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (JAX ``psum``), in
    x's dtype: an in-place ``all_reduce`` of a contiguous x, which is
    returned. Every rank gets the same bits (the reduced result is
    distributed, not recomputed per rank). ``psum.calls`` counts the
    all-reduces."""
    psum.calls += 1
    if not x.is_contiguous():
        x = x.contiguous()
    (t,), staged = _staged("all_reduce", group, x)
    dist.all_reduce(t, group=group)
    if staged:
        x.copy_(t)
    return x


psum.calls = 0


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (JAX
    ``all_gather(..., tiled=True)``), contiguous."""
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]), dtype=x.dtype,
                      device=x.device)
    (o, m), staged = _staged("all_gather", group, out, moved)
    dist.all_gather_into_tensor(o, m, group=group)
    if staged:
        out.copy_(o)
    return out.movedim(0, dim).contiguous()


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``src`` (of ``group``)'s ``x`` on every rank of the group, in
    place; returned."""
    if not x.is_contiguous():
        x = x.contiguous()
    (t,), staged = _staged("broadcast", group, x)
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    if staged:
        x.copy_(t)
    return x


def _p2p(sends, recvs, group) -> None:
    """Matched point-to-point transfers: ``sends`` [(tensor, group rank)],
    ``recvs`` [(buffer, group rank)], all posted before any is waited on."""
    ops = [(dist.isend, t, r) for t, r in sends] + [(dist.irecv, t, r) for t, r in recvs]
    if not ops:
        return
    staged = _staged("p2p", group, ops[0][1])[1]
    host = [t.cpu() if staged else t for _, t, _ in ops]
    works = [fn(h, dist.get_global_rank(group, r), group=group)
             for (fn, _, r), h in zip(ops, host)]
    for w in works:
        w.wait()
    if staged:
        for (fn, t, _), h in zip(ops, host):
            if fn is dist.irecv:
                t.copy_(h)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """JAX ``ppermute`` over the ring i -> i + 1: sends x to the next rank
    of ``group`` and returns the previous rank's."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    out = torch.empty_like(x)
    _p2p([(x.contiguous(), (r + 1) % n)], [(out, (r - 1) % n)], group)
    return out


# ----------------------------------------------------- weight sharding


class LeafSharding(NamedTuple):
    """How one leaf splits over a mesh dim: along ``dim`` (None: every rank
    holds it whole) into ``parts`` pieces, of which a rank keeps the one at
    its coordinate."""

    dim: Optional[int]
    parts: int


def _dim_specs(dim: str, axis: str):
    # packed (K//2, N); absmax (2, K//(2*bs), N); compressed-stat sidecars
    # (2, 1, N): with N under "col", replicated under "row"
    if dim == "col":
        return (None, axis), (None, None, axis), (None, None, axis)
    if dim == "row":
        return (axis, None), (None, axis, None), ()
    if dim == "replicated":
        return (), (), ()
    raise ValueError(dim)


def qweight_pspec(qw: QLinearWeight, dim: str, axis: str = "model") -> QLinearWeight:
    """Partition specs shaped like ``qw``: each leaf replaced by a tuple of
    mesh-dim names (None: not split), the JAX ``PartitionSpec`` as plain
    data. dim "col" shards N, "row" shards K, "replicated" neither."""
    p_packed, p_absmax, p_side = _dim_specs(dim, axis)
    side = {}
    if qw.absmax_scale is not None:
        side = {"absmax_scale": p_side, "absmax_offset": p_side}
    return dataclasses.replace(qw, packed=p_packed, absmax=p_absmax, **side)


def _leaf_sharding(spec: tuple, parts: int, axis: str) -> LeafSharding:
    return LeafSharding(spec.index(axis) if axis in spec else None, parts)


def qweight_sharding(qw: QLinearWeight, mesh, dim: str, axis: str = "model") -> QLinearWeight:
    """``qweight_pspec`` resolved on ``mesh``: each leaf replaced by its
    ``LeafSharding`` (the split dim and the number of parts)."""
    n = axis_size(mesh, axis)
    spec = qweight_pspec(qw, dim, axis)
    side = {}
    if qw.absmax_scale is not None:
        side = {"absmax_scale": _leaf_sharding(spec.absmax_scale, n, axis),
                "absmax_offset": _leaf_sharding(spec.absmax_offset, n, axis)}
    return dataclasses.replace(qw, packed=_leaf_sharding(spec.packed, n, axis),
                               absmax=_leaf_sharding(spec.absmax, n, axis), **side)


def _take(t: torch.Tensor, dim: Optional[int], parts: int, index: int) -> torch.Tensor:
    """Piece ``index`` of ``parts`` of t along ``dim``, as a tensor of its
    own (a copy, so that the whole tensor can be freed)."""
    if dim is None or parts == 1:
        return t
    if t.shape[dim] % parts:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split into {parts}")
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n).clone(memory_format=torch.contiguous_format)


def shard_tensor(t: torch.Tensor, spec: tuple, mesh, axis: str) -> torch.Tensor:
    """This rank's block of ``t`` along mesh dim ``axis`` under the
    partition spec ``spec`` (a tuple of mesh-dim names or None, one per
    leading dim of t): the dim that spec names ``axis`` is split."""
    if axis not in spec:
        return t
    return _take(t, spec.index(axis), axis_size(mesh, axis), axis_rank(mesh, axis))


def _local_qw(qw: QLinearWeight, **leaves) -> QLinearWeight:
    """``qw`` with local leaves and its ``shape`` rebuilt from them (the op
    wrappers' tile predicates read N and K from it)."""
    out = dataclasses.replace(qw, **leaves)
    if out.packed.dim() == 2:  # stacked experts keep one expert's shape
        out = dataclasses.replace(out, shape=(out.packed.shape[1], 2 * out.packed.shape[0]))
    return out


def shard_qweight(qw: QLinearWeight, mesh, dim: str = "col", axis: str = "model"
                  ) -> QLinearWeight:
    """This rank's local ``QLinearWeight`` of a col- or row-sharded weight
    (data and scales congruent), its shape rebuilt from the local leaves.
    A row shard is the planar weight's byte rows as they stand (each rank
    holds two half-ranges of K: ``tp_matmul_4bit_row`` feeds it the
    matching activation halves); ``retile_qweight_row_tp`` first makes
    the ranges contiguous."""
    n_shards = axis_size(mesh, axis)
    N, K = qw.shape
    if dim == "col" and N % (128 * n_shards) != 0:
        raise ValueError(f"col-sharding needs N({N}) % 128*{n_shards} == 0")
    if dim == "row":
        per_dev_k = K // n_shards
        if per_dev_k % (2 * qw.blocksize) != 0:
            raise ValueError(
                f"row-sharding needs K/shard ({per_dev_k}) divisible by 2*blocksize "
                f"({2 * qw.blocksize}) so absmax blocks never cross shards"
            )
    how = qweight_sharding(qw, mesh, dim, axis)
    r = axis_rank(mesh, axis)
    leaves = {name: _take(getattr(qw, name), *getattr(how, name), r)
              for name in ("packed", "absmax", "absmax_scale", "absmax_offset")
              if getattr(qw, name) is not None}
    return _local_qw(qw, **leaves)


def retile_qweight_row_tp(qw: QLinearWeight, tp: int) -> QLinearWeight:
    """Lossless repack for row (input-K) tensor-parallel sharding of a
    planar-packed weight (the JAX package's, byte for byte).

    The planar layout stores element k in byte row k for k < K/2 (high
    nibble) and in byte row k - K/2 (low nibble) otherwise, so slicing
    byte rows [d*K/(2tp), (d+1)*K/(2tp)) hands rank d two disjoint
    half-ranges of K, not the contiguous [d*K/tp, (d+1)*K/tp) that a
    row-parallel matmul's local activations cover. This rebuilds packed
    and absmax so that each rank's slice is a self-consistent local planar
    pack of its contiguous K range. With compressed statistics the scales
    are decoded, regrouped and encoded anew (``compress_absmax``) over the
    global range, so the sidecars stay replicated across row shards."""
    N, K = qw.shape
    bs = qw.blocksize
    Kd = K // tp
    if Kd % (2 * bs) != 0:
        raise ValueError(f"K/tp ({Kd}) must be divisible by 2*blocksize ({2 * bs})")
    hi = qw.packed >> 4  # elements [0, K/2), (K/2, N)
    lo = qw.packed & 0xF  # elements [K/2, K)
    codes = torch.cat([hi, lo], dim=0)  # (K, N) element-ordered
    amax = qw.scales_f32().reshape(K // bs, N)  # block-ordered along K
    packs, amaxs = [], []
    for d in range(tp):
        cd = codes[d * Kd:(d + 1) * Kd]
        packs.append((cd[: Kd // 2] << 4) | cd[Kd // 2:])
        amaxs.append(amax[d * Kd // bs:(d + 1) * Kd // bs].reshape(2, Kd // (2 * bs), N))
    # bf16-stored scales round-trip exactly (scales_f32 is a widening cast)
    new_amax = torch.cat(amaxs, dim=1)
    new_amax = new_amax.float() if qw.compressed else new_amax.to(qw.absmax.dtype)
    am_scale = am_offset = None
    if qw.compressed:
        from ..ops.common import compress_absmax

        new_amax, am_scale, am_offset = compress_absmax(new_amax)
    return QLinearWeight(
        packed=torch.cat(packs, dim=0).to(torch.uint8),
        absmax=new_amax,
        shape=(N, K),
        blocksize=bs,
        quant_type=qw.quant_type,
        dtype=qw.dtype,
        absmax_scale=am_scale,
        absmax_offset=am_offset,
    )
