"""Mesh primitives of the port's sharded execution, on `torch.distributed`.

The JAX package shards with `jax.shard_map` and GSPMD over a
`jax.sharding.Mesh`; PyTorch has neither, so every collective of the
sharded modules is written out here, one function for each JAX primitive
they call:

* the mesh is a `torch.distributed.device_mesh.DeviceMesh` with named
  dims (`make_mesh`), built over a process group the caller started
  (`torch.distributed.init_process_group` with its own store, rank and
  world size);
* `axis_size(mesh, axis)` is `jax.lax.psum(1, axis)`, `axis_index` is
  `jax.lax.axis_index`;
* `all_to_all_tiled` is `jax.lax.all_to_all(..., tiled=True)`,
  `all_gather` a tiled `jax.lax.all_gather`, `local_shard` the slice of
  a replicated array that a `NamedSharding` gives this rank.

Tensors are sharded in contiguous blocks in rank order along a mesh
axis, as a `PartitionSpec` shards them. Every collective adds the bytes
of the full (unsharded) array it assembles, and one call, to a counter of
its kind (`COUNTERS`, read by `ici_model.collective_stats`), also at
axis size 1, where the collective still runs (on NCCL, a copy).

NCCL takes the card's tensors as they are. Gloo runs on host memory:
under a gloo group the helpers copy a CUDA tensor to the host, run the
collective there and copy the result back (what gloo's own CUDA paths
do inside), chosen by the group's backend, so one code path serves both
backends and both devices.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sunscreen_tpu_torch import resolve_device

COUNTERS: dict[str, list[int]] = {}   # kind -> [bytes, count]


class IndivisibleAxis(ValueError):
    """A tensor dimension that the mesh axis sharding it does not divide
    (the JAX package's jit raises `ValueError` there too)."""


def make_mesh(shape, names, device_type: str | None = None):
    """A DeviceMesh of `shape` with dims `names` over the default process
    group; `device_type` None means CUDA (the port's default device)."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = resolve_device(None).type
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def _count(kind: str, nbytes: int) -> None:
    c = COUNTERS.setdefault(kind, [0, 0])
    c[0] += nbytes
    c[1] += 1


def _split(x, mesh, axis: str, dim: int) -> tuple[int, int]:
    """(axis size, block length) of `dim` of x sharded over `axis`."""
    d = axis_size(mesh, axis)
    if x.shape[dim] % d:
        raise IndivisibleAxis(
            f"dimension {dim} of size {x.shape[dim]} is not divisible by "
            f"mesh axis {axis!r} of size {d}")
    return d, x.shape[dim] // d


def local_shard(x, mesh, axis: str, dim: int):
    """This rank's block of `dim` of a replicated x sharded over `axis`
    (a view; no collective)."""
    _, size = _split(x, mesh, axis, dim)
    return x.narrow(dim, axis_index(mesh, axis) * size, size)


def _group(mesh, axis: str):
    group = mesh.get_group(axis)
    return group, dist.get_backend(group) == "gloo"


def all_to_all_tiled(x, mesh, axis: str, split_axis: int, concat_axis: int):
    """`jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)`:
    `split_axis` is cut into D blocks in rank order, block j goes to rank
    j, and the D blocks that arrive are concatenated along `concat_axis`,
    again in rank order. `all_to_all_single` exchanges along dim 0 only,
    so the split axis moves to the front, is made contiguous as [D,
    S / D, ...], exchanged, and each received block moves back."""
    split_axis %= x.ndim
    concat_axis %= x.ndim
    d, _ = _split(x, mesh, axis, split_axis)
    group, host = _group(mesh, axis)
    src = x.cpu() if host else x
    front = src.movedim(split_axis, 0)
    send = front.reshape(d, front.shape[0] // d,
                         *front.shape[1:]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if host:
        recv = recv.to(x.device)
    _count("all-to-all", x.numel() * x.element_size() * d)
    return torch.cat([recv[j].movedim(0, split_axis) for j in range(d)],
                     dim=concat_axis)


def all_gather(x, mesh, axis: str, dim: int):
    """The blocks of all ranks along `axis`, concatenated along `dim` in
    rank order (a tiled `jax.lax.all_gather`)."""
    d = axis_size(mesh, axis)
    group, host = _group(mesh, axis)
    src = (x.cpu() if host else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(d)]
    dist.all_gather(parts, src, group=group)
    _count("all-gather", x.numel() * x.element_size() * d)
    return torch.cat(parts, dim=dim).to(x.device)
