"""Device meshes and the collectives of the multi-device layer (port of
``slam_constructor_tpu.parallel.mesh``).

The reference runs one process over a mesh of devices (``shard_map``);
the port runs one rank a device in a ``torch.distributed`` process group
and names the mesh's dimensions as the reference does, with
``torch.distributed.device_mesh``:

- ``"hosts"``: the axis that crosses hosts (keyframe ranges of the
  distributed BA). Its collectives run at loop-closure rate.
- ``"chips"``: the devices of a host (particles, candidate poses, map
  bands). Its collectives run every scan.
- a flat ``"particles"`` (or ``"chips"``) axis over every rank, and the
  ``("pgroups", "bands")`` mesh of ``parallel/ep2d.py``.

The backend is chosen here and nowhere else: NCCL for a group of CUDA
ranks, gloo for CPU ranks (:func:`backend_for`). Nothing falls back to the
other one, and no collective's error is caught. One H100 cannot host two
NCCL ranks (NCCL refuses a duplicate GPU), so on one card the group has a
world size of 1; the CPU tests run 2 and 4 gloo ranks.

The collectives (:func:`psum`, :func:`pmax`, :func:`all_gather`,
:func:`ppermute`) take a mesh and the name of one of its dimensions, as
``jax.lax``'s take an axis name; each returns a new tensor.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

Tensor = torch.Tensor


def backend_for(device) -> str:
    """The process group's backend for ranks on ``device``: ``nccl`` for
    the card, ``gloo`` for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (for a group on one machine)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(rank: int, world_size: int, device, address: str | None = None,
         timeout_s: float = 300.0) -> None:
    """Join the default process group as ``rank`` of ``world_size`` with
    the backend of ``device`` (:func:`backend_for`). ``address`` is the
    rendezvous, ``tcp://host:port``; without one the environment's
    (``MASTER_ADDR``/``MASTER_PORT``, as ``torchrun`` sets them)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend_for(device), init_method=address or "env://", world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the default process group (a no-op when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_hosts: int | None = None, n_chips: int | None = None) -> DeviceMesh:
    """A ``("hosts", "chips")`` mesh over the ranks of the default group.
    ``n_hosts`` defaults to the number of hosts, ``WORLD_SIZE /
    LOCAL_WORLD_SIZE`` (``torchrun`` sets both; 1 without them)."""
    n = dist.get_world_size()
    if n_hosts is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        n_hosts = n // local if local and n % local == 0 else 1
    if n_chips is None:
        n_chips = n // n_hosts
    return init_device_mesh(_device_type(), (n_hosts, n_chips), mesh_dim_names=("hosts", "chips"))


def flat_mesh(axis: str = "particles") -> DeviceMesh:
    """A one-dimensional mesh named ``axis`` over every rank."""
    return init_device_mesh(_device_type(), (dist.get_world_size(),), mesh_dim_names=(axis,))


def grid_mesh(shape: tuple, names: tuple) -> DeviceMesh:
    """A mesh of ``shape`` over the ranks of the default group, in rank
    order, its dimensions named ``names`` (``(2, 2), ("pgroups",
    "bands")``)."""
    return init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def shard_bounds(n: int, mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """[lo, hi): this rank's equal share of ``n`` items along ``axis``
    (``n`` must divide)."""
    d = axis_size(mesh, axis)
    if n % d:
        raise ValueError(f"{n} items do not divide over the {d} ranks of axis {axis!r}")
    i = axis_index(mesh, axis)
    return i * (n // d), (i + 1) * (n // d)


def shard(x: Tensor, mesh: DeviceMesh, axis: str) -> Tensor:
    """This rank's slice of the leading dimension of ``x`` (the reference's
    ``shard_leading`` sharding); a whole tensor is what the reference
    calls ``replicated``."""
    lo, hi = shard_bounds(x.shape[0], mesh, axis)
    return x[lo:hi]


def _group(x: Tensor, mesh: DeviceMesh, axis: str):
    if x.device.type != mesh.device_type:
        raise ValueError(f"a {x.device.type} tensor in a collective of a "
                         f"{mesh.device_type} mesh")
    return mesh.get_group(axis)


def psum(x: Tensor, mesh: DeviceMesh, axis: str) -> Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (an all-reduce; its
    association order is the backend's: :mod:`..utils.determinism` fixes
    it)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(x, mesh, axis))
    return out


def pmax(x: Tensor, mesh: DeviceMesh, axis: str) -> Tensor:
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group(x, mesh, axis))
    return out


def all_gather(x: Tensor, mesh: DeviceMesh, axis: str) -> Tensor:
    """f[n, *x.shape]: every rank's ``x`` along ``axis``, in rank order."""
    group = _group(x, mesh, axis)
    n = axis_size(mesh, axis)
    out = x.new_empty(n * x.numel())
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.reshape(n, *x.shape)


def ppermute(x: Tensor, mesh: DeviceMesh, axis: str, shift: int) -> Tensor:
    """The ring permutation of ``axis``: rank i sends ``x`` to rank
    ``(i + shift) % n`` and returns what rank ``(i - shift) % n`` sent.
    With one rank it is ``x`` itself (a copy)."""
    group = _group(x, mesh, axis)
    n = axis_size(mesh, axis)
    i = axis_index(mesh, axis)
    if n == 1 or shift % n == 0:
        return x.clone()
    ranks = dist.get_process_group_ranks(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out
