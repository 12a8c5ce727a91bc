"""The process group, liveness and recovery across hosts (port of
``slam_constructor_tpu.parallel.multihost``).

The reference joins a ``jax.distributed`` group; the port joins a
``torch.distributed`` one (``parallel.mesh.init``: NCCL on the card, gloo
on the CPU), from a coordinator address or the environment that
``torchrun`` sets. Liveness is checked by a one-element all-reduce whose
wait has a deadline (:func:`heartbeat`); recovery is a restart of the group
and a restore of the states from the last checkpoint (``RecoveryLoop``,
over ``utils.checkpoint``), so a resume continues bit for bit.
"""

from __future__ import annotations

import os
import threading

import torch
import torch.distributed as dist

from ..utils import checkpoint
from . import mesh as meshlib


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None) -> dict:
    """Join the process group. ``coordinator`` is ``host:port``; without
    arguments the environment's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` (``torchrun``'s). A single process with no
    coordinator joins nothing. ``device`` (the card by default) chooses the
    backend. Returns the group's shape."""
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if coordinator and not dist.is_initialized():
        meshlib.init(process_id, num_processes, device, f"tcp://{coordinator}")
    on = dist.is_initialized()
    return {
        "process_id": dist.get_rank() if on else 0,
        "num_processes": dist.get_world_size() if on else 1,
        "backend": dist.get_backend() if on else None,
        "local_devices": torch.cuda.device_count() if torch.device(device).type == "cuda" else 1,
    }


def heartbeat(mesh, axis: str = "hosts", timeout_s: float = 30.0) -> bool:
    """Liveness probe: a one-element sum over ``axis`` that must complete
    within ``timeout_s``. False means a peer is suspected dead: the group is
    then wedged, and the caller should checkpoint what it owns and exit so
    that the launcher restarts the group.

    The collective runs on a daemon thread: with a dead peer it never
    completes (or fails), and a thread that something joins would hang the
    surviving process when it must act."""
    n = meshlib.axis_size(mesh, axis)
    result: list = []
    one = torch.ones((), dtype=torch.float32, device=mesh.device_type)

    def probe():
        result.append(float(meshlib.psum(one, mesh, axis).item()))

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    return bool(result) and result[0] == float(n)


class RecoveryLoop:
    """Checkpoint-based recovery:

        loop = RecoveryLoop(path, save_every=100)
        state, resumed = loop.restore_or(template, init_fn)
        for scan in stream:
            state = step(state, scan)
            loop.tick(state)

    After a failure the launcher restarts the job, and ``restore_or``
    resumes from the last snapshot."""

    def __init__(self, path: str, save_every: int = 100):
        self.path = path
        self.save_every = save_every
        self._count = 0

    def restore_or(self, template, init_fn):
        """(the saved state in ``template``'s structure, True), or
        (``init_fn()``, False) when there is no snapshot."""
        for candidate in (self.path, self.path + ".npz"):
            if os.path.exists(candidate):
                return checkpoint.restore(candidate, template), True
        return init_fn(), False

    def tick(self, state) -> None:
        """Count a step; every ``save_every`` steps replace the snapshot
        atomically."""
        self._count += 1
        if self._count % self.save_every == 0:
            tmp = self.path + ".tmp"
            checkpoint.save(tmp, state)
            os.replace(tmp + ".npz", self.path + ".npz")
