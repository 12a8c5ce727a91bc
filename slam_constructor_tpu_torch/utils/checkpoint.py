"""Checkpoint and resume of engine states (port of
``slam_constructor_tpu.utils.checkpoint``).

A state is a tree of dataclasses, tuples, lists and dicts (``SlamState``
with its map and M3RSM pyramid, ``GMappingState`` with dense maps or the
copy-on-write pool, ``PoseGraphState``, or a dict of them) whose leaves are
tensors, ``torch.Generator``s, numpy arrays and plain values. :func:`save`
flattens it into one ``.npz``: every tensor as a numpy array of its dtype,
every generator's state as bytes (the reference keeps its PRNG key in the
state; the port's random numbers come from the engines' generators, so a
resume is bit for bit only with them), and the tree's structure as a
string: the classes, the field names, the plain values (a map's scale, a
pool's block side) and the tensors' dtypes, not their shapes (a grown map
or pool restores at its saved size). :func:`restore` checks that string
against the template's, as the reference checks its treedef, and rebuilds
the tree on the devices of the template's tensors and generators.

The reference's orbax variants (``save_orbax``, ``restore_orbax``: async,
multi-host) are not ported: the port has no multi-host runtime yet, and
orbax is not one of its dependencies.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

_STRUCTURE = "__structure__"


def _flatten(x, leaves: list | None) -> str:
    """Appends the leaves of ``x`` to ``leaves`` (unless it is None);
    returns its structure."""
    if isinstance(x, torch.Tensor):
        if leaves is not None:
            leaves.append(x.detach().cpu().numpy())
        return f"T[{x.dtype}]"
    if isinstance(x, torch.Generator):
        if leaves is not None:
            leaves.append(x.get_state().numpy())
        return "G"
    if isinstance(x, np.ndarray):
        if leaves is not None:
            leaves.append(x)
        return f"N[{x.dtype}]"
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        inner = ",".join(f"{f.name}={_flatten(getattr(x, f.name), leaves)}"
                         for f in dataclasses.fields(x))
        return f"{type(x).__module__}.{type(x).__qualname__}({inner})"
    if isinstance(x, (tuple, list)):
        inner = ",".join(_flatten(v, leaves) for v in x)
        return f"({inner})" if isinstance(x, tuple) else f"[{inner}]"
    if isinstance(x, dict):
        return "{" + ",".join(f"{k!r}:{_flatten(v, leaves)}" for k, v in x.items()) + "}"
    if x is None or isinstance(x, (bool, int, float, str)):
        return repr(x)
    raise TypeError(f"checkpoint: cannot save a {type(x).__name__}")


def _structure(state) -> str:
    """The structure string of ``state`` (what :func:`restore` compares)."""
    return _flatten(state, None)


def save(path: str, state) -> None:
    """Save the tree ``state`` to ``path`` (``.npz`` appended if missing).
    Reads every tensor back to the host."""
    leaves: list = []
    struct = _flatten(state, leaves)
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    arrays[_STRUCTURE] = np.frombuffer(struct.encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _rebuild(like, data, counter: list):
    def take():
        a = data[f"leaf_{counter[0]}"]
        counter[0] += 1
        return a

    if isinstance(like, torch.Tensor):
        # a copy: C-contiguous, and 0-d stays 0-d (np.ascontiguousarray does not)
        return torch.from_numpy(take().copy()).to(device=like.device, dtype=like.dtype)
    if isinstance(like, torch.Generator):
        g = torch.Generator(device=like.device)
        g.set_state(torch.from_numpy(take().copy()))
        return g
    if isinstance(like, np.ndarray):
        return take().astype(like.dtype)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), data, counter)
            for f in dataclasses.fields(like) if f.init})
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, data, counter) for v in like)
    if isinstance(like, dict):
        return {k: _rebuild(v, data, counter) for k, v in like.items()}
    return like


def restore(path: str, template):
    """Restore into the structure of ``template`` (the same engine config):
    the stored structure must equal the template's, else ``ValueError``.
    Tensors and generators land on the devices of the template's; a
    template's plain values are its own (they are part of the structure)."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        stored = bytes(data[_STRUCTURE]).decode()
        want = _structure(template)
        if stored != want:
            raise ValueError(
                f"checkpoint structure mismatch:\n saved: {stored}\n want:  {want}")
        return _rebuild(template, data, [0])
