"""Carry engine state between the reference and the port.

A reference ``SlamState`` crosses as a dict of numpy arrays:
``cells`` f32[H, W, C] (C = the cell model's belief channels + 1: 2 for the
Bayes cells, 5 for the TBM cell), ``origin`` f32[2], ``scale`` float,
``pose`` f32[3], ``step`` int, ``last_prob`` float, and with the M3RSM
matcher ``pyramid``, the tuple of its f32 planes (absent or empty
otherwise). A state on the tiled map (``map_storage='tiled'``) crosses with
the block map's fields in place of ``cells``: ``pool`` f32[N, B, B, C],
``table`` i32[TH, TW], ``n_alloc`` int, ``origin``, ``scale`` and
``block``. The reference's PRNG key is not
carried over: its role moves to the ``Engine``'s ``torch.Generator``, or to
noise injected into ``slam_step``.

A reference ``PoseGraphState`` crosses the same way, with the reference's
field names and its fixed-capacity layout: ``kf_poses`` f32[K, 3],
``kf_ranges`` f32[K, R], ``kf_bearings`` f32[K, R], ``kf_valid`` bool[K, R]
(the stacked ``kf_scans``), ``n_kf`` int, ``edge_i`` / ``edge_j`` i32[E],
``edge_delta`` / ``edge_info`` f32[E, 3], ``edge_is_loop`` bool[E],
``n_edges`` int, ``last_kf`` int, ``kf_overflow`` / ``edge_overflow`` bool.

A reference ``GMappingState`` (dense storage) crosses as ``cells`` f32[P,
H, W, C], ``origin`` f32[P, 2], ``scale`` float, ``poses`` f32[P, 3],
``log_weights`` f32[P], ``step`` int; its key stays on the JAX side (the
port draws from the engine's generator, or takes injected draws). On the
copy-on-write storage the maps cross as the ``CowBlockMaps`` fields in
place of ``cells``: ``pool`` f32[N, B, B, C], ``tables`` i32[P, TH, TW],
``refcnt`` i32[N], ``origin`` f32[2], ``scale``, ``block`` and
``overflow`` bool (:func:`cow_from_numpy` / :func:`cow_to_numpy`; a tiled
``BlockMap`` alone: :func:`blockmap_from_numpy` / :func:`blockmap_to_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.engine import SlamState
from ..models.gmapping import GMappingState
from ..models.posegraph import PoseGraphState
from ..ops.blockmap import BlockMap
from ..ops.cow import CowBlockMaps
from ..ops.grid import GridMap
from ..ops.scan import LaserScan


def state_from_numpy(tree: dict, device=None) -> SlamState:
    """Build the port's state from a numpy dict (see module docstring) on
    ``device`` (the card when none is named)."""
    device = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    if "pool" in tree:
        gm = blockmap_from_numpy(tree, device)
    else:
        gm = GridMap(cells=f32(tree["cells"]), origin=f32(tree["origin"]),
                     scale=float(tree["scale"]))
    return SlamState(
        gm=gm,
        pose=f32(tree["pose"]),
        step=torch.tensor(np.asarray(tree["step"], np.int32), device=device),
        last_prob=f32(tree["last_prob"]),
        pyramid=tuple(f32(p) for p in tree.get("pyramid", ())),
    )


def state_to_numpy(state: SlamState) -> dict:
    """The port's state as a numpy dict (see module docstring)."""
    gm = state.gm
    if isinstance(gm, BlockMap):
        maps = blockmap_to_numpy(gm)
    else:
        maps = {"cells": gm.cells.cpu().numpy(), "origin": gm.origin.cpu().numpy(),
                "scale": float(gm.scale)}
    return {
        **maps,
        "pose": state.pose.cpu().numpy(),
        "step": int(state.step),
        "last_prob": float(state.last_prob),
        "pyramid": tuple(p.cpu().numpy() for p in state.pyramid),
    }


def blockmap_from_numpy(tree: dict, device=None) -> BlockMap:
    """A tiled map from ``pool``, ``table``, ``n_alloc``, ``origin``,
    ``scale`` and ``block`` (a reference ``BlockMap``'s fields)."""
    device = resolve_device(device)
    return BlockMap(
        pool=torch.tensor(np.asarray(tree["pool"], np.float32), device=device),
        table=torch.tensor(np.asarray(tree["table"], np.int32), device=device),
        n_alloc=torch.tensor(np.asarray(tree["n_alloc"], np.int32), device=device),
        origin=torch.tensor(np.asarray(tree["origin"], np.float32), device=device),
        scale=float(tree["scale"]), block=int(tree["block"]),
    )


def blockmap_to_numpy(bm: BlockMap) -> dict:
    return {"pool": bm.pool.cpu().numpy(), "table": bm.table.cpu().numpy(),
            "n_alloc": int(bm.n_alloc), "origin": bm.origin.cpu().numpy(),
            "scale": float(bm.scale), "block": bm.block}


def cow_from_numpy(tree: dict, device=None) -> CowBlockMaps:
    """Copy-on-write maps from ``pool``, ``tables``, ``refcnt``,
    ``origin``, ``scale``, ``block`` and ``overflow`` (a reference
    ``CowBlockMaps``' fields)."""
    device = resolve_device(device)
    return CowBlockMaps(
        pool=torch.tensor(np.asarray(tree["pool"], np.float32), device=device),
        tables=torch.tensor(np.asarray(tree["tables"], np.int32), device=device),
        refcnt=torch.tensor(np.asarray(tree["refcnt"], np.int32), device=device),
        origin=torch.tensor(np.asarray(tree["origin"], np.float32), device=device),
        scale=float(tree["scale"]), block=int(tree["block"]),
        overflow=torch.tensor(bool(tree["overflow"]), device=device),
    )


def cow_to_numpy(st: CowBlockMaps) -> dict:
    return {"pool": st.pool.cpu().numpy(), "tables": st.tables.cpu().numpy(),
            "refcnt": st.refcnt.cpu().numpy(), "origin": st.origin.cpu().numpy(),
            "scale": float(st.scale), "block": st.block, "overflow": bool(st.overflow)}


_GRAPH_FIELDS = {
    "kf_poses": np.float32, "n_kf": np.int32, "edge_i": np.int32, "edge_j": np.int32,
    "edge_delta": np.float32, "edge_info": np.float32, "edge_is_loop": np.bool_,
    "n_edges": np.int32, "last_kf": np.int32, "kf_overflow": np.bool_,
    "edge_overflow": np.bool_,
}
_SCAN_FIELDS = {"kf_ranges": np.float32, "kf_bearings": np.float32, "kf_valid": np.bool_}


def graph_from_numpy(tree: dict, device=None) -> PoseGraphState:
    """Build the port's pose graph from a numpy dict (see module docstring)
    on ``device`` (the card when none is named)."""
    device = resolve_device(device)

    def get(name, dtype):
        return torch.tensor(np.asarray(tree[name], dtype), device=device)

    scan = {k: get(k, t) for k, t in _SCAN_FIELDS.items()}
    return PoseGraphState(
        kf_scans=LaserScan(scan["kf_ranges"], scan["kf_bearings"], scan["kf_valid"]),
        **{k: get(k, t) for k, t in _GRAPH_FIELDS.items()},
    )


def graph_to_numpy(graph: PoseGraphState) -> dict:
    """The port's pose graph as a numpy dict (see module docstring)."""
    out = {k: getattr(graph, k).cpu().numpy() for k in _GRAPH_FIELDS}
    out.update(
        kf_ranges=graph.kf_scans.ranges.cpu().numpy(),
        kf_bearings=graph.kf_scans.bearings.cpu().numpy(),
        kf_valid=graph.kf_scans.valid.cpu().numpy(),
    )
    return out


def gmapping_state_from_numpy(tree: dict, device=None) -> GMappingState:
    """Build the port's RBPF state from a numpy dict (see module docstring)
    on ``device`` (the card when none is named)."""
    device = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    gm = (cow_from_numpy(tree, device) if "tables" in tree else
          GridMap(cells=f32(tree["cells"]), origin=f32(tree["origin"]), scale=float(tree["scale"])))
    return GMappingState(
        gm=gm,
        poses=f32(tree["poses"]),
        log_weights=f32(tree["log_weights"]),
        step=torch.tensor(np.asarray(tree["step"], np.int32), device=device),
    )


def gmapping_state_to_numpy(state: GMappingState) -> dict:
    """The port's RBPF state as a numpy dict (see module docstring)."""
    gm = state.gm
    maps = cow_to_numpy(gm) if isinstance(gm, CowBlockMaps) else {
        "cells": gm.cells.cpu().numpy(), "origin": gm.origin.cpu().numpy(),
        "scale": float(gm.scale)}
    return {
        **maps,
        "poses": state.poses.cpu().numpy(),
        "log_weights": state.log_weights.cpu().numpy(),
        "step": int(state.step),
    }
