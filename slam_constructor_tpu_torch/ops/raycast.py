"""Scan insertion and synthetic ray casting (port of
``slam_constructor_tpu.ops.raycast``).

Insertion is the DDA free-space trace (fixed-step samples with consecutive
duplicate cells masked), const endpoint evidence and the symmetric
wall-blur tail, scatter-added into per-cell observation planes on flat
indices: the free trace's counts with ``scatter_add_``, the occupied
evidence with ``index_put_(accumulate=True)``. Samples that fall off the
map are dropped. The polar fills, the area estimator and
``scan_sample_cells`` wait for later slices.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import grid as gridlib
from . import scan as scanlib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """Static knobs of the scan adder."""

    max_range: float = 15.0
    #: DDA step as a fraction of the cell size for the free-space trace
    step_fraction: float = 0.5
    #: 'const' (hit cell only); 'area' waits for the vinySLAM slice
    occupancy_estimator: str = "const"
    #: side of the endpoint square, in meters (tinySLAM "hole width"); also
    #: the blur length when ``wall_blur`` is on
    hole_width: float = 0.3
    #: distribute occupied evidence along the ray tail (tinySLAM trick)
    wall_blur: bool = False
    #: number of blur samples along the tail when wall_blur is set
    blur_samples: int = 4
    #: 'dda' only; the polar fills wait for the vinySLAM slice
    free_impl: str = "dda"

    def __post_init__(self):
        if self.free_impl != "dda":
            raise NotImplementedError(f"free_impl={self.free_impl!r}: only 'dda' is ported")
        if self.occupancy_estimator != "const":
            raise NotImplementedError(
                f"occupancy_estimator={self.occupancy_estimator!r}: only 'const' is ported"
            )

    def n_free_samples(self, scale: float) -> int:
        return int(math.ceil(self.max_range / (scale * self.step_fraction))) + 1


def _linspace(start: float, stop: float, n: int, device) -> Tensor:
    """f32 ``linspace`` rounded as the reference's: ``start * (1 - t) +
    stop * t`` with ``t = i / (n - 1)``, the last point exactly ``stop``
    (``torch.linspace`` rounds the inner points differently)."""
    if n == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    inner = start * (1.0 - t) + stop * t
    return torch.cat([inner, torch.full((1,), stop, dtype=torch.float32, device=device)])


def _flat_scatter_add(plane_shape, rows, cols, vals, valid) -> Tensor:
    """Scatter-add ``vals`` into an ``f32[H, W]`` plane; samples that are
    invalid or off the map are dropped (they add 0.0 to cell 0).

    ``index_put_(accumulate=True)`` sums the duplicates of an index in a
    fixed order on the card (a sorted segment sum), so fractional values
    (the blur ramp 2/3, its square 4/9) give the same bits on every run.
    The sort makes it slow for long duplicate runs: use it for the few
    thousand occupied-evidence samples, not the free trace."""
    h, w = plane_shape
    ok = valid & (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    lin = torch.where(ok, rows * w + cols, 0).reshape(-1)
    v = torch.where(ok, vals, 0.0).reshape(-1)
    flat = torch.zeros((h * w,), dtype=torch.float32, device=vals.device)
    flat.index_put_((lin,), v, accumulate=True)
    return flat.reshape(h, w)


def _flat_count(plane_shape, rows, cols, valid) -> Tensor:
    """Count the valid on-map samples of each cell into an ``f32[H, W]``
    plane (the DDA free trace: ~10^5 samples, most of them dropped).

    ``scatter_add_`` (atomics on the card): the sums are integers below
    2^24, exact in any order, so the plane is the same bits on every run.
    A dropped sample adds 0.0 to a cell spread by its position, so the
    dropped ones do not pile up on one address."""
    h, w = plane_shape
    ok = valid & (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    spread = torch.arange(ok.numel(), device=ok.device).reshape(ok.shape) % (h * w)
    lin = torch.where(ok, rows * w + cols, spread).reshape(-1)
    flat = torch.zeros((h * w,), dtype=torch.float32, device=ok.device)
    flat.scatter_add_(0, lin, ok.reshape(-1).to(torch.float32))
    return flat.reshape(h, w)


def scan_observation_planes(gm, pose, scan: scanlib.LaserScan, cfg: BeamConfig):
    """Rasterize one scan from ``pose`` into ``(w_obs, s_obs)``: per-cell
    observation weight and weighted occupancy sum, ready for
    :func:`grid.apply_observations`."""
    h, w = gm.height, gm.width
    scale = gm.scale
    dev = pose.device
    angles = pose[2] + scan.bearings  # [R]
    dirs = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)  # [R, 2]
    start = pose[:2]

    # --- free-space trace (DDA) ---------------------------------------------
    n_s = cfg.n_free_samples(scale)
    step = scale * cfg.step_fraction
    t = (torch.arange(n_s, dtype=torch.float32, device=dev) + 0.5) * step  # [S]
    pts = start + t[None, :, None] * dirs[:, None, :]  # [R, S, 2]
    idx = gridlib.world_to_cell(gm, pts)  # [R, S, 2]
    free_limit = scan.ranges - cfg.hole_width / 2.0
    valid = scan.valid[:, None] & (t[None, :] < free_limit[:, None])
    # consecutive-duplicate-cell mask: each crossed cell counted once per beam
    same = torch.all(idx[:, 1:] == idx[:, :-1], dim=-1)
    first = torch.ones((idx.shape[0], 1), dtype=torch.bool, device=dev)
    valid = valid & torch.cat([first, ~same], dim=1)
    w_free = _flat_count((h, w), idx[..., 0], idx[..., 1], valid)

    # --- occupied evidence: const endpoints + wall-blur tail ----------------
    # beams longer than max_range carry no endpoint evidence
    ep_valid = scan.valid & (scan.ranges <= cfg.max_range)
    endpoints = start + scan.ranges[:, None] * dirs  # [R, 2]
    eidx = gridlib.world_to_cell(gm, endpoints)
    ones = torch.ones(eidx.shape[:1], device=dev)
    occ_r, occ_c, occ_w, occ_s, occ_v = [eidx[..., 0]], [eidx[..., 1]], [ones], [ones], [ep_valid]
    if cfg.wall_blur:
        # triangular occupied evidence centred on the endpoint, hole_width/2
        # along the ray on both sides; weight and occupancy both taper
        bt = _linspace(-1.0, 1.0, cfg.blur_samples, dev)  # [B] in hole units
        tb = scan.ranges[:, None] + cfg.hole_width / 2.0 * bt[None, :]
        pb = start + tb[..., None] * dirs[:, None, :]  # [R, B, 2]
        ib = gridlib.world_to_cell(gm, pb)
        ramp = (1.0 - torch.abs(bt))[None, :].expand(tb.shape)
        vb = ep_valid[:, None] & (tb > 0)
        occ_r.append(ib[..., 0].reshape(-1))
        occ_c.append(ib[..., 1].reshape(-1))
        occ_w.append(ramp.reshape(-1))
        occ_s.append((ramp**2).reshape(-1))
        occ_v.append(vb.reshape(-1))
    rows_a, cols_a = torch.cat(occ_r), torch.cat(occ_c)
    v_a = torch.cat(occ_v)
    w_occ = _flat_scatter_add((h, w), rows_a, cols_a, torch.cat(occ_w), v_a)
    s_occ = _flat_scatter_add((h, w), rows_a, cols_a, torch.cat(occ_s), v_a)
    return w_free + w_occ, s_occ


def insert_scan(gm, model, pose, scan: scanlib.LaserScan, cfg: BeamConfig):
    """Full scan insertion: rasterize + cell-model fold (returns a new map)."""
    w_obs, s_obs = scan_observation_planes(gm, pose, scan, cfg)
    return gridlib.apply_observations(gm, model, w_obs, s_obs)


# --- synthetic scan generation (test/benchmark oracle) ----------------------


def cast_rays(
    occ_plane: Tensor,
    origin: Tensor,
    scale: float,
    pose: Tensor,
    bearings: Tensor,
    max_range: float = 15.0,
    threshold: float = 0.5,
    step_fraction: float = 0.25,
) -> scanlib.LaserScan:
    """Ray-march ``bearings`` from ``pose`` against a ground-truth occupancy
    plane; the first sample with occupancy >= threshold is the hit.
    Off-map samples read as free; beams that never hit are invalid."""
    h, w = occ_plane.shape
    dev = occ_plane.device
    step = scale * step_fraction
    n_s = int(math.ceil(max_range / step))
    t = (torch.arange(n_s, dtype=torch.float32, device=dev) + 1.0) * step  # [S]
    angles = pose[2] + bearings
    dirs = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)  # [R, 2]
    pts = pose[:2] + t[None, :, None] * dirs[:, None, :]  # [R, S, 2]
    rel = (pts - origin) / scale
    col = torch.floor(rel[..., 0]).to(torch.int64)
    row = torch.floor(rel[..., 1]).to(torch.int64)
    vals = gridlib.gather_plane(occ_plane, torch.stack([row, col], -1), 0.0, h, w)
    hit = vals >= threshold  # [R, S]
    any_hit = torch.any(hit, dim=1)
    first = torch.argmax(hit.to(torch.uint8), dim=1)  # first hit (ties -> first)
    ranges = torch.where(any_hit, t[first], max_range)
    return scanlib.LaserScan(
        ranges=ranges.to(torch.float32),
        bearings=bearings.to(torch.float32),
        valid=any_hit,
    )
