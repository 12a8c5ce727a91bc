"""Scan insertion and synthetic ray casting (port of
``slam_constructor_tpu.ops.raycast``).

Free space is either the DDA trace (``free_impl='dda'``: fixed-step
samples with consecutive duplicate cells masked) or the dense polar fill
(``free_impl='polar'``: one elementwise pass over the map through
``kernels.polar_free_plane``, the CUDA kernel on the card). Occupied
evidence is the const or the area endpoint estimator plus the symmetric
wall-blur tail. ``insert_scan`` (one map) and ``insert_scan_windows`` (the
RBPF's P maps, each on a window around its pose) rasterise and fold in one
call of ``kernels.scan_insert``: K3 (``csrc/scan_insert.cu``) on the card,
on the CPU its twin: ``scan_observation_planes`` (or its batched form),
which counts the free trace with ``scatter_add_`` and adds the occupied
evidence on flat indices with ``index_put_(accumulate=True)``, and
``grid.apply_observations``. Samples that fall off the map are dropped.
``scan_observation_planes_batched`` rasterises N scans at N poses in one
call of ``kernels.scan_planes`` (K3 without the fold on the card), into
one plane each or summed into shared planes: the loop closer's submaps,
joint refine and the regenerated map.
``scan_sample_cells`` gives one scan's samples as flat (row, col, weight,
occupancy) lists, for the tiled map's insert.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import grid as gridlib
from . import kernels, libm
from . import scan as scanlib
from .geometry import linspace

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """Static knobs of the scan adder."""

    max_range: float = 15.0
    #: DDA step as a fraction of the cell size for the free-space trace
    step_fraction: float = 0.5
    #: 'const' (hit cell only) or 'area' (endpoint square vs 3x3 cells)
    occupancy_estimator: str = "const"
    #: side of the endpoint square, in meters (tinySLAM "hole width"); also
    #: the blur length when ``wall_blur`` is on
    hole_width: float = 0.3
    #: distribute occupied evidence along the ray tail (tinySLAM trick)
    wall_blur: bool = False
    #: number of blur samples along the tail when wall_blur is set
    blur_samples: int = 4
    #: 'dda' (per-beam line samples) or 'polar' (dense per-cell polar fill:
    #: a cell is free iff it lies closer than the range of the beam covering
    #: its angle; assumes uniformly spaced bearings). A preset names its
    #: algorithm: the reference's 'auto' picks one by backend and is refused,
    #: and its 'polar_pallas' is 'polar' under another lowering.
    free_impl: str = "dda"

    def __post_init__(self):
        if self.free_impl not in ("dda", "polar"):
            raise NotImplementedError(
                f"free_impl={self.free_impl!r}: the port has 'dda' and 'polar'"
            )
        if self.occupancy_estimator not in ("const", "area"):
            raise ValueError(f"unknown occupancy_estimator {self.occupancy_estimator!r}")

    def n_free_samples(self, scale: float) -> int:
        return int(math.ceil(self.max_range / (scale * self.step_fraction))) + 1


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


def _endpoint_area_obs(origin, scale, endpoints, valid, hole_width):
    """Area occupancy estimator: overlap of the ``hole_width`` square centred
    on each endpoint with the 3x3 cell neighbourhood.

    ``endpoints`` f32[..., R, 2]; ``origin`` f32[2], or broadcastable
    against ``endpoints``. Returns (rows, cols, weights) each
    ``[..., R, 9]``; the weight is the overlap area as a fraction of the
    cell area, the occupancy observed is 1.0.
    """
    rel = gridlib.cell_coord(endpoints - origin, scale)
    idx = torch.stack(
        [torch.floor(rel[..., 1]).to(torch.int64), torch.floor(rel[..., 0]).to(torch.int64)], -1
    )  # [..., R, 2] (row, col)
    o = torch.arange(-1, 2, device=endpoints.device)
    offs = torch.stack(torch.meshgrid(o, o, indexing="ij"), dim=-1).reshape(9, 2)
    nbr = idx[..., None, :] + offs  # [..., R, 9, 2]
    cell_lo = nbr.to(torch.float32) * scale + origin[..., None, :].flip(-1)  # (y, x) corners
    cell_lo = cell_lo.flip(-1)  # -> (x, y)
    half = hole_width / 2.0
    e = endpoints[..., None, :]
    ov = torch.clamp(
        torch.minimum(cell_lo + scale, e + half) - torch.maximum(cell_lo, e - half), min=0.0
    )
    area = gridlib.cell_coord(ov[..., 0] * ov[..., 1], scale * scale)
    return nbr[..., 0], nbr[..., 1], torch.where(valid[..., None], area, 0.0)


def scan_observation_planes(gm, pose, scan: scanlib.LaserScan, cfg: BeamConfig):
    """Rasterize one scan from ``pose`` into ``(w_obs, s_obs)``: per-cell
    observation weight and weighted occupancy sum, ready for
    :func:`grid.apply_observations`."""
    h, w = gm.height, gm.width
    scale = gm.scale
    dev = pose.device
    angles = pose[2] + scan.bearings  # [R]
    sn, cs = libm.sincos(angles)
    dirs = torch.stack([cs, sn], dim=-1)  # [R, 2]
    start = pose[:2]

    # --- free-space trace ---------------------------------------------------
    if cfg.free_impl == "polar":
        w_free = kernels.polar_free_plane(
            scan.ranges.contiguous(), scan.valid.contiguous(), scan.bearings.contiguous(),
            pose.contiguous(), gm.origin.contiguous(), h, w, scale,
            cfg.hole_width / 2.0, cfg.max_range,
        )
    else:
        n_s = cfg.n_free_samples(scale)
        step = scale * cfg.step_fraction
        t = (torch.arange(n_s, dtype=torch.float32, device=dev) + 0.5) * step  # [S]
        pts = libm.fma32(t[None, :, None], dirs[:, None, :], start)  # [R, S, 2]
        idx = torch.stack(_cells_of(pts, gm.origin, scale), -1)  # [R, S, 2]
        free_limit = scan.ranges - cfg.hole_width / 2.0
        valid = scan.valid[:, None] & (t[None, :] < free_limit[:, None])
        # consecutive-duplicate-cell mask: each crossed cell counted once per beam
        same = torch.all(idx[:, 1:] == idx[:, :-1], dim=-1)
        first = torch.ones((idx.shape[0], 1), dtype=torch.bool, device=dev)
        valid = valid & torch.cat([first, ~same], dim=1)
        w_free = _flat_count((h, w), idx[..., 0], idx[..., 1], valid)

    # --- occupied evidence: endpoints (const or area) + wall-blur tail ------
    # beams longer than max_range carry no endpoint evidence
    ep_valid = scan.valid & (scan.ranges <= cfg.max_range)
    endpoints = libm.fma32(scan.ranges[:, None], dirs, start)  # [R, 2]
    if cfg.occupancy_estimator == "area":
        r9, c9, wgt = _endpoint_area_obs(gm.origin, scale, endpoints, ep_valid, cfg.hole_width)
        wgt = wgt.reshape(-1)
        # observed occupancy 1.0: the occupancy sum equals the weight
        occ_r, occ_c, occ_w, occ_s, occ_v = (
            [r9.reshape(-1)], [c9.reshape(-1)], [wgt], [wgt], [wgt > 0]
        )
    else:
        eidx = torch.stack(_cells_of(endpoints, gm.origin, scale), -1)
        ones = torch.ones(eidx.shape[:1], device=dev)
        occ_r, occ_c, occ_w, occ_s, occ_v = (
            [eidx[..., 0]], [eidx[..., 1]], [ones], [ones], [ep_valid]
        )
    if cfg.wall_blur:
        # triangular occupied evidence centred on the endpoint, hole_width/2
        # along the ray on both sides; weight and occupancy both taper
        bt = linspace(-1.0, 1.0, cfg.blur_samples, dev)  # [B] in hole units
        tb = scan.ranges[:, None] + cfg.hole_width / 2.0 * bt[None, :]
        pb = libm.fma32(tb[..., None], dirs[:, None, :], start)  # [R, B, 2]
        ib = torch.stack(_cells_of(pb, gm.origin, scale), -1)
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


def scan_sample_cells(origin: Tensor, scale: float, pose: Tensor, scan: scanlib.LaserScan,
                      cfg: BeamConfig):
    """One scan from ``pose`` as flat observation samples, whatever the map
    stores: (rows, cols) i64, (w, s) f32, 1-D. The DDA free trace (``w`` 1
    where a beam enters a cell, 0 for a masked sample, ``s`` 0), then the
    occupied evidence (the const or area endpoint estimator), then the wall
    blur, in the reference's order (``raycast.scan_sample_cells``). A
    sample may lie off any map; the caller drops it. The cells are those
    :func:`scan_observation_planes` counts with ``free_impl='dda'``."""
    dev = pose.device
    angles = pose[2] + scan.bearings
    sn, cs = libm.sincos(angles)
    dirs = torch.stack([cs, sn], dim=-1)  # [R, 2]
    start = pose[:2]
    n_s = cfg.n_free_samples(scale)
    step = scale * cfg.step_fraction
    t = (torch.arange(n_s, dtype=torch.float32, device=dev) + 0.5) * step  # [S]
    rows_f, cols_f = _cells_of(libm.fma32(t[None, :, None], dirs[:, None, :], start), origin,
                               scale)
    free_limit = scan.ranges - cfg.hole_width / 2.0
    valid = scan.valid[:, None] & (t[None, :] < free_limit[:, None])
    same = (rows_f[:, 1:] == rows_f[:, :-1]) & (cols_f[:, 1:] == cols_f[:, :-1])
    first = torch.ones((rows_f.shape[0], 1), dtype=torch.bool, device=dev)
    valid = valid & torch.cat([first, ~same], dim=1)
    w_free = valid.to(torch.float32).reshape(-1)
    rows, cols = [rows_f.reshape(-1)], [cols_f.reshape(-1)]
    w, s = [w_free], [torch.zeros_like(w_free)]

    endpoints = libm.fma32(scan.ranges[:, None], dirs, start)
    # usable-range cap on endpoint evidence, as the dense insert does
    ep_valid = scan.valid & (scan.ranges <= cfg.max_range)
    if cfg.occupancy_estimator == "area":
        r9, c9, wgt = _endpoint_area_obs(origin, scale, endpoints, ep_valid, cfg.hole_width)
        rows.append(r9.reshape(-1))
        cols.append(c9.reshape(-1))
        w.append(wgt.reshape(-1))
        s.append(wgt.reshape(-1))  # observed occupancy 1.0
    else:
        er, ec = _cells_of(endpoints, origin, scale)
        rows.append(er)
        cols.append(ec)
        w.append(ep_valid.to(torch.float32))
        s.append(ep_valid.to(torch.float32))
    if cfg.wall_blur:
        bt = linspace(-1.0, 1.0, cfg.blur_samples, dev)
        tb = scan.ranges[:, None] + cfg.hole_width / 2.0 * bt[None, :]
        br, bc = _cells_of(libm.fma32(tb[..., None], dirs[:, None, :], start), origin, scale)
        ramp = (1.0 - torch.abs(bt))[None, :].expand(tb.shape)
        vb = (ep_valid[:, None] & (tb > 0)).to(torch.float32)
        rows.append(br.reshape(-1))
        cols.append(bc.reshape(-1))
        w.append((ramp * vb).reshape(-1))
        s.append((ramp**2 * vb).reshape(-1))
    return torch.cat(rows), torch.cat(cols), torch.cat(w), torch.cat(s)


def _cells_of(pts: Tensor, origin: Tensor, scale: float):
    """(row, col) int64 of world points; ``origin`` broadcasts against
    ``pts``: the reference's jitted arithmetic (:func:`grid.cell_coord`)."""
    rel = gridlib.cell_coord(pts - origin, scale)
    return torch.floor(rel[..., 1]).to(torch.int64), torch.floor(rel[..., 0]).to(torch.int64)


def scan_observation_planes_batched(
    origins: Tensor,
    h: int,
    w: int,
    scale: float,
    poses: Tensor,
    scans: scanlib.LaserScan,
    cfg: BeamConfig,
    plane_of: Tensor | None = None,
    n_planes: int | None = None,
):
    """Rasterise N scans (``scans`` [N, R]) from ``poses`` f32[N, 3] into
    ``h x w`` planes at ``scale``: ``(w_obs, s_obs)`` f32[P, H, W] each.

    ``origins`` f32[N, 2] is the world corner of the map each scan goes
    into (f32[2]: one for all). ``plane_of`` i64[N] names the plane, of
    ``n_planes``, that a scan's evidence is added to; by default every scan
    has its own (P = N). Scans that share a plane are summed in scan order:
    the free trace's counts are integers, exact in any order, and each
    cell's occupied evidence is summed in a fixed order, so the planes are
    the same bits on every run. A scan's cells are those
    :func:`scan_observation_planes` gives it. One call of
    ``kernels.scan_planes``: K3 without the fold on the card, its twin
    ``kernels.scan_planes_ref`` on the CPU.
    """
    return kernels.scan_planes(origins, h, w, scale, poses, scans, cfg, plane_of, n_planes)


def insert_scan(gm, model, pose, scan: scanlib.LaserScan, cfg: BeamConfig, q=None):
    """Full scan insertion: rasterize + cell-model fold (returns a new map).
    ``q`` f32[] scales the observation (the engine's gate times the scan's
    quality; None is 1). One call of :func:`kernels.scan_insert`: K3 on the
    card, :func:`scan_observation_planes` and ``grid.apply_observations``
    on the CPU."""
    return dataclasses.replace(gm, cells=kernels.scan_insert(gm, model, pose, scan, cfg, q))


def insert_scan_windows(gm, model, poses: Tensor, scans: scanlib.LaserScan, cfg: BeamConfig,
                        window: int = 0):
    """Insert scan p at ``poses[p]`` into map p of a stack of P maps
    (``gm.cells`` f32[P, H, W, C], ``gm.origin`` f32[P, 2]; ``scans`` [P,
    R]), each on a ``window x window`` cell window around its pose (clamped
    into the map; 0 = the whole map): the RBPF's windowed insert, one call
    of :func:`kernels.scan_insert`.

    The cell arithmetic is the reference's windowed one (the window's own
    origin ``origin + [col, row] * scale``, not the full plane's); the
    offsets stay on the device. On the card K3 reads and writes each window
    in place; the CPU twin cuts the P windows out in one gather, rasterises
    them in one call of ``kernels.scan_planes_ref``, folds and writes them
    back in one scatter. Evidence that falls off a window is
    dropped (the reference wraps it into the window's last cell, trap g).
    Exact when the window covers the scan's usable reach."""
    return dataclasses.replace(gm, cells=kernels.scan_insert(gm, model, poses, scans, cfg,
                                                             window=window))


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
    sn, cs = libm.sincos(angles)
    dirs = torch.stack([cs, sn], dim=-1)  # [R, 2]
    pts = pose[:2] + t[None, :, None] * dirs[:, None, :]  # [R, S, 2]
    # divided: the reference's synthetic data casts its rays eagerly
    rel = gridlib.div_scale(pts - origin, scale)
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
