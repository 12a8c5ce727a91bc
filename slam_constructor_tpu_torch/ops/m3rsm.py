"""M3RSM: many-to-many multi-resolution scan matching (port of
``slam_constructor_tpu.ops.m3rsm``).

A max-pooled occupancy pyramid (level 0 ``where(known, occ, unknown)``,
each level above the 2 x 2 max of the one below) bounds the score of every
translation inside a rect from above, so a level-synchronous branch and
bound finds the best cell-resolution pose: all aligned rects of side
``2^levels`` (for every theta) are scored at the top level, the best
``beam_width`` are split into their four children one level down, and so
on to level 0; a hill climb then refines the winner below a cell.

On the card the pyramid is built and refreshed by ``kernels.m3rsm_pyramid``
and ``kernels.m3rsm_pyramid_update`` (K4a, ``csrc/m3rsm_pyramid.cu``: the
refresh one launch into new planes), and the whole match, every level of
the branch and bound with the frontier's selection (a stable sort: the
reference's ``top_k`` keeps equal scores in index order) and the hill
climb (with the config's reducer: ``M3RSMConfig()`` climbs on the obstacle
score), is one launch of ``kernels.m3rsm_search`` (K4b,
``csrc/m3rsm_match.cu``) for all requests at once. The scan's endpoints and
the beams' weights are PyTorch ops on the device before it; the kernel
places each window and computes the endpoint cells itself, with the f32
operations of ``kernels.m3rsm_window_cells``; nothing is read on the host.

``m3rsm_match`` takes one map and one request, one map shared by B requests
(``m3rsm_match_many``), or M maps with a request each (the loop closer's
submaps), with the same code.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..device import constant
from . import kernels
from . import matchers as matcherslib
from . import scan as scanlib
from . import scoring
from .matchers import MatchResult
from .scoring import MapView, ScoringConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class M3RSMConfig:
    """The reference's ``M3RSMConfig``, with the same names and defaults."""

    #: search window half-extents (metres / radians)
    half_x: float = 1.0
    half_y: float = 1.0
    half_theta: float = 0.3
    n_theta: int = 17
    #: rects kept per level (the bounded frontier's width)
    beam_width: int = 256
    #: number of pyramid levels above the finest (level 0)
    levels: int = 5
    #: hill-climbing rounds of the sub-cell refine of the discrete optimum
    #: (0: the cell-resolution result)
    refine_iterations: int = 8
    scoring: ScoringConfig = ScoringConfig()
    #: prior-centred search window, cells a side (0: the whole map); needs
    #: map sides divisible by 2^levels. Exact when it covers the scan's reach
    #: from anywhere in the search region.
    window: int = 0


def build_pyramid(view: MapView, levels: int, unknown_prob: float) -> tuple:
    """Max-occupancy pyramid over the scoring plane: ``levels + 1`` planes,
    of one map or (with a leading dimension on the view) of M maps in one
    launch."""
    return kernels.m3rsm_pyramid(view.occ, view.known, levels, unknown_prob)


def pyramid_refresh_size(touched_bbox: int, levels: int, dim_cap: int) -> int:
    """Smallest ``size`` for :func:`update_pyramid` that guarantees a
    ``touched_bbox``-cell edit around the centre is fully re-pooled despite
    the region's align-down shift (up to ``2**levels - 1`` cells), capped at
    the (``2**levels``-aligned) map extent."""
    step = 1 << levels
    size = ((touched_bbox + 2 * step + step - 1) // step) * step
    return min(size, (dim_cap // step) * step)


def update_pyramid(
    planes: tuple,
    view: MapView,
    unknown_prob: float,
    center_rc: Tensor,
    size: int,
    gate: Tensor | None = None,
) -> tuple:
    """Refresh a pyramid after a local map edit: the ``size x size`` region
    around ``center_rc`` i64[2] (row, col), its corner clipped into the map
    and aligned down to ``2^levels``, is re-pooled level by level. Equal to
    :func:`build_pyramid` of the edited map whenever every changed cell lies
    inside the region. ``gate`` f32[] (read on the device) skips the refresh
    unless it is above 0: the reference's ``lax.cond(q > 0, ...)``.

    Returns new planes (one launch on the card writes every level of them;
    ``planes`` stay as they were). Map sides and ``size`` must be multiples
    of ``2^levels``.
    """
    step = 1 << (len(planes) - 1)
    h0, w0 = planes[0].shape[-2:]
    if h0 % step or w0 % step or size % step:
        raise ValueError(
            f"update_pyramid needs dims and size divisible by 2^levels={step}"
            f" (got {h0}x{w0}, size={size}); use build_pyramid instead"
        )
    size = min(size, h0, w0)
    return kernels.m3rsm_pyramid_update(planes, view.occ, view.known, center_rc, size,
                                        unknown_prob, gate)


def thetas(half_theta: float, n_theta: int) -> tuple:
    """The search's headings as f32 values: ``jnp.linspace(-half_theta,
    half_theta, n_theta)`` as the reference's jitted step computes it (XLA
    turns ``i / (n - 1)`` into ``i * f32(1 / (n - 1))`` and ``stop * step``
    into ``i * (stop * r)``); ``torch.linspace`` rounds otherwise."""
    a, b = np.float32(-half_theta), np.float32(half_theta)
    if n_theta == 1:
        return (float(a),)
    r = np.float32(1) / np.float32(n_theta - 1)
    i = np.arange(n_theta - 1, dtype=np.float32)
    inner = a * (np.float32(1) - i * r) + i * (b * r)
    return tuple(float(x) for x in inner) + (float(b),)


def _frontier_size(cfg: M3RSMConfig, scale: float) -> tuple[int, int, int, int]:
    """(tx_half, ty_half, nx, ny): the search's half extents in cells and
    the top level's rects along x and y."""
    tx_half = int(math.ceil(cfg.half_x / scale))
    ty_half = int(math.ceil(cfg.half_y / scale))
    step = 1 << cfg.levels
    return (tx_half, ty_half, max(1, math.ceil(2 * tx_half / step)),
            max(1, math.ceil(2 * ty_half / step)))


@functools.lru_cache(maxsize=None)
def _top_rects(cfg: M3RSMConfig, scale: float) -> tuple:
    """The initial frontier (theta index, row offset, col offset) in the
    reference's order: every aligned rect of side 2^levels over the window,
    theta slowest, then y, then x."""
    tx_half, ty_half, nx, ny = _frontier_size(cfg, scale)
    step = 1 << cfg.levels
    return tuple((t, -ty_half + step * y, -tx_half + step * x)
                 for t in range(cfg.n_theta) for y in range(ny) for x in range(nx))


def search_constants(cfg: M3RSMConfig, scale: float, device) -> dict:
    """The search's constant tensors on ``device``: thetas f32[T] and the
    top level's rects i32[K0, 3]. Made once (see ``device.constant``); the
    engine asks for them before its first step, so no step copies from the
    host."""
    return {
        "thetas": constant(thetas(cfg.half_theta, cfg.n_theta), torch.float32, device),
        "top": constant(_top_rects(cfg, scale), torch.int32, device),
    }


def m3rsm_match(
    view: MapView,
    scan: scanlib.LaserScan,
    init_pose: Tensor,
    key: Tensor | None = None,
    cfg: M3RSMConfig = M3RSMConfig(),
    point_weights: Tensor | None = None,
    noise: Tensor | None = None,
    pyramid: tuple | None = None,
) -> MatchResult:
    """Global match over the (x, y, theta) window around ``init_pose``
    f32[3]; deterministic, so ``key`` and ``noise`` are ignored.

    ``pyramid``: live planes of the view's map (``build_pyramid`` once, then
    ``update_pyramid`` after every insert) instead of a build in this call.

    Requests: one map and one scan and prior (pose f32[3], prob f32[]); one
    map shared by B scans and priors (scan [B, R], ``init_pose`` f32[B, 3]:
    pose f32[B, 3], prob f32[B]); or M maps (a view of M maps, scan [M, R],
    ``init_pose`` f32[M, 3]), each matched on its own map. All requests run
    together, in one call of ``kernels.m3rsm_search``.
    """
    del key, noise
    ucfg = cfg.scoring
    occ = view.occ
    n_maps = occ.shape[0] if occ.dim() == 3 else 1
    single = init_pose.dim() == 1
    poses = init_pose.reshape(-1, 3)
    n_b = poses.shape[0]
    if occ.dim() == 3 and n_b != n_maps:
        raise ValueError(f"{n_maps} maps need {n_maps} requests, got {n_b}")
    if pyramid is None:
        pyramid = build_pyramid(view, cfg.levels, ucfg.unknown_prob)
    elif len(pyramid) != cfg.levels + 1:
        raise ValueError(f"pyramid has {len(pyramid) - 1} levels, config wants {cfg.levels}")
    elif pyramid[0].shape != occ.shape:
        raise ValueError(f"pyramid level 0 shape {tuple(pyramid[0].shape)} != map "
                         f"{tuple(occ.shape)}")
    dev = poses.device
    consts = search_constants(cfg, view.scale, dev)
    h0, w0 = occ.shape[-2:]
    step_top = 1 << cfg.levels
    if cfg.window > 0 and (h0 % step_top or w0 % step_top):
        raise ValueError(
            f"M3RSMConfig.window={cfg.window} needs map dims divisible by "
            f"2^levels={step_top}, got {h0}x{w0}; pad the map or set "
            "window=0 to (knowingly) score full planes"
        )
    # the prior-centred window of every level (0: the whole map), aligned
    # to 2^levels; the kernel places it and reads every level on it
    window = (min(cfg.window, h0, w0) // step_top) * step_top if cfg.window > 0 else 0
    scans = scan if not single else scanlib.LaserScan(
        scan.ranges[None], scan.bearings[None], scan.valid[None])
    mask = scanlib.subsample_mask(scans, ucfg.stride).to(torch.float32)
    if point_weights is not None:
        mask = mask * point_weights.reshape(n_b, -1)
    step_theta = 0.0
    if cfg.refine_iterations > 0:
        theta_step = (
            2 * cfg.half_theta / max(cfg.n_theta - 1, 1) if cfg.n_theta > 1 else 0.02
        )
        step_theta = max(theta_step / 2, 1e-3)
    pose, prob, trace = kernels.m3rsm_search(kernels.M3RSMSearch(
        planes=pyramid, occ=occ, known=view.known,
        origin=view.origin.expand(n_b, 2).contiguous(), window=window,
        pts=scanlib.scan_points(scans).contiguous(), mask=mask.contiguous(),
        stride=max(ucfg.stride, 1), prior=poses.contiguous(), top=consts["top"],
        thetas=consts["thetas"], scale=view.scale, beam_width=cfg.beam_width,
        unknown=ucfg.unknown_prob, step_xy=view.scale, step_theta=step_theta,
        iterations=cfg.refine_iterations,
        reducer=scoring.reducer_of(ucfg) if cfg.refine_iterations > 0 else kernels.BILINEAR))
    if cfg.refine_iterations == 0:
        trace = trace.reshape(0)
    if single:
        pose, prob = pose[0], prob[0]
        if cfg.refine_iterations > 0:
            trace = trace[0]
    return MatchResult(pose=pose, prob=prob, trace=trace)


def m3rsm_match_many(
    view: MapView,
    scans: scanlib.LaserScan,
    init_poses: Tensor,
    cfg: M3RSMConfig = M3RSMConfig(),
    point_weights: Tensor | None = None,
) -> MatchResult:
    """B requests (scans [B, R], ``init_poses`` f32[B, 3], ``point_weights``
    f32[B, R] or None) against one map, together: the pyramid built once,
    one launch of the match for all B."""
    return m3rsm_match(view, scans, init_poses, None, cfg, point_weights)


# register with the matcher registry (config-selectable like the others)
matcherslib.MATCHERS["m3rsm"] = (M3RSMConfig, m3rsm_match)
