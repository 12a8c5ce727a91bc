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
and ``kernels.m3rsm_pyramid_update`` (K4a, ``csrc/m3rsm_pyramid.cu``) and
every level is scored by one launch of ``kernels.m3rsm_score_level`` (K4b,
``csrc/m3rsm_level.cu``) for all requests at once. The frontier's
selection (a stable sort: the reference's ``top_k`` keeps equal scores in
index order), the children, the endpoint cells and the window's corner stay
PyTorch ops on the device; nothing is read on the host.

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
from . import grid as gridlib
from . import kernels
from . import matchers as matcherslib
from . import scan as scanlib
from .geometry import wrap_angle
from .matchers import HillClimbingConfig, MatchResult, hill_climbing_match
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

    Returns new planes (the refresh writes into copies; ``planes`` stay as
    they were). Map sides and ``size`` must be multiples of ``2^levels``.
    """
    step = 1 << (len(planes) - 1)
    h0, w0 = planes[0].shape[-2:]
    if h0 % step or w0 % step or size % step:
        raise ValueError(
            f"update_pyramid needs dims and size divisible by 2^levels={step}"
            f" (got {h0}x{w0}, size={size}); use build_pyramid instead"
        )
    size = min(size, h0, w0)
    fresh = tuple(p.clone() for p in planes)
    return kernels.m3rsm_pyramid_update(fresh, view.occ, view.known, center_rc, size,
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
    """The search's constant tensors on ``device``: thetas f32[T], the top
    level's rects i32[K0, 3] and the four children's offsets of a rect at
    each level, i32[4, 3]. Made once (see ``device.constant``); the engine
    asks for them before its first step, so no step copies from the host."""
    child = {lvl: constant(((0, 0, 0), (0, 1 << lvl, 0), (0, 0, 1 << lvl),
                            (0, 1 << lvl, 1 << lvl)), torch.int32, device)
             for lvl in range(cfg.levels)}
    return {
        "thetas": constant(thetas(cfg.half_theta, cfg.n_theta), torch.float32, device),
        "top": constant(_top_rects(cfg, scale), torch.int32, device),
        "child": child,
    }


def _tiebreak(cands: Tensor, n_theta: int) -> Tensor:
    """-1e-6 x (|ty| + |tx| + |t - n_theta // 2|): between equal scores the
    rect nearest the prior wins (a flat, unmapped region must not pull the
    pose to the window's corner)."""
    d = (cands[..., 1].abs() + cands[..., 2].abs() + (cands[..., 0] - n_theta // 2).abs())
    return d.to(torch.float32) * -1e-6


def m3rsm_match(
    view: MapView,
    scan: scanlib.LaserScan,
    init_pose: Tensor,
    generator: torch.Generator | None = None,
    cfg: M3RSMConfig = M3RSMConfig(),
    point_weights: Tensor | None = None,
    noise: Tensor | None = None,
    pyramid: tuple | None = None,
) -> MatchResult:
    """Global match over the (x, y, theta) window around ``init_pose``
    f32[3]; deterministic, so ``generator`` and ``noise`` are ignored.

    ``pyramid``: live planes of the view's map (``build_pyramid`` once, then
    ``update_pyramid`` after every insert) instead of a build in this call.

    Requests: one map and one scan and prior (pose f32[3], prob f32[]); one
    map shared by B scans and priors (scan [B, R], ``init_pose`` f32[B, 3]:
    pose f32[B, 3], prob f32[B]); or M maps (a view of M maps, scan [M, R],
    ``init_pose`` f32[M, 3]), each matched on its own map. All requests run
    together: one launch a level, the refine's score calls one launch each.
    """
    del generator, noise
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
    origin = view.origin.expand(n_b, 2)
    if cfg.window > 0:
        # the prior-centred window of every level, aligned to 2^levels; the
        # levels are read in place, the refine's view is cut out
        s = (min(cfg.window, h0, w0) // step_top) * step_top
        rel = (poses[:, :2] - origin) / torch.full_like(origin, view.scale)
        cell = torch.floor(rel).to(torch.int32)
        c0w = torch.clamp(cell[:, 0] - s // 2, 0, w0 - s) // step_top * step_top
        r0w = torch.clamp(cell[:, 1] - s // 2, 0, h0 - s) // step_top * step_top
        corner = torch.stack([r0w, c0w], dim=-1)
        origin = origin + torch.stack([c0w, r0w], dim=-1).to(torch.float32) * view.scale
        maps = view if occ.dim() == 3 else MapView(
            occ=occ.expand(n_b, h0, w0), known=view.known.expand(n_b, h0, w0),
            origin=origin, scale=view.scale)
        take = functools.partial(gridlib.take_window, row=r0w.long(), col=c0w.long(), sh=s, sw=s)
        refine_view = MapView(occ=take(maps.occ), known=take(maps.known), origin=origin,
                              scale=view.scale)
        sides = [(s >> lvl, s >> lvl) for lvl in range(cfg.levels + 1)]
    else:
        corner = torch.zeros((n_b, 2), dtype=torch.int32, device=dev)
        refine_view = view
        if occ.dim() == 2 and not single:  # B requests on one map: B copies to score
            refine_view = MapView(occ=occ.expand(n_b, h0, w0),
                                  known=view.known.expand(n_b, h0, w0),
                                  origin=origin, scale=view.scale)
        sides = [tuple(p.shape[-2:]) for p in pyramid]
    planes = [p if p.dim() == 3 else p[None] for p in pyramid]

    # every theta's endpoint cells at zero translation, relative to the window
    th = consts["thetas"]
    scans = scan if not single else scanlib.LaserScan(
        scan.ranges[None], scan.bearings[None], scan.valid[None])
    pts = scanlib.scan_points(scans)  # [B, R, 2]
    ang = poses[:, 2:3] + th  # [B, T]
    c, s_ = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    px, py = pts[:, None, :, 0], pts[:, None, :, 1]
    ex = (poses[:, 0, None, None] + c * px) - s_ * py  # [B, T, R]
    ey = (poses[:, 1, None, None] + s_ * px) + c * py
    scale_t = torch.full_like(ex, view.scale)
    rel_x = (ex - origin[:, 0, None, None]) / scale_t
    rel_y = (ey - origin[:, 1, None, None]) / scale_t
    c0 = torch.stack([torch.floor(rel_y).to(torch.int32), torch.floor(rel_x).to(torch.int32)],
                     dim=-1).contiguous()  # [B, T, R, 2] (row, col)
    mask = scanlib.subsample_mask(scans, ucfg.stride).to(torch.float32)
    if point_weights is not None:
        mask = mask * point_weights.reshape(n_b, -1)
    mask = mask.contiguous()

    def score(level, cands):
        return kernels.m3rsm_score_level(
            planes[level], corner, level, *sides[level], c0, cands, mask, ucfg.unknown_prob,
        ) + _tiebreak(cands, cfg.n_theta)

    top = cfg.levels
    cands = consts["top"].expand(n_b, -1, 3).contiguous()
    scores = score(top, cands)
    for level in range(top - 1, -1, -1):
        # keep the best beam_width rects, split each into its 4 children
        take_n = min(cfg.beam_width, cands.shape[1])
        order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :take_n]
        parents = torch.gather(cands, 1, order[..., None].expand(-1, -1, 3))
        cands = (parents[:, :, None, :] + consts["child"][level]).reshape(n_b, -1, 3)
        scores = score(level, cands)

    best = torch.argmax(scores, dim=-1, keepdim=True)  # ties -> first index
    win = torch.gather(cands, 1, best[..., None].expand(-1, -1, 3))[:, 0]  # [B, 3]
    pose = torch.stack([
        poses[:, 0] + win[:, 2].to(torch.float32) * view.scale,
        poses[:, 1] + win[:, 1].to(torch.float32) * view.scale,
        wrap_angle(poses[:, 2] + th[win[:, 0].long()]),
    ], dim=-1)
    prob = torch.gather(scores, 1, best)[:, 0]
    if single:
        pose, prob = pose[0], prob[0]
    if cfg.refine_iterations > 0:
        theta_step = (
            2 * cfg.half_theta / max(cfg.n_theta - 1, 1) if cfg.n_theta > 1 else 0.02
        )
        hc = HillClimbingConfig(
            step_xy=view.scale,
            step_theta=max(theta_step / 2, 1e-3),
            iterations=cfg.refine_iterations,
            scoring=cfg.scoring,
        )
        if single and refine_view.occ.dim() == 3:
            refine_view = MapView(occ=refine_view.occ[0], known=refine_view.known[0],
                                  origin=refine_view.origin[0], scale=view.scale)
        return hill_climbing_match(refine_view, scan, pose, None, hc, point_weights)
    return MatchResult(pose=pose, prob=prob,
                       trace=torch.empty((0,), dtype=torch.float32, device=dev))


def m3rsm_match_many(
    view: MapView,
    scans: scanlib.LaserScan,
    init_poses: Tensor,
    cfg: M3RSMConfig = M3RSMConfig(),
    point_weights: Tensor | None = None,
) -> MatchResult:
    """B requests (scans [B, R], ``init_poses`` f32[B, 3], ``point_weights``
    f32[B, R] or None) against one map, together: the pyramid built once,
    one launch a level for all B."""
    return m3rsm_match(view, scans, init_poses, None, cfg, point_weights)


# register with the matcher registry (config-selectable like the others)
matcherslib.MATCHERS["m3rsm"] = (M3RSMConfig, m3rsm_match)
