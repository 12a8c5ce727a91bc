"""Scan-likelihood scoring (port of ``slam_constructor_tpu.ops.scoring``).

``score_poses(view, scan, poses[K]) -> probs[K]``: the mean per-beam
consistency probability of a scan placed at each candidate pose. Ported is
the overlap reducer at extent 1, the one tinySLAM, vinySLAM and the loop
closer run; every score goes through ``kernels.overlap_score`` (the CUDA
kernel on the card). A view, a scan and the poses may carry a leading map
dimension (``MapView.occ`` f32[M, H, W], scan [M, R], poses f32[M, K, 3]):
then map m scores its own scan at its own poses, all in one launch of
``kernels.overlap_score_batched``. The obstacle, mean and max reducers and
other extents wait for later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import grid as gridlib
from . import kernels
from . import scan as scanlib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ScoringConfig:
    #: 'obstacle' | 'max' | 'mean' | 'overlap' (only 'overlap' is ported)
    reducer: str = "obstacle"
    #: window radius in cells for the max/mean/overlap reducers (1 -> 3x3)
    window: int = 1
    #: probability contributed by unknown / out-of-map cells
    unknown_prob: float = 0.5
    #: use every stride-th beam
    stride: int = 1
    #: side of the endpoint square for the overlap reducer, in cells
    overlap_extent: float = 1.0


def check_supported(cfg: ScoringConfig) -> None:
    """Raises ``NotImplementedError`` for a score the port has not."""
    # window >= 1 holds the whole 2x2 footprint of an extent-1 square, so
    # the reference's windowed overlap equals the bilinear sample there
    if cfg.reducer != "overlap" or cfg.overlap_extent != 1.0 or cfg.window < 1:
        raise NotImplementedError(
            "the torch port scores with the overlap reducer at extent 1 and "
            f"window >= 1 only; got {cfg}"
        )


@dataclasses.dataclass
class MapView:
    """Scoring view of a map: occupancy + known mask; or of M same-shaped
    maps, with a leading dimension on every tensor."""

    occ: Tensor  # f32[H, W]
    known: Tensor  # bool[H, W]
    origin: Tensor  # f32[2]
    scale: float

    @classmethod
    def of(cls, gm: gridlib.GridMap, model) -> "MapView":
        return cls(
            occ=gridlib.occupancy_plane(gm, model),
            known=gridlib.known_mask(gm),
            origin=gm.origin,
            scale=gm.scale,
        )


@dataclasses.dataclass
class WindowView:
    """An ``sh x sw`` window of each of P maps, not cut out: the maps' view
    (``occ`` f32[P, H, W], ``known`` bool[P, H, W]), the window's first cell
    ``row``, ``col`` i64[P] and its world ``origin`` f32[P, 2].
    :meth:`cut` gives what :func:`window_view` gives; the particle match
    (``matchers.monte_carlo_match``) reads the windows in place, and every
    other score cuts them out first (:func:`prepare`)."""

    maps: MapView
    row: Tensor
    col: Tensor
    origin: Tensor
    sh: int
    sw: int

    @property
    def scale(self) -> float:
        return self.maps.scale

    def cut(self) -> MapView:
        """The windows as a view of P maps f32[P, sh, sw], in one gather."""
        take = functools.partial(gridlib.take_window, row=self.row, col=self.col, sh=self.sh,
                                 sw=self.sw)
        return MapView(occ=take(self.maps.occ), known=take(self.maps.known), origin=self.origin,
                       scale=self.maps.scale)


def window_of(view: MapView, center_xy: Tensor, size: int) -> WindowView:
    """The ``size x size`` window around ``center_xy`` f32[P, 2] of each of
    P maps, clamped to the map's bounds, as :func:`window_view` places it,
    but not cut out."""
    h, w = view.occ.shape[-2:]
    sh, sw = min(size, h), min(size, w)
    row, col, origin = gridlib.window_corner(view.origin, center_xy, view.scale, sh, sw, h, w)
    return WindowView(maps=view, row=row, col=col, origin=origin, sh=sh, sw=sw)


def window_view(view: MapView, center_xy: Tensor, size: int) -> MapView:
    """Restrict a view to a ``size x size`` cell window around a world
    point, clamped to the map's bounds. Cells outside the window then score
    as ``unknown_prob``, as cells off the map do, so a window that covers
    the scan's footprint changes no score. ``size`` at or above the map's
    extent gives the full view. With a leading map dimension (``occ``
    f32[P, H, W], ``center_xy`` f32[P, 2]) each map gets its own window,
    all in one gather: f32[P, s, s], origins f32[P, 2].

    The window's corner is a device value and is never read on the host:
    the window is taken by index arithmetic (``index_select`` on row and
    column indices, a batched gather for P maps), not by a slice."""
    if view.occ.dim() == 3:
        return window_of(view, center_xy, size).cut()
    h, w = view.occ.shape[-2:]
    sh, sw = min(size, h), min(size, w)
    row, col, origin = gridlib.window_corner(view.origin, center_xy, view.scale, sh, sw, h, w)
    dev = view.occ.device
    rows = row + torch.arange(sh, device=dev)
    cols = col + torch.arange(sw, device=dev)
    occ = view.occ.index_select(0, rows).index_select(1, cols)
    known = view.known.index_select(0, rows).index_select(1, cols)
    return MapView(occ=occ, known=known, origin=origin, scale=view.scale)


@dataclasses.dataclass
class PreparedScan:
    """Everything of one (map, scan) pair that stays fixed while a matcher
    scores candidates: built once per match, reused by every score call."""

    plane: Tensor  # f32[H, W] where(known, occ, unknown), or f32[M, H, W]
    pts: Tensor  # f32[R', 2] sensor-frame endpoints of the kept beams, or [M, R', 2]
    beam_w: Tensor  # f32[R'] validity x point weights of the kept beams, or [M, R']
    origin: Tensor  # f32[2], or f32[M, 2]
    scale: float
    unknown: float


def prepare_scan(
    scan: scanlib.LaserScan,
    cfg: ScoringConfig = ScoringConfig(),
    point_weights: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """The scan's part of :func:`prepare`: (pts f32[R', 2], beam_w f32[R'])
    of the kept beams, with any leading dimensions of the scan."""
    check_supported(cfg)
    if cfg.stride > 1:
        # keeping every stride-th beam is the reference's subsample mask
        scan = scanlib.LaserScan(
            scan.ranges[..., :: cfg.stride], scan.bearings[..., :: cfg.stride],
            scan.valid[..., :: cfg.stride],
        )
        if point_weights is not None:
            point_weights = point_weights[..., :: cfg.stride]
    beam_w = scan.valid.to(torch.float32)
    if point_weights is not None:
        beam_w = beam_w * point_weights
    return scanlib.scan_points(scan).contiguous(), beam_w.contiguous()


def prepare(
    view: MapView | WindowView,
    scan: scanlib.LaserScan,
    cfg: ScoringConfig = ScoringConfig(),
    point_weights: Tensor | None = None,
) -> PreparedScan:
    """A view's plane ``where(known, occ, unknown)`` (a :class:`WindowView`
    cut out first) with the scan's points and weights."""
    pts, beam_w = prepare_scan(scan, cfg, point_weights)
    if isinstance(view, WindowView):
        view = view.cut()
    return PreparedScan(
        plane=torch.where(view.known, view.occ, cfg.unknown_prob).contiguous(),
        pts=pts,
        beam_w=beam_w,
        origin=view.origin.contiguous(),
        scale=float(view.scale),
        unknown=float(cfg.unknown_prob),
    )


def score_prepared(prep: PreparedScan, poses: Tensor) -> Tensor:
    """f32[K, 3] candidate poses -> f32[K] scan probabilities; for M
    prepared (map, scan) pairs f32[M, K, 3] -> f32[M, K], in one launch."""
    score = kernels.overlap_score_batched if prep.plane.dim() == 3 else kernels.overlap_score
    return score(
        prep.plane, poses.contiguous(), prep.pts, prep.beam_w, prep.origin,
        prep.scale, prep.unknown,
    )


def score_poses(
    view: MapView,
    scan: scanlib.LaserScan,
    poses: Tensor,
    cfg: ScoringConfig = ScoringConfig(),
    point_weights: Tensor | None = None,
) -> Tensor:
    """Score candidate poses f32[K, 3] against the map -> f32[K]; with a
    leading map dimension on view, scan and poses, f32[M, K, 3] -> f32[M, K]."""
    return score_prepared(prepare(view, scan, cfg, point_weights), poses)


def score_single(view, scan, pose, cfg=ScoringConfig(), point_weights=None):
    return score_poses(view, scan, pose[None, :], cfg, point_weights)[0]


def estimate_information(
    view: MapView,
    scan: scanlib.LaserScan,
    pose: Tensor,
    cfg: ScoringConfig = ScoringConfig(),
    eps: tuple = (0.04, 0.04, 0.02),
) -> Tensor:
    """Diagonal information (inverse covariance) f32[3] of a match from the
    local curvature of the score surface at ``pose`` f32[3]; with a leading
    map dimension on view, scan and pose, f32[M, 3].

    Central second differences per axis (one 7-pose score call); the score
    is scaled by the count of valid beams (all of them, not the strided
    ones) to approximate a log-likelihood. Directions of negative curvature
    (degenerate, e.g. along a corridor) floor at a small positive value.
    The offsets are added without wrapping the angle, as the reference does.
    """
    e = torch.tensor(eps, dtype=torch.float32, device=pose.device)
    offs = torch.cat([torch.zeros((1, 3), device=pose.device), torch.diag(e), -torch.diag(e)])
    probs = score_poses(view, scan, pose[..., None, :] + offs, cfg)
    s0, sp, sm = probs[..., 0:1], probs[..., 1:4], probs[..., 4:7]
    curv = -(sp - 2.0 * s0 + sm) / (e * e)  # positive at a peak
    n = torch.clamp(scan.valid.sum(-1, keepdim=True).to(torch.float32), min=1.0)
    info = n * curv / torch.clamp(s0, min=1e-3)
    return torch.clamp(info, 1.0, 1e5)
