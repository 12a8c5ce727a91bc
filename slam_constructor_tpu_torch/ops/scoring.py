"""Scan-likelihood scoring (port of ``slam_constructor_tpu.ops.scoring``).

``score_poses(view, scan, poses[K]) -> probs[K]``: the mean per-beam
consistency probability of a scan placed at each candidate pose. Ported is
the overlap reducer at extent 1, the one tinySLAM and vinySLAM run; every
score goes through ``kernels.overlap_score`` (the CUDA kernel on the card). The
obstacle, mean and max reducers, other extents, ``window_view`` and
``estimate_information`` wait for later slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

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


def _check_supported(cfg: ScoringConfig) -> None:
    # window >= 1 holds the whole 2x2 footprint of an extent-1 square, so
    # the reference's windowed overlap equals the bilinear sample there
    if cfg.reducer != "overlap" or cfg.overlap_extent != 1.0 or cfg.window < 1:
        raise NotImplementedError(
            "the torch port scores with the overlap reducer at extent 1 and "
            f"window >= 1 only; got {cfg}"
        )


@dataclasses.dataclass
class MapView:
    """Scoring view of a map: occupancy + known mask."""

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
class PreparedScan:
    """Everything of one (map, scan) pair that stays fixed while a matcher
    scores candidates: built once per match, reused by every score call."""

    plane: Tensor  # f32[H, W] where(known, occ, unknown)
    pts: Tensor  # f32[R', 2] sensor-frame endpoints of the kept beams
    beam_w: Tensor  # f32[R'] validity x point weights of the kept beams
    origin: Tensor
    scale: float
    unknown: float


def prepare(
    view: MapView,
    scan: scanlib.LaserScan,
    cfg: ScoringConfig = ScoringConfig(),
    point_weights: Tensor | None = None,
) -> PreparedScan:
    _check_supported(cfg)
    if cfg.stride > 1:
        # keeping every stride-th beam is the reference's subsample mask
        scan = scanlib.LaserScan(
            scan.ranges[:: cfg.stride], scan.bearings[:: cfg.stride],
            scan.valid[:: cfg.stride],
        )
        if point_weights is not None:
            point_weights = point_weights[:: cfg.stride]
    beam_w = scan.valid.to(torch.float32)
    if point_weights is not None:
        beam_w = beam_w * point_weights
    return PreparedScan(
        plane=torch.where(view.known, view.occ, cfg.unknown_prob).contiguous(),
        pts=scanlib.scan_points(scan).contiguous(),
        beam_w=beam_w.contiguous(),
        origin=view.origin.contiguous(),
        scale=float(view.scale),
        unknown=float(cfg.unknown_prob),
    )


def score_prepared(prep: PreparedScan, poses: Tensor) -> Tensor:
    """f32[K, 3] candidate poses -> f32[K] scan probabilities."""
    return kernels.overlap_score(
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
    """Score candidate poses f32[K, 3] against the map -> f32[K]."""
    return score_prepared(prepare(view, scan, cfg, point_weights), poses)


def score_single(view, scan, pose, cfg=ScoringConfig(), point_weights=None):
    return score_poses(view, scan, pose[None, :], cfg, point_weights)[0]
