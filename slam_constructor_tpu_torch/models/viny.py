"""vinySLAM preset (port of ``slam_constructor_tpu.models.viny``):
Transferable-Belief-Model cells, matching weighted by the scan's angle
histogram, and quality-gated insertion.

Same signature and values as the reference's ``viny_config``, with one
difference: the free-space fill is pinned to ``'polar'``. The reference's
``'auto'`` picks an algorithm by backend and resolves to the dense polar
fill on its accelerator; a preset here names its algorithm. On the card
every insert then goes through the ``polar_free_plane`` CUDA kernel and
every score through ``overlap_score``.

``viny_m3rsm_config`` is vinySLAM with the M3RSM global matcher (the
reference's values; the DDA free fill, as the reference pins it).
"""

from __future__ import annotations

import math

from ..ops import cells, m3rsm, matchers, raycast, scoring
from .engine import Engine, EngineConfig


def viny_config(
    quality: float = 0.5,
    conflict_decay: float = 0.1,
    map_size: int = 256,
    map_scale: float = 0.1,
    hole_width: float = 0.3,
    mc_batch: int = 64,
    mc_rounds: int = 16,
    min_insert_prob: float = 0.0,
    use_angle_histogram: bool = True,
    scoring_cfg: scoring.ScoringConfig | None = None,
    stride: int = 2,
) -> EngineConfig:
    """``stride``: the matcher scores every ``stride``-th beam. For sparse
    scans (<= 120 beams) prefer ``stride=1``: the single-hypothesis matcher
    has no particle diversity to absorb a lossy score."""
    if scoring_cfg is None:
        scoring_cfg = scoring.ScoringConfig(reducer="overlap", window=1, stride=stride)
    return EngineConfig(
        cell_model=cells.TBMCell(quality=quality, conflict_decay=conflict_decay),
        matcher="monte_carlo",
        matcher_cfg=matchers.MonteCarloConfig(
            sigma_xy=0.08,
            sigma_theta=0.05,
            batch=mc_batch,
            rounds=mc_rounds,
            scoring=scoring_cfg,
        ),
        # const endpoint evidence + symmetric wall blur tracks best with TBM
        # cells; 'area' remains a config choice
        beam=raycast.BeamConfig(
            occupancy_estimator="const", hole_width=hole_width, wall_blur=True,
            free_impl="polar",
        ),
        map_height=map_size,
        map_width=map_size,
        map_scale=map_scale,
        min_insert_prob=min_insert_prob,
        use_angle_histogram=use_angle_histogram,
    )


def make_engine(device=None, seed: int = 0, **kwargs) -> Engine:
    return Engine(viny_config(**kwargs), device=device, seed=seed)


def viny_m3rsm_config(
    map_size: int = 256,
    map_scale: float = 0.1,
    usable_range: float = 5.0,
    quality: float = 0.5,
    hole_width: float = 0.3,
    levels: int = 4,
    n_theta: int = 9,
    beam_width: int = 48,
    half_xy: float = 0.6,
    half_theta: float = 0.2,
    stride: int = 2,
    use_angle_histogram: bool = True,
    reducer: str = "overlap",
) -> EngineConfig:
    """vinySLAM with the M3RSM global matcher on every scan, the
    reference's values: beams capped at the usable range, a prior-centred
    search window sized so that the windowed level scoring is exact (it
    covers the scan's reach from anywhere in the search region, rounded up
    to 2^levels), and the DDA free fill, as the reference pins it (its
    polar fill's halo around walls aliases the global search)."""
    step = 1 << levels
    reach = math.ceil((usable_range + hole_width / 2) / map_scale)
    need = 2 * (reach + math.ceil(half_xy / map_scale) + step)
    window = min(-(-need // step) * step, map_size)
    return EngineConfig(
        cell_model=cells.TBMCell(quality=quality),
        matcher="m3rsm",
        matcher_cfg=m3rsm.M3RSMConfig(
            half_x=half_xy, half_y=half_xy, half_theta=half_theta,
            n_theta=n_theta, levels=levels, beam_width=beam_width,
            window=window,
            scoring=scoring.ScoringConfig(reducer=reducer, stride=stride),
        ),
        beam=raycast.BeamConfig(
            max_range=usable_range, occupancy_estimator="const",
            hole_width=hole_width, wall_blur=True, free_impl="dda",
        ),
        map_height=map_size,
        map_width=map_size,
        map_scale=map_scale,
        use_angle_histogram=use_angle_histogram,
    )
