"""tinySLAM preset (port of ``slam_constructor_tpu.models.tiny``).

Same signatures and values as the reference's ``tiny_config`` and
``fast_config``, with one difference: the free-space fill is pinned to
``'dda'``. The reference's ``'auto'`` picks an algorithm by backend (DDA on
CPU, where the reference is run as the parity oracle); a preset here names
its algorithm.
"""

from __future__ import annotations

import dataclasses

from ..ops import cells, matchers, raycast, scoring
from .engine import Engine, EngineConfig


def tiny_config(
    cell: str = "bayes_avg",
    quality: float = 0.5,
    map_size: int = 256,
    map_scale: float = 0.1,
    hole_width: float = 0.3,
    mc_batch: int = 64,
    mc_rounds: int = 12,
    sigma_xy: float = 0.08,
    sigma_theta: float = 0.05,
    scoring_cfg: scoring.ScoringConfig | None = None,
) -> EngineConfig:
    if scoring_cfg is None:
        scoring_cfg = scoring.ScoringConfig(reducer="overlap", window=1, stride=1)
    if cell == "bayes_base":
        model = cells.BayesBaseCell(quality=quality)
    else:
        model = cells.BayesAvgCell()
    return EngineConfig(
        cell_model=model,
        matcher="monte_carlo",
        matcher_cfg=matchers.MonteCarloConfig(
            sigma_xy=sigma_xy,
            sigma_theta=sigma_theta,
            batch=mc_batch,
            rounds=mc_rounds,
            scoring=scoring_cfg,
        ),
        beam=raycast.BeamConfig(
            occupancy_estimator="const", hole_width=hole_width, wall_blur=True,
            free_impl="dda",
        ),
        map_height=map_size,
        map_width=map_size,
        map_scale=map_scale,
    )


def make_engine(device=None, seed: int = 0, **kwargs) -> Engine:
    return Engine(tiny_config(**kwargs), device=device, seed=seed)


def fast_config(
    map_size: int = 256,
    map_scale: float = 0.1,
    usable_range: float = 8.0,
    stride: int = 1,
    hole_width: float = 0.3,
    **kwargs,
) -> EngineConfig:
    """Windowed tiny operating point: beams capped at ``usable_range``, a
    prior-centred match window that covers exactly that reach, and a beam
    stride in the matcher. The plane the matcher samples shrinks by
    (map / window)^2."""
    cells_reach = int(-(-(usable_range + hole_width) // map_scale)) + 4
    win = min(2 * ((cells_reach + 15) // 16 * 16), map_size)
    cfg = tiny_config(
        map_size=map_size, map_scale=map_scale, hole_width=hole_width,
        scoring_cfg=scoring.ScoringConfig(reducer="overlap", window=1, stride=stride),
        **kwargs,
    )
    return dataclasses.replace(
        cfg,
        match_window=win,
        beam=raycast.BeamConfig(
            max_range=usable_range, occupancy_estimator="const",
            hole_width=hole_width, wall_blur=True, free_impl="dda",
        ),
    )
