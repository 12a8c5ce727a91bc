"""tinySLAM preset (port of ``slam_constructor_tpu.models.tiny``).

Same signature and values as the reference's ``tiny_config``, with one
difference: the free-space fill is pinned to ``'dda'``. The reference's
``'auto'`` picks an algorithm by backend (DDA on CPU, where the reference
is run as the parity oracle); a preset here names its algorithm.
``fast_config`` waits for ``match_window``.
"""

from __future__ import annotations

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


def make_engine(device="cpu", seed: int = 0, **kwargs) -> Engine:
    return Engine(tiny_config(**kwargs), device=device, seed=seed)
