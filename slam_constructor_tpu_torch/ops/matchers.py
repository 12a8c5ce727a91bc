"""Monte-Carlo scan matcher (port of ``slam_constructor_tpu.ops.matchers``).

Each round scores a batch of candidates drawn around the best pose so far,
keeps the best if it improves, and halves sigma after repeated failures.
The whole match is one call of ``kernels.mc_match``: one kernel launch on
the card, the plain round loop on the CPU; neither syncs with the host.
The standard normals are drawn here, outside the kernel. Hill-climbing,
brute-force and gradient matchers wait for later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from . import kernels, scoring

Tensor = torch.Tensor


@dataclasses.dataclass
class MatchResult:
    pose: Tensor  # f32[3] refined world pose
    prob: Tensor  # f32[] scan probability at the refined pose
    trace: Tensor  # f32[rounds] best candidate probability of each round


@dataclasses.dataclass(frozen=True)
class MonteCarloConfig:
    sigma_xy: float = 0.2
    sigma_theta: float = 0.1
    #: candidates scored per round
    batch: int = 32
    rounds: int = 12
    #: rounds without improvement before sigma is halved
    bad_rounds_before_anneal: int = 2
    scoring: scoring.ScoringConfig = scoring.ScoringConfig()


def monte_carlo_match(
    view: scoring.MapView,
    scan,
    init_pose: Tensor,
    generator: torch.Generator | None = None,
    cfg: MonteCarloConfig = MonteCarloConfig(),
    point_weights: Tensor | None = None,
    noise: Tensor | None = None,
) -> MatchResult:
    """Refine ``init_pose`` f32[3].

    ``noise`` f32[rounds, batch, 3] holds the standard normals of every
    round, ``cfg.rounds`` by ``cfg.batch`` of them; when it is None they
    are drawn on the pose's device from ``generator``. The reference draws
    ``jax.random.normal(key_r, (batch, 3))`` per round; a test hands those
    very numbers in here.
    """
    dev = init_pose.device
    if noise is None:
        noise = torch.randn(
            (cfg.rounds, cfg.batch, 3), generator=generator, device=dev,
            dtype=torch.float32,
        )
    elif tuple(noise.shape) != (cfg.rounds, cfg.batch, 3):
        raise ValueError(
            f"noise {tuple(noise.shape)} is not (rounds, batch, 3) = "
            f"({cfg.rounds}, {cfg.batch}, 3)"
        )
    prep = scoring.prepare(view, scan, cfg.scoring, point_weights)
    pose, prob, trace = kernels.mc_match(
        prep.plane, prep.pts, prep.beam_w, prep.origin, init_pose.contiguous(),
        noise.contiguous(), prep.scale, prep.unknown, cfg.sigma_xy, cfg.sigma_theta,
        cfg.bad_rounds_before_anneal,
    )
    return MatchResult(pose=pose, prob=prob, trace=trace)


#: registry for the config system; the other matchers join in later slices
MATCHERS = {
    "monte_carlo": (MonteCarloConfig, monte_carlo_match),
}
