"""Monte-Carlo scan matcher (port of ``slam_constructor_tpu.ops.matchers``).

Each round scores a batch of candidates drawn around the best pose so far,
keeps the best if it improves, and halves sigma after repeated failures.
The rounds are a Python loop over device tensors with no host sync: keep-
if-better and the anneal are ``torch.where``. Hill-climbing, brute-force
and gradient matchers wait for later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from . import scoring
from .geometry import wrap_angle

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
    round; when it is None they are drawn on the pose's device from
    ``generator``. The reference draws ``jax.random.normal(key_r, (batch,
    3))`` per round; a test hands those very numbers in here.
    """
    dev = init_pose.device
    if noise is None:
        noise = torch.randn(
            (cfg.rounds, cfg.batch, 3), generator=generator, device=dev,
            dtype=torch.float32,
        )
    prep = scoring.prepare(view, scan, cfg.scoring, point_weights)
    best_pose = init_pose
    best_prob = scoring.score_prepared(prep, init_pose[None, :])[0]
    # built from fills: assigning a Python float into a CUDA tensor syncs
    sigma = torch.cat([
        torch.full((2,), cfg.sigma_xy, dtype=torch.float32, device=dev),
        torch.full((1,), cfg.sigma_theta, dtype=torch.float32, device=dev),
    ])
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    trace = []
    for r in range(cfg.rounds):
        nz = noise[r] * sigma
        cand = torch.cat(
            [best_pose[None, :2] + nz[:, :2], wrap_angle(best_pose[None, 2:] + nz[:, 2:])],
            dim=-1,
        )
        probs = scoring.score_prepared(prep, cand)
        # argmax ties go to the first index, as in the reference
        i = torch.argmax(probs, dim=0, keepdim=True)
        p_i = probs.gather(0, i)[0]
        better = p_i > best_prob
        best_pose = torch.where(better, cand.index_select(0, i)[0], best_pose)
        best_prob = torch.where(better, p_i, best_prob)
        bad = torch.where(better, 0, bad + 1)
        anneal = bad >= cfg.bad_rounds_before_anneal
        sigma = torch.where(anneal, sigma * 0.5, sigma)
        bad = torch.where(anneal, 0, bad)
        trace.append(p_i)
    return MatchResult(pose=best_pose, prob=best_prob, trace=torch.stack(trace))


#: registry for the config system; the other matchers join in later slices
MATCHERS = {
    "monte_carlo": (MonteCarloConfig, monte_carlo_match),
}
