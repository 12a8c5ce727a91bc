"""Grid scan matchers: Monte-Carlo and brute-force (port of
``slam_constructor_tpu.ops.matchers``).

Monte-Carlo: each round scores a batch of candidates drawn around the best
pose so far, keeps the best if it improves, and halves sigma after repeated
failures. The whole match is one call of ``kernels.mc_match``: one kernel
launch on the card, the plain round loop on the CPU; neither syncs with the
host. The standard normals are drawn here, outside the kernel. With a
leading particle dimension it matches P (map, scan, prior) triples in one
launch of ``kernels.mc_match_batched``, or of ``kernels.mc_match_windows``
on windows of the maps read in place: the RBPF's form.

Hill climbing: coordinate descent from the prior, six axis steps scored a
round in one call, the steps halved after a round without gain (M3RSM's
refine). Brute force: an exhaustive (x, y, theta) grid around the prior,
scored in one call. Both take a leading map dimension on view, scan and
prior and then match M (map, scan, prior) triples at once, one launch of
the map-batched score kernel a call: the loop closer's form. The gradient
matcher waits for a later slice; M3RSM lives in ``m3rsm.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from . import kernels, scoring
from .geometry import linspace, wrap_angle

Tensor = torch.Tensor


@dataclasses.dataclass
class MatchResult:
    pose: Tensor  # f32[3] refined world pose (f32[P, 3] for P maps)
    prob: Tensor  # f32[] scan probability at the refined pose (f32[P])
    #: f32[rounds] best candidate probability of each round; empty for the
    #: single-shot matchers
    trace: Tensor


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

    With a leading particle dimension on view, scan, prior and noise (view
    of P maps, scan [P, R], ``init_pose`` f32[P, 3], ``noise`` f32[P,
    rounds, batch, 3]) every particle is matched against its own map, all
    in one launch of ``kernels.mc_match_batched``: pose f32[P, 3], prob
    f32[P], trace f32[P, rounds]. The reference ``vmap``s the single match.
    A :class:`scoring.WindowView` is matched on its windows in place, in
    one launch of ``kernels.mc_match_windows``, with the same bits.
    """
    dev = init_pose.device
    shape = (*init_pose.shape[:-1], cfg.rounds, cfg.batch, 3)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"noise {tuple(noise.shape)} is not (..., rounds, batch, 3) = {shape}")
    anneal = (cfg.sigma_xy, cfg.sigma_theta, cfg.bad_rounds_before_anneal)
    if isinstance(view, scoring.WindowView):
        pts, beam_w = scoring.prepare_scan(scan, cfg.scoring, point_weights)
        pose, prob, trace = kernels.mc_match_windows(
            view.maps.occ, view.maps.known, view.row, view.col, view.sh, view.sw, pts, beam_w,
            view.origin.contiguous(), init_pose.contiguous(), noise.contiguous(),
            float(view.scale), float(cfg.scoring.unknown_prob), *anneal,
        )
        return MatchResult(pose=pose, prob=prob, trace=trace)
    prep = scoring.prepare(view, scan, cfg.scoring, point_weights)
    match = kernels.mc_match_batched if prep.plane.dim() == 3 else kernels.mc_match
    pose, prob, trace = match(
        prep.plane, prep.pts, prep.beam_w, prep.origin, init_pose.contiguous(),
        noise.contiguous(), prep.scale, prep.unknown, *anneal,
    )
    return MatchResult(pose=pose, prob=prob, trace=trace)


@dataclasses.dataclass(frozen=True)
class HillClimbingConfig:
    step_xy: float = 0.1
    step_theta: float = 0.05
    iterations: int = 12
    #: step shrink factor applied when no axis improves
    shrink: float = 0.5
    scoring: scoring.ScoringConfig = scoring.ScoringConfig()


def hill_climbing_match(
    view: scoring.MapView,
    scan,
    init_pose: Tensor,
    generator: torch.Generator | None = None,
    cfg: HillClimbingConfig = HillClimbingConfig(),
    point_weights: Tensor | None = None,
    noise: Tensor | None = None,
) -> MatchResult:
    """Refine ``init_pose`` f32[3]: each round scores the six poses one
    step along each axis (theta wrapped), moves to the best (ties to the
    first) if it is strictly better, else halves (``shrink``) every step.
    Deterministic, so ``generator`` and ``noise`` are ignored. The view is
    prepared once; a round is one score call, ``1 + iterations`` in all
    (``kernels.hill_climb_loop``). With a leading map dimension (view of M
    maps, scan [M, R], ``init_pose`` f32[M, 3]) every triple climbs on its
    own map, each score call one launch for all M: pose f32[M, 3], prob
    f32[M], trace f32[M, iterations].
    """
    del generator, noise
    prep = scoring.prepare(view, scan, cfg.scoring, point_weights)
    score = kernels.overlap_score_batched if prep.plane.dim() == 3 else kernels.overlap_score
    pose, prob, trace = kernels.hill_climb_loop(
        score, prep.plane, prep.pts, prep.beam_w, prep.origin, init_pose, prep.scale,
        prep.unknown, cfg.step_xy, cfg.step_theta, cfg.iterations, cfg.shrink)
    return MatchResult(pose=pose, prob=prob, trace=trace)


@dataclasses.dataclass(frozen=True)
class BruteForceConfig:
    half_x: float = 0.5
    half_y: float = 0.5
    half_theta: float = 0.2
    n_x: int = 11
    n_y: int = 11
    n_theta: int = 9
    scoring: scoring.ScoringConfig = scoring.ScoringConfig()


def brute_force_offsets(cfg: BruteForceConfig, device) -> Tensor:
    """The dense grid f32[n_x * n_y * n_theta, 3] of pose offsets, x
    slowest and theta fastest."""
    dx = linspace(-cfg.half_x, cfg.half_x, cfg.n_x, device)
    dy = linspace(-cfg.half_y, cfg.half_y, cfg.n_y, device)
    dth = linspace(-cfg.half_theta, cfg.half_theta, cfg.n_theta, device)
    gx, gy, gt = torch.meshgrid(dx, dy, dth, indexing="ij")
    return torch.stack([gx, gy, gt], dim=-1).reshape(-1, 3)


def brute_force_match(
    view: scoring.MapView,
    scan,
    init_pose: Tensor,
    generator: torch.Generator | None = None,
    cfg: BruteForceConfig = BruteForceConfig(),
    point_weights: Tensor | None = None,
    noise: Tensor | None = None,
) -> MatchResult:
    """The best pose of the grid around ``init_pose`` f32[3] (ties go to
    the first in grid order); deterministic, so ``generator`` and ``noise``
    are ignored. With a leading map dimension (view of M maps, scan [M, R],
    ``init_pose`` f32[M, 3]) every triple is matched against its own map,
    all in one score call: ``pose`` f32[M, 3], ``prob`` f32[M]."""
    del generator, noise
    cand = init_pose[..., None, :] + brute_force_offsets(cfg, init_pose.device)
    # theta is wrapped after the offset is added
    cand = torch.cat([cand[..., :2], wrap_angle(cand[..., 2:])], dim=-1)
    probs = scoring.score_poses(view, scan, cand, cfg.scoring, point_weights)
    i = torch.argmax(probs, dim=-1, keepdim=True)  # ties -> first index
    pose = torch.gather(cand, -2, i[..., None].expand(*i.shape, 3)).squeeze(-2)
    return MatchResult(
        pose=pose, prob=torch.gather(probs, -1, i).squeeze(-1),
        trace=torch.empty((0,), dtype=torch.float32, device=init_pose.device),
    )


#: registry for the config system; ``m3rsm.py`` adds "m3rsm", the gradient
#: matcher joins in a later slice
MATCHERS = {
    "monte_carlo": (MonteCarloConfig, monte_carlo_match),
    "hill_climbing": (HillClimbingConfig, hill_climbing_match),
    "brute_force": (BruteForceConfig, brute_force_match),
}
