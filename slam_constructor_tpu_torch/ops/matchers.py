"""Grid scan matchers: Monte-Carlo, hill climbing, brute force and gradient (port of
``slam_constructor_tpu.ops.matchers``).

Monte-Carlo: each round scores a batch of candidates drawn around the best
pose so far, keeps the best if it improves, and halves sigma after repeated
failures. The whole match is one call of ``kernels.mc_match``: one kernel
launch on the card, the plain round loop on the CPU; neither syncs with the
host. The standard normals are drawn here, outside the kernel. With a
leading particle dimension it matches P (map, scan, prior) triples in one
launch of ``kernels.mc_match_batched``, or of ``kernels.mc_match_windows``
on windows of the maps read in place: the RBPF's form.

Every matcher scores with any reducer of ``scoring.ScoringConfig`` (the
reference's default is the obstacle reducer), for one map or, with a
leading map dimension, for M (map, scan, prior) triples in one launch.

Hill climbing: coordinate descent from the prior, six axis steps scored a
round, the steps halved after a round without gain (M3RSM's refine); the
whole climb is one call of ``kernels.hill_climb``, for one map or for M
(map, scan, prior) triples at once (the loop closer's form). Brute force:
an exhaustive (x, y, theta) grid around the prior, scored in one call, for
one map or M. Gradient: ascent along the score's pose gradient with hill
climbing's keep-if-better and shrink rule, the whole refine one call of
``kernels.gradient_refine``, for one map or M. Each is one kernel launch on the card and the
plain loop on the CPU, and neither syncs with the host. M3RSM lives in
``m3rsm.py``.
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
            scoring.reducer_of(cfg.scoring),
        )
        return MatchResult(pose=pose, prob=prob, trace=trace)
    prep = scoring.prepare(view, scan, cfg.scoring, point_weights)
    match = kernels.mc_match_batched if prep.plane.dim() == 3 else kernels.mc_match
    pose, prob, trace = match(
        prep.plane, prep.pts, prep.beam_w, prep.origin, init_pose.contiguous(),
        noise.contiguous(), prep.scale, prep.unknown, *anneal, prep.reducer,
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
    prepared once and the whole climb is one call of ``kernels.hill_climb``.
    With a leading map dimension (view of M maps, scan [M, R], ``init_pose``
    f32[M, 3]) every triple climbs on its own map, all in that one call:
    pose f32[M, 3], prob f32[M], trace f32[M, iterations].
    """
    del generator, noise
    prep = scoring.prepare(view, scan, cfg.scoring, point_weights)
    pose, prob, trace = kernels.hill_climb(
        prep.plane, prep.pts, prep.beam_w, prep.origin, init_pose.contiguous(), prep.scale,
        prep.unknown, cfg.step_xy, cfg.step_theta, cfg.iterations, cfg.shrink, prep.reducer)
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


@dataclasses.dataclass(frozen=True)
class GradientConfig:
    """Gradient ascent through the overlap score, which is continuous in
    the pose; steps follow hill climbing's keep-if-better and
    shrink-on-failure rule, so the matcher never lowers the score."""

    iterations: int = 24
    step_xy: float = 0.06
    step_theta: float = 0.03
    shrink: float = 0.5
    scoring: scoring.ScoringConfig = scoring.ScoringConfig(reducer="overlap")


def gradient_match(
    view: scoring.MapView,
    scan,
    init_pose: Tensor,
    generator: torch.Generator | None = None,
    cfg: GradientConfig = GradientConfig(),
    point_weights: Tensor | None = None,
    noise: Tensor | None = None,
) -> MatchResult:
    """Refine ``init_pose`` f32[3]: each iteration takes the score's
    gradient ``g`` at the kept pose, steps ``steps * g / (|g| + 1e-12)``
    (theta wrapped) and keeps the step if it scores strictly better, else
    multiplies every step by ``shrink``. Deterministic, so ``generator`` and
    ``noise`` are ignored. With a leading map dimension (view of M maps,
    scan [M, R], ``init_pose`` f32[M, 3]) every pose is refined on its own
    map: pose f32[M, 3], prob f32[M], trace f32[M, iterations].

    The whole refine is one call of ``kernels.gradient_refine`` with the
    config's reducer: its score has ``overlap_score``'s bits, and a kept
    candidate's gradient is the next step's, as the reference takes its
    gradient at the kept pose. The obstacle, max and mean reducers and the
    overlap reducer at window 0 are piecewise constant in the pose: their
    gradient is 0, and the refine returns the start pose, its score and a
    trace of it, as the reference's does (at window 0 the reference's
    autodiff leaves rounding noise that its normalisation can turn into a
    unit step; the port takes the exact 0: ROADMAP trap r)."""
    del generator, noise
    prep = scoring.prepare(view, scan, cfg.scoring, point_weights)
    pose, prob, trace = kernels.gradient_refine(
        prep.plane, prep.pts, prep.beam_w, prep.origin, init_pose.contiguous(), prep.scale,
        prep.unknown, cfg.step_xy, cfg.step_theta, cfg.iterations, cfg.shrink, prep.reducer)
    return MatchResult(pose=pose, prob=prob, trace=trace)


#: registry for the config system; ``m3rsm.py`` adds "m3rsm"
MATCHERS = {
    "monte_carlo": (MonteCarloConfig, monte_carlo_match),
    "hill_climbing": (HillClimbingConfig, hill_climbing_match),
    "brute_force": (BruteForceConfig, brute_force_match),
    "gradient": (GradientConfig, gradient_match),
}
