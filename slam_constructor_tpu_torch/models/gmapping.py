"""GMapping-style Rao-Blackwellized particle filter SLAM (port of
``slam_constructor_tpu.models.gmapping``).

P particles, each with a pose and a map of its own. A step proposes each
particle's pose from odometry and motion noise, matches the scan against a
window of the particle's own map, weights the particle by the match (the
mode's height, or the improved proposal's marginal), inserts the scan into
every map on a window around its pose, and resamples when Neff drops.

The particle axis is a batch axis, as in the reference: the P matches are
one launch on the card, which reads each particle's window of its map in
place (``kernels.mc_match_windows``; the windows are cut out in one gather
only when something else scores them too), the P rasterisations one call. The step never syncs with the host:
the reference's ``lax.cond`` around the map gather becomes
``cells.index_select(0, idx)`` on every scan, with the identity for ``idx``
while Neff is healthy (same result, ~16 MB of traffic at 30 maps of 256^2).
``run_sequence`` is a Python loop over scans that stay on the device.

The reference's PRNG key is replaced by a ``torch.Generator`` owned by the
engine, or by the draws of :class:`Draws` handed in: the proposal normals,
the matcher's normals, the improved proposal's probe and sample normals
and the resampling offset, as the reference draws them from its keys.

The copy-on-write storage (``map_storage='cow'``, ``ops/cow.py``) keeps
one block pool for all particles and a block table each: every particle is
matched on its ``window_tiles`` window around its prior (the P windows
gathered in one go and matched in one launch), the tiles the P scans touch
are made each particle's own (``cow.prepare_write``), the scans go into the
shared pool in one launch (``kernels.pool_insert``), and resampling copies
tables. ``GMappingEngine.handle_scan`` polls the pool's overflow latch
every ``overflow_check_every`` scans (one host read) and doubles the pool
when it is set.

Every matcher of ``ops.matchers.MATCHERS`` runs in both slots (``matcher``
and ``refine_matcher``), on both storages, over the P windows at once:
Monte-Carlo in one launch of ``kernels.mc_match_windows`` or
``mc_match_batched``, hill climbing in one ``kernels.hill_climb``, the
gradient ascent in one ``kernels.gradient_refine``, brute force in one
``overlap_score_batched``, and M3RSM as one ``kernels.m3rsm_pyramid`` over
the P windows (the reference builds the pyramid in every call: the RBPF
hands it none) and one ``kernels.m3rsm_search`` with a request a window.

Entry points run on the card unless the caller names a device (see
``device.resolve_device``).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..ops import blockmap
from ..ops import cells as cellslib
from ..ops import cow
from ..ops import grid as gridlib
from ..ops import m3rsm as _m3rsm  # noqa: F401  (registers "m3rsm" in MATCHERS)
from ..ops import matchers as matcherslib
from ..ops import raycast, resample, scoring
from ..ops.geometry import compose, wrap_angle
from ..ops.scan import LaserScan

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GMappingConfig:
    """The reference's ``GMappingConfig`` with the same names and defaults,
    less the fields that choose a TPU lowering (``match_window_impl``,
    ``insert_impl``): the port takes its windows by index arithmetic."""

    n_particles: int = 30
    cell_model: Any = cellslib.BayesAvgCell()
    matcher: str = "monte_carlo"
    matcher_cfg: Any = matcherslib.MonteCarloConfig(
        sigma_xy=0.08, sigma_theta=0.04, batch=16, rounds=6
    )
    beam: raycast.BeamConfig = raycast.BeamConfig()
    map_height: int = 256
    map_width: int = 256
    map_scale: float = 0.1
    #: proposal noise: sigma = base + alpha * |odometry component|
    noise_xy: float = 0.03
    noise_theta: float = 0.015
    alpha_xy: float = 0.1
    alpha_theta: float = 0.1
    #: resample when Neff < frac * P
    resample_threshold: float = 0.5
    #: sharpness of the weight update: logw += gamma * log(prob)
    weight_gamma: float = 8.0
    #: 'odom' (weight by the matched mode's height) or 'improved' (fit a
    #: Gaussian to score^gamma x motion prior at probes around the mode,
    #: sample from it, weight by the marginal)
    proposal: str = "odom"
    proposal_samples: int = 16
    proposal_radius_xy: float = 0.06
    proposal_radius_theta: float = 0.03
    #: 'dense' (a map a particle) or 'cow' (one shared block pool, a block
    #: table a particle: resampling copies tables, not maps)
    map_storage: str = "dense"
    tile_block: int = 32
    tile_capacity: int = 1024
    window_tiles: int = 8
    #: match against a prior-centred window of this many cells (0 = whole map)
    match_window: int = 0
    #: insert on a pose-centred window of this many cells (0 = whole map)
    insert_window: int = 0
    #: optional second matcher pass a particle, from the first's pose
    refine_matcher: Any = None
    refine_cfg: Any = None
    #: reference GMapping's ``minimumScore``: below it a particle keeps its
    #: proposal pose, weighted by the score there (0 disables)
    min_match_prob: float = 0.0

    def __post_init__(self):
        if self.map_storage not in ("dense", "cow"):
            raise ValueError(f"map_storage={self.map_storage!r}: must be 'dense' or 'cow'")
        if self.proposal not in ("odom", "improved"):
            raise ValueError(f"proposal={self.proposal!r}: must be 'odom' or 'improved'")
        for name in ("matcher", "refine_matcher"):
            value = getattr(self, name)
            if value is not None and value not in matcherslib.MATCHERS:
                raise ValueError(f"GMappingConfig.{name}={value!r}: not one of "
                                 f"{sorted(matcherslib.MATCHERS)}")


@dataclasses.dataclass
class GMappingState:
    #: dense: cells f32[P, H, W, C], origin f32[P, 2]; cow: the shared pool
    gm: gridlib.GridMap | cow.CowBlockMaps
    poses: Tensor  # f32[P, 3]
    log_weights: Tensor  # f32[P]
    step: Tensor  # i32[]


@dataclasses.dataclass
class Draws:
    """The random numbers of one step, or with a leading T of a sequence of
    steps. The reference draws them from its keys (``gmapping_step``:
    ``split(key, 4)`` into proposal, match and resampling keys; a match key
    a particle, split once more by the improved proposal)."""

    proposal: Tensor  # f32[P, 3] standard normals of the motion noise
    u0: Tensor  # f32[] the resampling comb's offset, in [0, 1/P)
    #: f32[P, rounds, batch, 3] the Monte-Carlo matcher's standard normals
    match: Tensor | None = None
    probe: Tensor | None = None  # f32[P, J, 3] improved: probe normals
    sample: Tensor | None = None  # f32[P, 3] improved: sample normals
    #: f32[P, rounds, batch, 3] a Monte-Carlo refine's normals; None: the
    #: match's (the reference refines with the match's key)
    refine: Tensor | None = None

    def __getitem__(self, i) -> "Draws":
        return Draws(**{f.name: None if (v := getattr(self, f.name)) is None else v[i]
                        for f in dataclasses.fields(self)})

    def part(self, lo: int, hi: int) -> "Draws":
        """Particles [lo, hi) of one step's draws; the comb's offset is
        every particle's."""
        return Draws(**{f.name: None if (v := getattr(self, f.name)) is None
                        else (v if f.name == "u0" else v[lo:hi])
                        for f in dataclasses.fields(self)})

    def to(self, device) -> "Draws":
        return Draws(**{f.name: None if (v := getattr(self, f.name)) is None else v.to(device)
                        for f in dataclasses.fields(self)})


def draw(cfg: GMappingConfig, generator: torch.Generator | None, device) -> Draws:
    """One step's draws from ``generator``, on ``device``."""
    p = cfg.n_particles

    def normals(*shape):
        return torch.randn((p, *shape), generator=generator, device=device, dtype=torch.float32)

    def mc_shape(mcfg):
        return (mcfg.rounds, mcfg.batch, 3) if isinstance(mcfg, matcherslib.MonteCarloConfig) else None

    match_shape = mc_shape(cfg.matcher_cfg)
    refine_shape = mc_shape(_refine_cfg(cfg)[0]) if cfg.refine_matcher is not None else None
    return Draws(
        proposal=normals(3),
        u0=resample.uniform_offset(p, generator, device),
        match=normals(*match_shape) if match_shape else None,
        probe=normals(cfg.proposal_samples, 3) if cfg.proposal == "improved" else None,
        sample=normals(3) if cfg.proposal == "improved" else None,
        refine=normals(*refine_shape) if refine_shape and refine_shape != match_shape else None,
    )


@functools.lru_cache(maxsize=64)
def _vec3(a: float, b: float, c: float, device: torch.device) -> Tensor:
    """The constant f32[3] (a, b, c) on ``device``, made once from fills
    (putting Python numbers into a CUDA tensor syncs with the host)."""
    return torch.stack([torch.full((), v, dtype=torch.float32, device=device) for v in (a, b, c)])


def init_state(cfg: GMappingConfig, device=None) -> GMappingState:
    """P empty maps and poses at the origin with equal weights, on
    ``device`` (the card when none is named)."""
    dev = resolve_device(device)
    p = cfg.n_particles
    if cfg.map_storage == "cow":
        gm = cow.make_cow_maps(
            cfg.cell_model, n_particles=p, tiles_h=cfg.map_height // cfg.tile_block,
            tiles_w=cfg.map_width // cfg.tile_block, capacity=cfg.tile_capacity,
            block=cfg.tile_block, scale=cfg.map_scale, device=dev)
    else:
        gm1 = gridlib.make_grid_map(cfg.cell_model, cfg.map_height, cfg.map_width,
                                    cfg.map_scale, device=dev)
        gm = gridlib.GridMap(
            cells=gm1.cells.expand(p, *gm1.cells.shape).contiguous(),
            origin=gm1.origin.expand(p, 2).contiguous(),
            scale=gm1.scale,
        )
    return GMappingState(
        gm=gm,
        poses=torch.zeros((p, 3), dtype=torch.float32, device=dev),
        log_weights=resample.log_uniform_weights(p, dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _improved_proposal(cfg, view, scans, res, centers, sigma, draws):
    """Grisetti-style improved proposal for every particle: probe the score
    surface at J jittered points around the matched mode, weight each by
    score^gamma x the motion prior around the noiseless motion centre (in
    the prior's body frame), fit mean + diagonal variance, sample the pose
    from that Gaussian; the weight increment is the log-mean of the
    weights (the marginal). Returns (pose f32[P, 3], increment f32[P])."""
    dev = centers.device
    j = cfg.proposal_samples
    rad = _vec3(cfg.proposal_radius_xy, cfg.proposal_radius_xy, cfg.proposal_radius_theta, dev)
    deltas = draws.probe * rad  # [P, J, 3]
    mode = res.pose[:, None, :]
    cand = torch.cat([mode[..., :2] + deltas[..., :2], wrap_angle(mode[..., 2:] + deltas[..., 2:])],
                     dim=-1)
    probs = scoring.score_poses(view, scans, cand, cfg.matcher_cfg.scoring)  # [P, J]
    d = cand - centers[:, None, :]
    d = torch.cat([d[..., :2], wrap_angle(d[..., 2:])], dim=-1)
    # sigma is a body-frame spread: rotate the world-frame probe offsets
    # into the prior's frame before the axis-aligned Gaussian
    ch, sh = torch.cos(centers[:, 2:3]), torch.sin(centers[:, 2:3])
    d_body = torch.stack(
        [ch * d[..., 0] + sh * d[..., 1], -sh * d[..., 0] + ch * d[..., 1], d[..., 2]], dim=-1)
    log_motion = -0.5 * ((d_body / torch.clamp(sigma, min=1e-4)) ** 2).sum(-1)
    logtau = cfg.weight_gamma * torch.log(probs + 1e-6) + log_motion
    lse = torch.logsumexp(logtau, dim=-1)
    wj = torch.exp(logtau - lse[:, None])  # [P, J], sums to 1
    dm = cand - mode
    dm = torch.cat([dm[..., :2], wrap_angle(dm[..., 2:])], dim=-1)
    mu = (wj[..., None] * dm).sum(1)
    var = (wj[..., None] * (dm - mu[:, None, :]) ** 2).sum(1)
    # floor: a quarter of the probe radius keeps diversity on a peaked surface
    var = var + (0.25 * rad) ** 2
    pose = res.pose + mu + draws.sample * torch.sqrt(var)
    pose = torch.cat([pose[:, :2], wrap_angle(pose[:, 2:])], dim=-1)
    return pose, lse - torch.log(torch.full((), float(j), dtype=torch.float32, device=dev))


def _gate_match(cfg: GMappingConfig, view, scans, res, priors):
    """Reference GMapping's minimumScore: a particle whose match scores
    below the gate keeps its proposal pose, weighted by the score at that
    pose (one more score of every particle, K = 1)."""
    if cfg.min_match_prob <= 0:
        return res
    p_prior = scoring.score_poses(view, scans, priors[:, None, :], cfg.matcher_cfg.scoring)[:, 0]
    use = res.prob >= cfg.min_match_prob
    return matcherslib.MatchResult(
        pose=torch.where(use[:, None], res.pose, priors),
        prob=torch.where(use, res.prob, p_prior),
        trace=res.trace,
    )


def _refine_cfg(cfg: GMappingConfig):
    rc_default, rf = matcherslib.MATCHERS[cfg.refine_matcher]
    return (cfg.refine_cfg if cfg.refine_cfg is not None else rc_default()), rf


def _refine_rbpf(cfg: GMappingConfig, view, scans, res, draws: Draws):
    """The optional second pass of every particle, from the first's pose;
    a Monte-Carlo refine takes the match's normals unless ``draws.refine``
    holds its own."""
    if cfg.refine_matcher is None:
        return res
    rcfg, rf = _refine_cfg(cfg)
    noise = draws.refine if draws.refine is not None else draws.match
    return rf(view, scans, res.pose, None, rcfg, None, noise)


def match_view(cfg: GMappingConfig, gm: gridlib.GridMap, priors: Tensor):
    """What every particle is matched on: the ``match_window`` around its
    prior, or the whole map when it is 0 (its ``MapView``, as it is). A
    Monte-Carlo match alone reads the windows in place (a
    ``scoring.WindowView``); when anything else scores them too (a
    brute-force pass, the minimumScore gate, the improved proposal's probes)
    they are cut out once, for all of them."""
    maps = scoring.MapView.of(gm, cfg.cell_model)
    if not cfg.match_window:
        return maps
    view = scoring.window_of(maps, priors[:, :2], cfg.match_window)
    in_place = (cfg.matcher == "monte_carlo" and cfg.refine_matcher in (None, "monte_carlo")
                and cfg.min_match_prob <= 0 and cfg.proposal == "odom")
    return view if in_place else view.cut()


def match_particles(cfg: GMappingConfig, view, scans, priors, centers, sigma, draws: Draws):
    """Every particle's match pipeline at once: primary match (one launch
    for all P) -> optional refine -> minimumScore gate -> the proposal's
    (pose f32[P, 3], log-weight increment f32[P]). ``view`` holds one map
    a particle, ``scans`` the scan once a particle; ``centers`` are the
    noiseless motion centres and ``sigma`` the motion model's spread."""
    _, match_fn = matcherslib.MATCHERS[cfg.matcher]
    res = match_fn(view, scans, priors, None, cfg.matcher_cfg, None, draws.match)
    res = _refine_rbpf(cfg, view, scans, res, draws)
    res = _gate_match(cfg, view, scans, res, priors)
    if cfg.proposal == "improved":
        return _improved_proposal(cfg, view, scans, res, centers, sigma, draws)
    return res.pose, cfg.weight_gamma * torch.log(res.prob + 1e-6)


def propose(cfg: GMappingConfig, poses: Tensor, odom_delta: Tensor, noise: Tensor):
    """The proposal of the particles at ``poses`` f32[N, 3]: odometry plus
    motion noise, ``noise`` f32[N, 3] their standard normals scaled by the
    motion model's spread. Returns (the spread sigma f32[3], the priors
    f32[N, 3], the noiseless motion centres f32[N, 3], which the improved
    proposal needs)."""
    dev = poses.device
    base = _vec3(cfg.noise_xy, cfg.noise_xy, cfg.noise_theta, dev)
    alpha = _vec3(cfg.alpha_xy, cfg.alpha_xy, cfg.alpha_theta, dev)
    sigma = base + alpha * torch.abs(odom_delta)
    priors = compose(poses, odom_delta[None, :] + noise * sigma)
    centers = compose(poses, odom_delta.expand(poses.shape[0], 3))
    return sigma, priors, centers


def expand_scan(scan: LaserScan, n: int) -> LaserScan:
    """The scan once for each of ``n`` particles (views, no copy)."""
    return LaserScan(scan.ranges.expand(n, -1), scan.bearings.expand(n, -1),
                     scan.valid.expand(n, -1))


def _identity(x):
    return x


@dataclasses.dataclass(frozen=True)
class StepOps:
    """What an RBPF step does that depends on where its particles and maps
    live; the step itself (:func:`rbpf_step`) is the same on one device
    and over ranks. A process holds the particles ``span`` = [lo, hi) of P
    (None: all of them), and the maps ``gm`` of those.

    - ``match(gm, scans, priors, centers, sigma, draws)`` -> (poses,
      log-weight increments) of its particles;
    - ``insert(gm, poses, scans)`` -> its maps with their scans;
    - ``take(gm, idx, did)`` -> the maps of its new particles, from every
      particle's ancestor ``idx`` i64[P] (the same in every process);
      ``did`` bool[] says whether resampling fired;
    - ``normalize(logw)`` -> its log-weights normalised over all P;
    - ``gather(x)`` -> every process's ``x`` along the particle axis.
    """

    match: Callable
    insert: Callable
    take: Callable
    span: tuple[int, int] | None = None
    normalize: Callable = resample.normalize_log_weights
    gather: Callable = _identity


def match_dense(cfg: GMappingConfig, gm: gridlib.GridMap, scans, priors, centers, sigma,
                draws: Draws):
    """The particles matched on their own dense maps (:func:`match_view`,
    then :func:`match_particles`)."""
    return match_particles(cfg, match_view(cfg, gm, priors), scans, priors, centers, sigma, draws)


def insert_dense(cfg: GMappingConfig, gm: gridlib.GridMap, poses: Tensor, scans):
    """Every particle's scan into its map, on a window around its pose."""
    return raycast.insert_scan_windows(gm, cfg.cell_model, poses, scans, cfg.beam,
                                       cfg.insert_window)


def take_dense(gm: gridlib.GridMap, idx: Tensor, did=None) -> gridlib.GridMap:
    """The ancestors' maps. The gather runs every scan, with the identity
    while Neff is healthy: no host read."""
    return gridlib.GridMap(cells=gm.cells.index_select(0, idx),
                           origin=gm.origin.index_select(0, idx), scale=gm.scale)


def match_cow(cfg: GMappingConfig, st: cow.CowBlockMaps, scans, priors, centers, sigma,
              draws: Draws):
    """The particles matched on the ``window_tiles`` window of their tables
    around their priors (the windows cut out of the pool in one gather)."""
    wt = cfg.window_tiles
    win = cow.extract_window(st, cfg.cell_model, None, priors[:, :2], wt, wt)
    view = scoring.MapView.of(win, cfg.cell_model)
    return match_particles(cfg, view, scans, priors, centers, sigma, draws)


def local_ops(cfg: GMappingConfig) -> StepOps:
    """The step's parts on one device: the P maps dense, or tables over
    the one copy-on-write pool (the touched tiles made each particle's
    own, the P scans inserted in one launch, the tables resampled)."""
    if cfg.map_storage == "cow":
        return StepOps(
            match=functools.partial(match_cow, cfg),
            insert=lambda st, poses, scans: cow.insert_scans(st, cfg.cell_model, poses, scans,
                                                             cfg.beam),
            take=lambda st, idx, did: cow.resample(st, idx))
    return StepOps(match=functools.partial(match_dense, cfg),
                   insert=functools.partial(insert_dense, cfg), take=take_dense)


def rbpf_step(cfg: GMappingConfig, ops: StepOps, state: GMappingState, scan: LaserScan,
              odom_delta: Tensor, draws: Draws | None = None,
              generator: torch.Generator | None = None):
    """One RBPF step of the particles ``state`` holds, ``ops`` saying where
    they live: propose -> match -> weight -> insert -> resample. ``draws``
    holds the whole step's random numbers (every process's the same), or
    ``generator`` draws them; each process uses its particles' slice.
    Returns (state, ancestor indices i64[P])."""
    if draws is None:
        draws = draw(cfg, generator, state.poses.device)
    lo, hi = ops.span or (0, cfg.n_particles)
    mine = draws.part(lo, hi)

    # 1. proposal: odometry + per-particle motion noise
    sigma, priors, centers = propose(cfg, state.poses, odom_delta, mine.proposal)
    scans = expand_scan(scan, hi - lo)

    # 2. every particle against its own map, in one launch
    poses, incr = ops.match(state.gm, scans, priors, centers, sigma, mine)

    # 3. weight update
    logw = ops.normalize(state.log_weights + incr)

    # 4. insert the scan into every particle's map
    gm = ops.insert(state.gm, poses, scans)

    # 5. conditional systematic resampling: the ancestors from every
    # particle's weight, the same in every process
    idx, logw, did = resample.maybe_resample(draws.u0, ops.gather(logw), cfg.resample_threshold)
    state = GMappingState(gm=ops.take(gm, idx, did),
                          poses=ops.gather(poses).index_select(0, idx[lo:hi]),
                          log_weights=logw[lo:hi], step=state.step + 1)
    return state, idx


def gmapping_step(
    cfg: GMappingConfig,
    state: GMappingState,
    scan: LaserScan,
    odom_delta: Tensor,
    draws: Draws | None = None,
    generator: torch.Generator | None = None,
):
    """One RBPF step of all P particles on one device (:func:`rbpf_step`
    with :func:`local_ops`). Returns (state, ancestor indices i64[P])."""
    return rbpf_step(cfg, local_ops(cfg), state, scan, odom_delta, draws, generator)


def best_particle(state: GMappingState) -> Tensor:
    """i64[] index of the highest weight (ties: the first)."""
    return torch.argmax(state.log_weights)


def estimate_pose(state: GMappingState) -> Tensor:
    """Pose of the highest-weight particle (reference convention)."""
    return state.poses.index_select(0, best_particle(state).reshape(1))[0]


def neff(state: GMappingState) -> Tensor:
    return resample.effective_sample_size(state.log_weights)


def run_sequence(
    cfg: GMappingConfig,
    state: GMappingState,
    scans: LaserScan,
    odom: Tensor,
    draws: Draws | None = None,
    generator: torch.Generator | None = None,
):
    """Run ``scans`` [T, R], ``odom`` f32[T, 3] on the state's device with
    no host sync. ``draws`` optionally holds every step's draws (a leading
    T). Returns (final state, best-particle pose f32[T, 3], Neff f32[T],
    every particle's pose f32[T, P, 3], ancestors i64[T, P]); the last two
    give genealogy-consistent trajectories (:func:`winner_trajectory`)."""
    traj, neffs, all_poses, ancestors = [], [], [], []
    for i in range(len(scans)):
        state, anc = gmapping_step(cfg, state, scans[i], odom[i],
                                   None if draws is None else draws[i], generator)
        traj.append(estimate_pose(state))
        neffs.append(neff(state))
        all_poses.append(state.poses)
        ancestors.append(anc)
    return (state, torch.stack(traj), torch.stack(neffs), torch.stack(all_poses),
            torch.stack(ancestors))


def _lineages(ancestors: Tensor, last: np.ndarray) -> np.ndarray:
    """i64[T, N]: the slot at each step of the particles in slots ``last``
    at the final step, walking ``ancestors[t, i]`` (the slot before step
    t's resampling of the particle in slot i after it). One transfer of the
    genealogy to the host; the walk is T numpy gathers."""
    anc = ancestors.cpu().numpy()
    path = np.empty((anc.shape[0], len(last)), np.int64)
    idx = np.asarray(last, np.int64)
    for t in range(anc.shape[0] - 1, -1, -1):
        path[t] = idx
        idx = anc[t, idx]
    return path


def winner_trajectory(all_poses: Tensor, ancestors: Tensor, winner) -> Tensor:
    """The ancestral pose path f32[T, 3] of particle ``winner`` at the final
    step: the RBPF's trajectory estimate, consistent across resampling."""
    t = all_poses.shape[0]
    path = torch.from_numpy(_lineages(ancestors, np.array([int(winner)]))[:, 0])
    return all_poses[torch.arange(t, device=all_poses.device), path.to(all_poses.device)]


def weighted_mean_trajectory(all_poses: Tensor, ancestors: Tensor, log_weights: Tensor) -> Tensor:
    """The weight-softmax mix f32[T, 3] of every final particle's
    genealogy-consistent path (circular mean for headings)."""
    t, p = all_poses.shape[:2]
    path = torch.from_numpy(_lineages(ancestors, np.arange(p))).to(all_poses.device)
    trajs = all_poses[torch.arange(t, device=all_poses.device)[:, None], path].transpose(0, 1)
    w = torch.softmax(log_weights, dim=0)
    xy = (w[:, None, None] * trajs[..., :2]).sum(0)
    s = (w[:, None] * torch.sin(trajs[..., 2])).sum(0)
    c = (w[:, None] * torch.cos(trajs[..., 2])).sum(0)
    return torch.cat([xy, torch.atan2(s, c)[..., None]], dim=-1)


class GMappingEngine:
    """Host driver mirroring ``engine.Engine`` for the RBPF: owns config,
    state, device and generator; feeds scans; exposes the best particle's
    map and the winner's trajectory."""

    def __init__(self, cfg: GMappingConfig | None = None, device=None, seed: int = 0, **kwargs):
        if cfg is None:
            cfg = GMappingConfig(**kwargs)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = init_state(cfg, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.trajectory: list = []
        #: (all_poses f32[T, P, 3], ancestors i64[T, P]) of the last run()
        self.genealogy = None

    #: online mode on the copy-on-write maps: read the pool's overflow latch
    #: every this many scans (a host read, so not every scan) and double the
    #: pool when it is set
    overflow_check_every: int = 32

    def handle_scan(self, scan: LaserScan, odom_delta: Tensor, draws: Draws | None = None) -> Tensor:
        """Online mode: one scan; returns the best particle's pose."""
        self.state, _ = gmapping_step(
            self.cfg, self.state, scan.to(self.device), odom_delta.to(self.device),
            None if draws is None else draws.to(self.device), self.generator,
        )
        pose = estimate_pose(self.state)
        self.trajectory.append(pose)
        if (self.cfg.map_storage == "cow"
                and len(self.trajectory) % self.overflow_check_every == 0
                and bool(self.state.gm.overflow)):
            self._grow_pool()
        return pose

    def _grow_pool(self) -> None:
        """Double the copy-on-write pool (a host event; the latch clears)."""
        self.state.gm = cow.grow_pool(self.state.gm, self.cfg.cell_model,
                                      2 * self.state.gm.capacity)

    def run(self, scans: LaserScan, odom: Tensor, draws: Draws | None = None):
        """Offline mode: a whole sequence, queued on the device. Returns
        (best-particle pose f32[T, 3], Neff f32[T])."""
        self.state, traj, neffs, all_poses, ancestors = run_sequence(
            self.cfg, self.state, scans.to(self.device), odom.to(self.device),
            None if draws is None else draws.to(self.device), self.generator,
        )
        self.genealogy = (all_poses, ancestors)
        self.trajectory.extend(traj.unbind(0))
        return traj, neffs

    def winner_trajectory(self) -> Tensor:
        """Genealogy-consistent trajectory of the final best particle."""
        if self.genealogy is None:
            raise RuntimeError("winner_trajectory needs a run() first")
        return winner_trajectory(*self.genealogy, best_particle(self.state))

    @property
    def occupancy(self) -> Tensor:
        """f32[H, W] occupancy of the best particle's map."""
        i = best_particle(self.state).reshape(1)
        if self.cfg.map_storage == "cow":
            st = self.state.gm
            th, tw = st.tables.shape[1:]
            win = blockmap.gather_window(
                st.tables.index_select(0, i)[0], st.pool, self.cfg.cell_model, st.origin,
                st.scale, torch.zeros(2, device=self.device), th, tw)
            return gridlib.occupancy_plane(win, self.cfg.cell_model)
        gm = gridlib.GridMap(cells=self.state.gm.cells.index_select(0, i)[0],
                             origin=self.state.gm.origin.index_select(0, i)[0],
                             scale=self.state.gm.scale)
        return gridlib.occupancy_plane(gm, self.cfg.cell_model)


def fast_config(
    n_particles: int = 30,
    map_size: int = 256,
    map_scale: float = 0.1,
    usable_range: float = 6.0,
    proposal: str = "odom",
    stride: int = 2,
) -> GMappingConfig:
    """The reference's fast operating point: overlap scoring on every
    ``stride``-th beam, 5 Monte-Carlo rounds of 20, insertion capped at
    ``usable_range`` (GMapping's maxUrange) with pose-centred match and
    insert windows that cover it exactly. The free fill is pinned to 'dda',
    the reference's off the TPU.

    Window arithmetic: reach = (usable_range + hole_width) / scale + 4
    cells; the window snaps up to cover twice the reach (160 cells at the
    defaults)."""
    cells_reach = int(-(-(usable_range + 0.3) // map_scale)) + 4
    win = min(2 * ((cells_reach + 15) // 16 * 16), map_size)
    cfg = GMappingConfig(
        n_particles=n_particles,
        map_height=map_size,
        map_width=map_size,
        map_scale=map_scale,
        matcher_cfg=matcherslib.MonteCarloConfig(
            sigma_xy=0.06, sigma_theta=0.03, batch=20, rounds=5,
            scoring=_fast_scoring(stride),
        ),
        match_window=win,
        insert_window=win,
        beam=raycast.BeamConfig(max_range=usable_range, free_impl="dda"),
        proposal=proposal,
    )
    if proposal == "improved":
        warnings.warn(
            "fast_config(proposal='improved'): the reference measured the improved "
            "proposal worse than 'odom' at this operating point (5-seed winner ATE); "
            "use proposal='odom' unless odometry noise is far above the bench's.",
            stacklevel=2,
        )
        cfg = dataclasses.replace(cfg, resample_threshold=0.5, weight_gamma=8.0)
    return cfg


def _fast_scoring(stride: int = 1) -> scoring.ScoringConfig:
    return scoring.ScoringConfig(reducer="overlap", window=1, stride=stride)
