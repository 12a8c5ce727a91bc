"""The SLAM engine as a step function over tensor state (port of
``slam_constructor_tpu.models.engine``).

``slam_step(cfg, state, scan, odom) -> state`` matches the scan from the
odometry prior and inserts it at the matched pose. It never syncs with the
host: no ``.item()``, no Python branch on a tensor, no boolean-mask
indexing, so a whole sequence queues on the device. ``run_sequence`` is a
Python loop over scans that stay on the device (the reference runs it in
``lax.scan``). The reference's PRNG key is replaced by a
``torch.Generator`` owned by the ``Engine``, or by injected noise.

Entry points run on the card unless the caller names a device (see
``device.resolve_device``); the tests pass ``device="cpu"``.

With the M3RSM matcher the state carries the map's live max-occupancy
pyramid, refreshed after every insert around the scan's footprint (one
launch of ``kernels.m3rsm_pyramid_update``, gated on the device by the
insert's weight).

Waiting for later slices: the tiled storage, refine matchers and
``auto_grow``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..device import resolve_device
from ..ops import cells as cellslib
from ..ops import grid as gridlib
from ..ops import m3rsm as m3rsmlib
from ..ops import matchers as matcherslib
from ..ops import raycast, scoring
from ..ops.geometry import compose
from ..ops.scan import LaserScan, angle_histogram, scan_points

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration tree; the dense single-hypothesis fields of the
    reference's ``EngineConfig``, with the same names and defaults."""

    cell_model: Any = cellslib.BayesAvgCell()
    matcher: str = "monte_carlo"  # 'monte_carlo' or 'm3rsm' (ops.matchers.MATCHERS)
    matcher_cfg: Any = matcherslib.MonteCarloConfig()
    beam: raycast.BeamConfig = raycast.BeamConfig()
    map_height: int = 256
    map_width: int = 256
    map_scale: float = 0.1
    #: skip map insertion when match probability is below this
    min_insert_prob: float = 0.0
    refine_matcher: Any = None
    refine_cfg: Any = None
    #: weight beams by the scan-degeneracy angle histogram (vinySLAM)
    use_angle_histogram: bool = False
    #: score matches against a prior-centred window of this many cells a
    #: side (0 = the whole map); see ``scoring.window_view``
    match_window: int = 0
    map_storage: str = "dense"
    tile_block: int = 32
    tile_capacity: int = 512
    window_tiles: int = 10

    def __post_init__(self):
        waiting = {
            "matcher": self.matcher not in ("monte_carlo", "m3rsm"),
            "refine_matcher": self.refine_matcher is not None,
            "refine_cfg": self.refine_cfg is not None,
            "map_storage": self.map_storage != "dense",
            # the tiled storage's knobs
            "tile_block": self.tile_block != 32,
            "tile_capacity": self.tile_capacity != 512,
            "window_tiles": self.window_tiles != 10,
        }
        for name, set_ in waiting.items():
            if set_:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self, name)!r} is not ported yet"
                )


@dataclasses.dataclass
class SlamState:
    """Single-hypothesis engine state."""

    gm: gridlib.GridMap
    pose: Tensor  # f32[3]
    step: Tensor  # i32[]
    last_prob: Tensor  # f32[]
    #: the M3RSM matcher's live max-occupancy pyramid of the map (the
    #: reference's RescalableCachingGridMap keeps its coarse caches current
    #: on every write); empty when the matcher uses none
    pyramid: tuple = ()


def _uses_pyramid(cfg: EngineConfig) -> bool:
    return cfg.matcher == "m3rsm"


def _refresh_pyramid(cfg: EngineConfig, gm, pose: Tensor, pyramid: tuple, gate: Tensor) -> tuple:
    """Re-pool the pyramid's region that a scan insert from ``pose`` can
    touch, where ``gate`` > 0 (read on the device). A full rebuild where the
    map's sides are not multiples of 2^levels or the footprint covers the map."""
    mcfg = cfg.matcher_cfg
    levels = mcfg.levels
    unknown = mcfg.scoring.unknown_prob
    view = scoring.MapView.of(gm, cfg.cell_model)
    h, w = view.occ.shape
    step = 1 << levels
    # the insert's reach: the usable range and the wall blur's tail, which
    # writes occupancy up to hole_width / 2 beyond the endpoint
    reach = cfg.beam.max_range + cfg.beam.hole_width / 2.0
    bbox = 2 * int(-(-reach // cfg.map_scale)) + 4
    size = m3rsmlib.pyramid_refresh_size(bbox, levels, min(h, w))
    if h % step or w % step or size >= min(h, w):
        return m3rsmlib.build_pyramid(view, levels, unknown)
    center = gridlib.world_to_cell(gm, pose[None, :2])[0]
    return m3rsmlib.update_pyramid(pyramid, view, unknown, center, size, gate)


def init_state(cfg: EngineConfig, device=None) -> SlamState:
    """A fresh state on ``device`` (the card when none is named); with the
    M3RSM matcher its pyramid built and the search's constants made."""
    dev = resolve_device(device)
    gm = gridlib.make_grid_map(
        cfg.cell_model, cfg.map_height, cfg.map_width, cfg.map_scale, device=dev
    )
    pyramid: tuple = ()
    if _uses_pyramid(cfg):
        mcfg = cfg.matcher_cfg
        pyramid = m3rsmlib.build_pyramid(
            scoring.MapView.of(gm, cfg.cell_model), mcfg.levels, mcfg.scoring.unknown_prob)
        m3rsmlib.search_constants(mcfg, gm.scale, dev)
    return SlamState(
        gm=gm,
        pose=torch.zeros(3, dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        last_prob=torch.zeros((), dtype=torch.float32, device=dev),
        pyramid=pyramid,
    )


def _point_weights(cfg: EngineConfig, scan: LaserScan) -> Tensor | None:
    """vinySLAM's degeneracy weighting: points on over-represented wall
    directions (long straight walls) are down-weighted. A point's direction
    is its local wall tangent, the direction of the consecutive-endpoint
    difference, not its bearing."""
    if not cfg.use_angle_histogram:
        return None
    hist = angle_histogram(scan)
    n_bins = hist.shape[0]
    pts = scan_points(scan)
    d = pts[1:] - pts[:-1]
    tangent = torch.atan2(d[..., 1], d[..., 0])  # [R-1]
    tangent = torch.cat([tangent, tangent[-1:]])  # [R]
    bins = torch.clamp(
        torch.floor((tangent + math.pi) / (2 * math.pi) * n_bins), 0, n_bins - 1
    ).to(torch.int64)
    # hist is normalized; hist * n_bins == 1 for a uniform direction spread
    return 1.0 / (1.0 + hist[bins] * n_bins)


def slam_step(
    cfg: EngineConfig,
    state: SlamState,
    scan: LaserScan,
    odom_delta: Tensor,
    quality: float = 1.0,
    noise: Tensor | None = None,
    generator: torch.Generator | None = None,
) -> SlamState:
    """One scan: match from ``state.pose ⊕ odom_delta``, then insert.

    ``quality`` scales this scan's observation weight. ``noise`` f32[rounds,
    batch, 3] injects the matcher's standard normals; otherwise they come
    from ``generator``. The M3RSM matcher matches against the state's
    pyramid and draws nothing; the returned state holds new planes.
    """
    _, match_fn = matcherslib.MATCHERS[cfg.matcher]
    prior = compose(state.pose, odom_delta)
    pw = _point_weights(cfg, scan)
    view = scoring.MapView.of(state.gm, cfg.cell_model)
    pyramid = state.pyramid if _uses_pyramid(cfg) else ()
    if cfg.match_window and not _uses_pyramid(cfg):
        # one prior-centred window a match (M3RSM windows its own pyramid)
        view = scoring.window_view(view, prior[:2], cfg.match_window)
    live = {"pyramid": pyramid} if pyramid else {}
    res = match_fn(view, scan, prior, generator, cfg.matcher_cfg, pw, noise, **live)
    w_obs, s_obs = raycast.scan_observation_planes(state.gm, res.pose, scan, cfg.beam)
    do_insert = (res.prob >= cfg.min_insert_prob) | (state.step == 0)
    q = torch.where(do_insert, quality, 0.0)
    gm = gridlib.apply_observations(state.gm, cfg.cell_model, q * w_obs, q * s_obs)
    if pyramid:
        # refreshed only where the insert changed cells (q > 0)
        pyramid = _refresh_pyramid(cfg, gm, res.pose, pyramid, q)
    return SlamState(gm=gm, pose=res.pose, step=state.step + 1, last_prob=res.prob,
                     pyramid=pyramid)


def run_sequence(
    cfg: EngineConfig,
    state: SlamState,
    scans: LaserScan,
    odom: Tensor,
    noise: Tensor | None = None,
    generator: torch.Generator | None = None,
):
    """Run a batched sequence ``scans`` [T, R], ``odom`` f32[T, 3] on the
    state's device. ``noise`` optionally holds f32[T, rounds, batch, 3].
    Returns (final_state, trajectory f32[T, 3], probs f32[T])."""
    poses, probs = [], []
    for i in range(len(scans)):
        state = slam_step(
            cfg, state, scans[i], odom[i],
            noise=None if noise is None else noise[i], generator=generator,
        )
        poses.append(state.pose)
        probs.append(state.last_prob)
    return state, torch.stack(poses), torch.stack(probs)


class Engine:
    """Host-side front end: owns config, state, device and random generator;
    feeds scans and exposes map and trajectory."""

    def __init__(self, cfg: EngineConfig, device=None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = init_state(cfg, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.trajectory: list = []

    def handle_scan(
        self, scan: LaserScan, odom_delta: Tensor, quality: float = 1.0,
        noise: Tensor | None = None,
    ) -> Tensor:
        """Online mode: one scan at a time."""
        self.state = slam_step(
            self.cfg, self.state, scan.to(self.device), odom_delta.to(self.device),
            quality, None if noise is None else noise.to(self.device), self.generator,
        )
        self.trajectory.append(self.state.pose)
        return self.state.pose

    def run(self, scans: LaserScan, odom: Tensor, noise: Tensor | None = None):
        """Offline mode: a whole sequence, queued on the device."""
        self.state, traj, probs = run_sequence(
            self.cfg, self.state, scans.to(self.device), odom.to(self.device),
            None if noise is None else noise.to(self.device), self.generator,
        )
        self.trajectory.extend(traj.unbind(0))
        return traj, probs

    def run_stream(self, items) -> None:
        """Streaming mode: ``items`` yields (LaserScan, odom_delta) pairs."""
        for scan, odom_delta in items:
            self.handle_scan(scan, odom_delta)

    @property
    def occupancy(self) -> Tensor:
        return gridlib.occupancy_plane(self.state.gm, self.cfg.cell_model)

    @property
    def pose(self) -> Tensor:
        return self.state.pose
