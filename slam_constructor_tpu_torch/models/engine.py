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

With the M3RSM matcher on a dense map the state carries the map's live
max-occupancy pyramid, refreshed after every insert around the scan's
footprint (one launch of ``kernels.m3rsm_pyramid_update``, gated on the
device by the insert's weight).

An optional refine matcher runs from the primary match's pose (the
gradient ascent of ``tiny_refined``, the hill climb of ``mit_csail``). The
tiled storage (``map_storage='tiled'``, ``ops/blockmap.py``) matches
against a dense window of tiles around the prior and inserts the scan into
its block pool (``blockmap.insert_scan``: the touched tiles allocated on
the device, then K3 over the pool), in place.

``Engine.auto_grow`` grows a dense map when a scan's endpoints leave it (the
reference's unbounded map, a host event): ``handle_scan`` checks
containment on the device and reads one bool a scan while it is on, and
only a scan that leaves the map reads more (``grid.grow_to_contain``); a
grown map's M3RSM pyramid is rebuilt.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..device import resolve_device
from ..ops import blockmap
from ..ops import cells as cellslib
from ..ops import grid as gridlib
from ..ops import m3rsm as m3rsmlib
from ..ops import matchers as matcherslib
from ..ops import raycast, scoring
from ..ops.geometry import apply_pose, compose
from ..ops.scan import LaserScan, angle_histogram, scan_points

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration tree: the reference's ``EngineConfig``, with the
    same names and defaults."""

    cell_model: Any = cellslib.BayesAvgCell()
    matcher: str = "monte_carlo"  # a key of ops.matchers.MATCHERS
    matcher_cfg: Any = matcherslib.MonteCarloConfig()
    beam: raycast.BeamConfig = raycast.BeamConfig()
    map_height: int = 256
    map_width: int = 256
    map_scale: float = 0.1
    #: skip map insertion when match probability is below this
    min_insert_prob: float = 0.0
    #: optional second matcher run from the primary match's pose (a key of
    #: ops.matchers.MATCHERS: 'gradient', 'hill_climbing', ...) and its config
    refine_matcher: Any = None
    refine_cfg: Any = None
    #: weight beams by the scan-degeneracy angle histogram (vinySLAM)
    use_angle_histogram: bool = False
    #: score matches against a prior-centred window of this many cells a
    #: side (0 = the whole map); see ``scoring.window_view``
    match_window: int = 0
    #: 'dense' (one plane) or 'tiled' (the block pool of ops/blockmap.py)
    map_storage: str = "dense"
    #: tiled storage: block side (cells), pool capacity (blocks), and the
    #: dense window matched against, in tiles a side
    tile_block: int = 32
    tile_capacity: int = 512
    window_tiles: int = 10

    def __post_init__(self):
        for name in ("matcher", "refine_matcher"):
            value = getattr(self, name)
            if value is not None and value not in matcherslib.MATCHERS:
                raise ValueError(f"EngineConfig.{name}={value!r}: not one of "
                                 f"{sorted(matcherslib.MATCHERS)}")
        if self.map_storage not in ("dense", "tiled"):
            raise ValueError(f"map_storage={self.map_storage!r}: must be 'dense' or 'tiled'")


@dataclasses.dataclass
class SlamState:
    """Single-hypothesis engine state."""

    gm: gridlib.GridMap | blockmap.BlockMap
    pose: Tensor  # f32[3]
    step: Tensor  # i32[]
    last_prob: Tensor  # f32[]
    #: the M3RSM matcher's live max-occupancy pyramid of the map (the
    #: reference's RescalableCachingGridMap keeps its coarse caches current
    #: on every write); empty when the matcher uses none
    pyramid: tuple = ()


def _uses_pyramid(cfg: EngineConfig) -> bool:
    return cfg.matcher == "m3rsm" and cfg.map_storage == "dense"


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
    if cfg.map_storage == "tiled":
        gm = blockmap.make_block_map(
            cfg.cell_model, tiles_h=cfg.map_height // cfg.tile_block,
            tiles_w=cfg.map_width // cfg.tile_block, capacity=cfg.tile_capacity,
            block=cfg.tile_block, scale=cfg.map_scale, device=dev,
        )
    else:
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


def _refine(cfg: EngineConfig, view, scan, res, generator, pw, noise):
    """The optional second matcher from the primary match's pose. Hill
    climbing and gradient ascent keep the start pose unless the score
    improves. A Monte-Carlo refine gets the primary match's ``noise``, as
    the reference hands both matches one key."""
    if cfg.refine_matcher is None:
        return res
    refine_cls, refine_fn = matcherslib.MATCHERS[cfg.refine_matcher]
    rcfg = cfg.refine_cfg if cfg.refine_cfg is not None else refine_cls()
    return refine_fn(view, scan, res.pose, generator, rcfg, pw, noise)


def slam_step(
    cfg: EngineConfig,
    state: SlamState,
    scan: LaserScan,
    odom_delta: Tensor,
    quality: float = 1.0,
    noise: Tensor | None = None,
    generator: torch.Generator | None = None,
) -> SlamState:
    """One scan: match from ``state.pose ⊕ odom_delta`` (then refine), then
    insert.

    ``quality`` scales this scan's observation weight. ``noise`` f32[rounds,
    batch, 3] injects the matcher's standard normals; otherwise they come
    from ``generator``. The M3RSM matcher matches against the state's
    pyramid and draws nothing; the returned state holds new planes. On the
    tiled map the match runs on the ``window_tiles`` window around the
    prior, and the insert allocates tiles in the pool.
    """
    _, match_fn = matcherslib.MATCHERS[cfg.matcher]
    prior = compose(state.pose, odom_delta)
    pw = _point_weights(cfg, scan)
    if cfg.map_storage == "tiled":
        window = blockmap.extract_window(
            state.gm, cfg.cell_model, prior[:2], cfg.window_tiles, cfg.window_tiles)
        view = scoring.MapView.of(window, cfg.cell_model)
        res = match_fn(view, scan, prior, generator, cfg.matcher_cfg, pw, noise)
        res = _refine(cfg, view, scan, res, generator, pw, noise)
        do_insert = (res.prob >= cfg.min_insert_prob) | (state.step == 0)
        # q = 0 (gated) leaves zero-weight samples: no tile allocated, no fold
        q = torch.where(do_insert, quality, 0.0)
        gm = blockmap.insert_scan(state.gm, cfg.cell_model, res.pose, scan, cfg.beam, q)
        return SlamState(gm=gm, pose=res.pose, step=state.step + 1, last_prob=res.prob)

    view = scoring.MapView.of(state.gm, cfg.cell_model)
    pyramid = state.pyramid if _uses_pyramid(cfg) else ()
    if cfg.match_window and not _uses_pyramid(cfg):
        # one prior-centred window a match (M3RSM windows its own pyramid)
        view = scoring.window_view(view, prior[:2], cfg.match_window)
    live = {"pyramid": pyramid} if pyramid else {}
    res = match_fn(view, scan, prior, generator, cfg.matcher_cfg, pw, noise, **live)
    res = _refine(cfg, view, scan, res, generator, pw, noise)
    do_insert = (res.prob >= cfg.min_insert_prob) | (state.step == 0)
    q = torch.where(do_insert, quality, 0.0)
    # the rasterisation and the fold in one call: K3 on the card
    gm = raycast.insert_scan(state.gm, cfg.cell_model, res.pose, scan, cfg.beam, q)
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

    #: grow the dense map when a scan's endpoints leave it (``handle_scan``
    #: only; the reference's UnboundedPlainGridMap as a host event, with a
    #: margin so that growth stays rare)
    auto_grow: bool = False

    def handle_scan(
        self, scan: LaserScan, odom_delta: Tensor, quality: float = 1.0,
        noise: Tensor | None = None,
    ) -> Tensor:
        """Online mode: one scan at a time."""
        if self.auto_grow and self.cfg.map_storage == "dense":
            self._maybe_grow(scan.to(self.device))
        self.state = slam_step(
            self.cfg, self.state, scan.to(self.device), odom_delta.to(self.device),
            quality, None if noise is None else noise.to(self.device), self.generator,
        )
        self.trajectory.append(self.state.pose)
        return self.state.pose

    def _maybe_grow(self, scan: LaserScan) -> None:
        """Grow the map to hold the scan's valid endpoints seen from the
        current pose, as the reference does before its step. Containment is
        one bool read from the device; growth reads the points' extent."""
        pts = apply_pose(self.state.pose, scan_points(scan))
        gm = self.state.gm
        if bool(gridlib.contains(gm, pts, scan.valid)):
            return
        grown = gridlib.grow_to_contain(gm, self.cfg.cell_model, pts[scan.valid])
        pyramid = self.state.pyramid
        if pyramid and grown.cells.shape != gm.cells.shape:
            mcfg = self.cfg.matcher_cfg
            pyramid = m3rsmlib.build_pyramid(scoring.MapView.of(grown, self.cfg.cell_model),
                                             mcfg.levels, mcfg.scoring.unknown_prob)
        self.state = dataclasses.replace(self.state, gm=grown, pyramid=pyramid)

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
        if self.cfg.map_storage == "tiled":
            return blockmap.occupancy_plane(self.state.gm, self.cfg.cell_model)
        return gridlib.occupancy_plane(self.state.gm, self.cfg.cell_model)

    @property
    def pose(self) -> Tensor:
        return self.state.pose
