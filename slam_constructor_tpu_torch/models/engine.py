"""The SLAM engine as a step function over tensor state (port of
``slam_constructor_tpu.models.engine``).

``slam_step(cfg, state, scan, odom) -> state`` matches the scan from the
odometry prior and inserts it at the matched pose. It never syncs with the
host: no ``.item()``, no Python branch on a tensor, no boolean-mask
indexing, so a whole sequence queues on the device. ``run_sequence`` is a
Python loop over scans that stay on the device (the reference runs it in
``lax.scan``). The state holds the reference's threefry key
(``SlamState.key``): a step splits it as the reference does and draws the
matcher's normals from it, with the next key, in one launch of
``kernels.prng_draws``; a caller may inject the normals instead.

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
import functools
from typing import Any

import torch

from ..device import resolve_device
from ..ops import blockmap
from ..ops import cells as cellslib
from ..ops import grid as gridlib
from ..ops import kernels, prng
from ..ops import m3rsm as m3rsmlib
from ..ops import matchers as matcherslib
from ..ops import raycast, scoring
from ..ops.geometry import apply_pose, compose
from ..ops.scan import LaserScan, scan_points

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
    key: Tensor  # uint32[2], the reference's threefry key
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
    # the jitted reference's world_to_cell: a product with the reciprocal
    rel = gridlib.cell_coord(pose[:2] - gm.origin, gm.scale)
    center = torch.floor(rel.flip(-1)).to(torch.int64)  # (row, col)
    return m3rsmlib.update_pyramid(pyramid, view, unknown, center, size, gate)


def init_state(cfg: EngineConfig, device=None, key: Tensor | None = None) -> SlamState:
    """A fresh state on ``device`` (the card when none is named) holding
    ``key`` (the reference's default ``PRNGKey(0)`` when None); with the
    M3RSM matcher its pyramid built and the search's constants made."""
    dev = resolve_device(device)
    key = prng.key(0, dev) if key is None else key.to(dev)
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
        key=key,
        step=torch.zeros((), dtype=torch.int32, device=dev),
        last_prob=torch.zeros((), dtype=torch.float32, device=dev),
        pyramid=pyramid,
    )


def _point_weights(cfg: EngineConfig, scan: LaserScan) -> Tensor | None:
    """vinySLAM's degeneracy weighting: points on over-represented wall
    directions (long straight walls) are down-weighted. A point's direction
    is its local wall tangent, the direction of the consecutive-endpoint
    difference, not its bearing. One launch of ``kernels.beam_weights`` on
    the card; its plain version ``scan.point_weights_ref`` elsewhere."""
    if not cfg.use_angle_histogram:
        return None
    return kernels.beam_weights(scan.ranges, scan.bearings, scan.valid)


def _refine_cfg(cfg: EngineConfig):
    refine_cls, refine_fn = matcherslib.MATCHERS[cfg.refine_matcher]
    return (cfg.refine_cfg if cfg.refine_cfg is not None else refine_cls()), refine_fn


def _refine(cfg: EngineConfig, view, scan, res, pw, noise):
    """The optional second matcher from the primary match's pose. Hill
    climbing and gradient ascent keep the start pose unless the score
    improves. A Monte-Carlo refine gets ``noise``: the normals of the
    primary match's key, as the reference hands both matches one key."""
    if cfg.refine_matcher is None:
        return res
    rcfg, refine_fn = _refine_cfg(cfg)
    return refine_fn(view, scan, res.pose, None, rcfg, pw, noise)


def _mc_cfg(matcher, mcfg):
    return mcfg if matcher == "monte_carlo" else None


#: the next key alone, when the normals are handed in
_NEXT_KEY = (prng.Draw((0,), "key"),)


@functools.lru_cache(maxsize=64)
def _step_draws(cfg: EngineConfig):
    """(the step's plan, the position of the match's normals, of the
    refine's): a Monte-Carlo match or refine draws from ``sub``; a refine
    of the match's shape takes the match's normals (the same key)."""
    mc = [_mc_cfg(cfg.matcher, cfg.matcher_cfg),
          _mc_cfg(cfg.refine_matcher, _refine_cfg(cfg)[0]) if cfg.refine_matcher else None]
    shared = (mc[0] is not None and mc[1] is not None
              and (mc[0].rounds, mc[0].batch) == (mc[1].rounds, mc[1].batch))
    plan, where = list(_NEXT_KEY), []
    for m in (mc[0], None if shared else mc[1]):
        where.append(len(plan) if m is not None else None)
        if m is not None:
            plan.extend(matcherslib.noise_plan(m, (1,)))
    return tuple(plan), where[0], where[0] if shared else where[1]


def step_plan(cfg: EngineConfig) -> tuple:
    """A step's draws as ``prng.Draw``s, as the reference's step draws
    them (``key, sub = split(key)``; a Monte-Carlo match and refine draw
    from ``sub``): the next key, then the match's normals and the
    refine's, each where its matcher draws."""
    return _step_draws(cfg)[0]


@functools.lru_cache(maxsize=64)
def keyed_match(cfg: EngineConfig) -> bool:
    """Whether the step's Monte-Carlo match draws its own numbers from the
    step's key inside its launch (``monte_carlo_match(..., step_key=)``),
    so the step issues no ``prng_draws``: a Monte-Carlo match with no
    Monte-Carlo refine (which would take the match's normals)."""
    return cfg.matcher == "monte_carlo" and _step_draws(cfg)[2] is None


def draw_step(cfg: EngineConfig, key: Tensor, noise: Tensor | None = None):
    """A step's random numbers from the state's ``key`` (:func:`step_plan`):
    (next key, the match's normals, the refine's normals), in one launch of
    ``kernels.prng_draws``. With ``noise`` handed in, the next key alone is
    drawn and both matches take ``noise``."""
    if noise is not None:
        return kernels.prng_draws(key, _NEXT_KEY)[0], noise, noise
    plan, m, r = _step_draws(cfg)
    out = kernels.prng_draws(key, plan)
    return out[0], None if m is None else out[m], None if r is None else out[r]


def slam_step(
    cfg: EngineConfig,
    state: SlamState,
    scan: LaserScan,
    odom_delta: Tensor,
    quality: float = 1.0,
    noise: Tensor | None = None,
) -> SlamState:
    """One scan: match from ``state.pose ⊕ odom_delta`` (then refine), then
    insert.

    ``quality`` scales this scan's observation weight. ``noise`` f32[rounds,
    batch, 3] injects the matcher's standard normals; otherwise they come
    from the state's key, which the step advances either way: a
    Monte-Carlo match without a Monte-Carlo refine draws them inside its
    own launch (:func:`keyed_match`), any other step in one launch of
    ``kernels.prng_draws`` (:func:`draw_step`). The M3RSM matcher matches against the state's
    pyramid and draws nothing; the returned state holds new planes. On the
    tiled map the match runs on the ``window_tiles`` window around the
    prior, and the insert allocates tiles in the pool.
    """
    _, match_fn = matcherslib.MATCHERS[cfg.matcher]
    pw = _point_weights(cfg, scan)
    keyed = noise is None and keyed_match(cfg)
    if keyed:  # the match draws from the step's key and returns the next one
        key, refine_noise, draws = None, None, {"step_key": state.key}
    else:
        (key, noise, refine_noise), draws = draw_step(cfg, state.key, noise), {}
    if cfg.map_storage == "tiled":
        prior = compose(state.pose, odom_delta)
        window = blockmap.extract_window(
            state.gm, cfg.cell_model, prior[:2], cfg.window_tiles, cfg.window_tiles)
        view = scoring.MapView.of(window, cfg.cell_model)
        res = match_fn(view, scan, prior, None, cfg.matcher_cfg, pw, noise, **draws)
        key = res.next_key if keyed else key
        res = _refine(cfg, view, scan, res, pw, refine_noise)
        do_insert = (res.prob >= cfg.min_insert_prob) | (state.step == 0)
        # q = 0 (gated) leaves zero-weight samples: no tile allocated, no fold
        q = torch.where(do_insert, quality, 0.0)
        gm = blockmap.insert_scan(state.gm, cfg.cell_model, res.pose, scan, cfg.beam, q)
        return SlamState(gm=gm, pose=res.pose, key=key, step=state.step + 1,
                         last_prob=res.prob)

    view = scoring.MapView.of(state.gm, cfg.cell_model)
    pyramid = state.pyramid if _uses_pyramid(cfg) else ()
    live = {"pyramid": pyramid} if pyramid else {}
    # one prior-centred window a match (M3RSM windows its own pyramid)
    windowed = cfg.match_window and not _uses_pyramid(cfg)
    if not windowed and cfg.matcher in matcherslib.ODOMETRY_MATCHERS:
        # the match's launch composes the prior and takes the scan's points
        res = match_fn(view, scan, state.pose, None, cfg.matcher_cfg, pw, noise,
                       odom=odom_delta, **draws)
    else:
        prior = compose(state.pose, odom_delta)
        if windowed:
            view = scoring.window_view(view, prior[:2], cfg.match_window)
        res = match_fn(view, scan, prior, None, cfg.matcher_cfg, pw, noise, **live, **draws)
    key = res.next_key if keyed else key
    res = _refine(cfg, view, scan, res, pw, refine_noise)
    do_insert = (res.prob >= cfg.min_insert_prob) | (state.step == 0)
    q = torch.where(do_insert, quality, 0.0)
    # the rasterisation and the fold in one call: K3 on the card
    gm = raycast.insert_scan(state.gm, cfg.cell_model, res.pose, scan, cfg.beam, q)
    if pyramid:
        # refreshed only where the insert changed cells (q > 0)
        pyramid = _refresh_pyramid(cfg, gm, res.pose, pyramid, q)
    return SlamState(gm=gm, pose=res.pose, key=key, step=state.step + 1, last_prob=res.prob,
                     pyramid=pyramid)


def run_sequence(
    cfg: EngineConfig,
    state: SlamState,
    scans: LaserScan,
    odom: Tensor,
    noise: Tensor | None = None,
):
    """Run a batched sequence ``scans`` [T, R], ``odom`` f32[T, 3] on the
    state's device. ``noise`` optionally holds f32[T, rounds, batch, 3].
    Returns (final_state, trajectory f32[T, 3], probs f32[T])."""
    poses, probs = [], []
    for i in range(len(scans)):
        state = slam_step(
            cfg, state, scans[i], odom[i],
            noise=None if noise is None else noise[i],
        )
        poses.append(state.pose)
        probs.append(state.last_prob)
    return state, torch.stack(poses), torch.stack(probs)


class Engine:
    """Host-side front end: owns config, state (with its key) and device;
    feeds scans and exposes map and trajectory. ``key`` is the reference's
    ``key=`` (a uint32[2] threefry key); ``seed=s`` without one means the
    reference's ``PRNGKey(s)``."""

    def __init__(self, cfg: EngineConfig, device=None, seed: int = 0, key: Tensor | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = init_state(cfg, self.device, prng.key(seed) if key is None else key)
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
            quality, None if noise is None else noise.to(self.device),
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
            None if noise is None else noise.to(self.device),
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
