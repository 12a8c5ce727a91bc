"""Keyframe pose graph with loop closure and an SE(2) Gauss-Newton solve
(port of ``slam_constructor_tpu.models.posegraph``).

- A keyframe store of fixed capacity: poses, scans, a chain of odometric
  edges, and loop-closure edges appended to the same edge table. A write at
  capacity is dropped, never clipped onto the last slot, and latches
  ``kf_overflow`` / ``edge_overflow``; :func:`grow` pads the store.
- Loop detection renders a small submap around each candidate old keyframe
  and brute-force matches the new scan against it. All the matches of a
  keyframe batch (B keyframes x ``max_candidates`` submaps) are rasterised
  by one call of ``raycast.scan_observation_planes_batched`` (one launch of
  K3 without the fold, ``kernels.scan_planes``) and scored by one launch of
  ``kernels.overlap_score_batched``; the information estimate is one more
  launch.
- The solver is Gauss-Newton on relative-pose residuals ``e = [R(th_i)^T
  (t_j - t_i) - z_t, wrap(th_j - th_i - z_th)]`` with dense ``[3K, 3K]``
  normal equations (unused DOFs and the anchored keyframe 0 get identity
  rows), assembled as a dense product in a fixed order so that two runs give
  the same bits, and solved by Cholesky in f32 (the package turns TF32 off
  when it is imported).

Every function works on device tensors and none reads a value back to the
host, except where its docstring says so. The reference's ``lax.cond`` and
``mode='drop'`` become masks.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..device import resolve_device
from ..ops import grid as gridlib
from ..ops import m3rsm as m3rsmlib  # noqa: F401  (registers 'm3rsm')
from ..ops import matchers as matcherslib
from ..ops import libm, raycast, scoring
from ..ops.geometry import between, pose_distance, wrap_angle
from ..ops.scan import LaserScan

Tensor = torch.Tensor

#: why the Monte-Carlo matcher is refused where the reference hands its
#: matcher no key (``_match_loop`` and ``joint_refine`` pass ``key=None``)
_MONTE_CARLO_KEYLESS = (
    "the Monte-Carlo matcher as {where}: the reference passes key=None to its matcher there, "
    "and its monte_carlo_match raises on it (jax.random.split(None, n): TypeError, unexpected "
    "PRNG key type); the port refuses it as well")


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    max_keyframes: int = 128
    max_edges: int = 512
    #: add a keyframe when the robot moved this far from the last one
    keyframe_distance: float = 0.5
    keyframe_angle_weight: float = 1.0
    #: loop closure: candidate keyframes within this radius, at least
    #: ``min_index_gap`` keyframes older, matched above ``min_prob``
    loop_radius: float = 2.0
    min_index_gap: int = 10
    min_prob: float = 0.65
    #: reject loop matches that imply a pose correction larger than this
    #: (corridors give high-scoring matches at wrong translations)
    max_loop_correction_xy: float = 1.5
    max_loop_correction_theta: float = 0.5
    #: most loop candidates scored per keyframe
    max_candidates: int = 8
    #: local map rendered around an old keyframe for loop matching
    local_map_size: int = 96
    local_map_scale: float = 0.1
    #: render the candidate keyframe's scan plus +-submap_radius neighbour
    #: keyframes into the local map
    submap_radius: int = 1
    #: matcher that refines a loop closure's relative pose: 'brute_force',
    #: 'm3rsm', 'hill_climbing' or 'gradient', with that matcher's config
    #: as ``loop_matcher`` (``m3rsm.M3RSMConfig``, ``HillClimbingConfig``,
    #: ``GradientConfig``); M submaps in one launch a stage
    loop_matcher_kind: str = "brute_force"
    loop_matcher: Any = matcherslib.BruteForceConfig(
        half_x=0.6, half_y=0.6, half_theta=0.3, n_x=7, n_y=7, n_theta=7,
        scoring=scoring.ScoringConfig(reducer="overlap", stride=2),
    )
    #: opt-in parabolic sub-cell refinement of every loop match, bounded to
    #: half a grid step per axis
    loop_subcell_refine: bool = False
    #: information (inverse covariance) diagonals of the two edge types
    odom_info: tuple = (100.0, 100.0, 400.0)
    loop_info: tuple = (50.0, 50.0, 200.0)
    gn_iterations: int = 10
    gn_damping: float = 1e-4
    #: Huber threshold on a loop edge's chi (square root of the weighted
    #: squared residual); <= 0 disables
    huber_delta: float = 0.3
    #: estimate a loop edge's information from the curvature of the match
    #: score instead of the fixed ``loop_info``
    estimate_loop_info: bool = True
    #: the estimate is clipped to [0.1, loop_info_cap] x ``loop_info``
    loop_info_cap: float = 1.0

    def __post_init__(self):
        if self.loop_matcher_kind == "monte_carlo":
            raise NotImplementedError(_MONTE_CARLO_KEYLESS.format(where="loop_matcher_kind"))
        if self.loop_matcher_kind not in matcherslib.MATCHERS:
            raise ValueError(f"PoseGraphConfig.loop_matcher_kind={self.loop_matcher_kind!r}: "
                             f"not one of {sorted(matcherslib.MATCHERS)}")
        if self.loop_matcher_kind == "m3rsm" and self.loop_subcell_refine:
            # the reference falls back to one cell / 0.05 rad for a matcher
            # without a grid pitch (its posegraph.py:452), a step ADVICE r5
            # finds wrong; the port does not copy it
            raise NotImplementedError(
                "loop_subcell_refine with the M3RSM loop matcher is not ported: the reference's "
                "grid-pitch fallback for it is a known fault"
            )


@dataclasses.dataclass
class PoseGraphState:
    kf_poses: Tensor  # f32[K, 3] current estimates
    kf_scans: LaserScan  # stacked [K, R]
    n_kf: Tensor  # i32[]
    edge_i: Tensor  # i32[E]
    edge_j: Tensor  # i32[E]
    edge_delta: Tensor  # f32[E, 3] measured j in i's frame
    edge_info: Tensor  # f32[E, 3] diagonal information
    edge_is_loop: Tensor  # bool[E] loop-closure edge (the robust kernel's scope)
    n_edges: Tensor  # i32[]
    #: index of the last added keyframe (the tracking chain's tail)
    last_kf: Tensor  # i32[]
    #: sticky capacity flags: set when a keyframe or an edge was dropped at
    #: capacity; the host polls them and calls :func:`grow`
    kf_overflow: Tensor  # bool[]
    edge_overflow: Tensor  # bool[]

    @property
    def device(self) -> torch.device:
        return self.kf_poses.device


def init_state(cfg: PoseGraphConfig, n_beams: int, device=None) -> PoseGraphState:
    """An empty graph on ``device`` (the card when none is named)."""
    dev = resolve_device(device)
    k, e = cfg.max_keyframes, cfg.max_edges

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return PoseGraphState(
        kf_poses=zeros((k, 3)),
        kf_scans=LaserScan(
            ranges=zeros((k, n_beams)), bearings=zeros((k, n_beams)),
            valid=zeros((k, n_beams), torch.bool),
        ),
        n_kf=zeros((), torch.int32),
        edge_i=zeros((e,), torch.int32),
        edge_j=zeros((e,), torch.int32),
        edge_delta=zeros((e, 3)),
        edge_info=zeros((e, 3)),
        edge_is_loop=zeros((e,), torch.bool),
        n_edges=zeros((), torch.int32),
        last_kf=torch.full((), -1, dtype=torch.int32, device=dev),
        kf_overflow=zeros((), torch.bool),
        edge_overflow=zeros((), torch.bool),
    )


def grow(
    cfg: PoseGraphConfig,
    st: PoseGraphState,
    max_keyframes: int | None = None,
    max_edges: int | None = None,
):
    """Host-side capacity growth: pad the keyframe and edge arrays to the new
    capacities (2x by default), clear the overflow flags, and return
    ``(new_cfg, new_state)``."""
    new_k = max_keyframes if max_keyframes is not None else 2 * cfg.max_keyframes
    new_e = max_edges if max_edges is not None else 2 * cfg.max_edges
    assert new_k >= cfg.max_keyframes and new_e >= cfg.max_edges

    def pad0(a, n):
        return torch.cat([a, torch.zeros((n - a.shape[0], *a.shape[1:]), dtype=a.dtype,
                                         device=a.device)])

    new_st = dataclasses.replace(
        st,
        kf_poses=pad0(st.kf_poses, new_k),
        kf_scans=LaserScan(
            pad0(st.kf_scans.ranges, new_k), pad0(st.kf_scans.bearings, new_k),
            pad0(st.kf_scans.valid, new_k),
        ),
        edge_i=pad0(st.edge_i, new_e),
        edge_j=pad0(st.edge_j, new_e),
        edge_delta=pad0(st.edge_delta, new_e),
        edge_info=pad0(st.edge_info, new_e),
        edge_is_loop=pad0(st.edge_is_loop, new_e),
        kf_overflow=torch.zeros_like(st.kf_overflow),
        edge_overflow=torch.zeros_like(st.edge_overflow),
    )
    return dataclasses.replace(cfg, max_keyframes=new_k, max_edges=new_e), new_st


def should_add_keyframe(cfg: PoseGraphConfig, st: PoseGraphState, pose: Tensor) -> Tensor:
    no_kf = st.n_kf == 0
    last = st.kf_poses.index_select(0, torch.clamp(st.last_kf, min=0).long()[None])[0]
    far = pose_distance(last, pose, cfg.keyframe_angle_weight) > cfg.keyframe_distance
    return no_kf | far


# --- masked writes ------------------------------------------------------------


def _exclusive_count(mask: Tensor) -> Tensor:
    """i64[N]: how many of ``mask`` are set before each position."""
    m = mask.to(torch.int64)
    return torch.cumsum(m, 0) - m


def _write_rows(buf: Tensor, slot: Tensor, rows: Tensor) -> Tensor:
    """``buf`` with ``rows[n]`` written to row ``slot[n]``; a slot at or
    beyond the capacity is dropped (the reference's ``mode='drop'``). Slots
    in range are distinct."""
    cap = buf.shape[0]
    padded = torch.cat([buf, torch.zeros((1, *buf.shape[1:]), dtype=buf.dtype, device=buf.device)])
    # every dropped row lands on the spare last one, which is cut off again
    padded.index_copy_(0, torch.clamp(slot, max=cap), rows.to(buf.dtype))
    return padded[:cap]


def _append_edges(
    st: PoseGraphState, i: Tensor, j: Tensor, delta: Tensor, info: Tensor, is_loop: Tensor,
    take: Tensor,
) -> PoseGraphState:
    """Append, in order, the edges of ``take`` bool[N] (i, j int[N], delta
    and info f32[N, 3], is_loop bool[N]): what N calls of
    :func:`_append_edge` under a condition give. Edges past the capacity are
    dropped and latch ``edge_overflow``."""
    cap = st.edge_i.shape[0]
    pos = st.n_edges.to(torch.int64) + _exclusive_count(take)
    slot = torch.where(take, pos, cap)
    return dataclasses.replace(
        st,
        edge_i=_write_rows(st.edge_i, slot, i),
        edge_j=_write_rows(st.edge_j, slot, j),
        edge_delta=_write_rows(st.edge_delta, slot, delta),
        edge_info=_write_rows(st.edge_info, slot, info),
        edge_is_loop=_write_rows(st.edge_is_loop, slot, is_loop),
        n_edges=torch.clamp(st.n_edges + take.sum().to(torch.int32), max=cap),
        edge_overflow=st.edge_overflow | (take & (pos >= cap)).any(),
    )


def _append_edge(st: PoseGraphState, i, j, delta, info, is_loop=False) -> PoseGraphState:
    """Append one edge; at capacity the write is dropped, not clipped onto
    the last slot. ``i`` and ``j`` are ints or integer tensors."""
    dev = st.device
    return _append_edges(
        st,
        torch.as_tensor(i, device=dev).reshape(1),
        torch.as_tensor(j, device=dev).reshape(1),
        delta.reshape(1, 3),
        torch.as_tensor(info, dtype=torch.float32, device=dev).reshape(1, 3),
        torch.as_tensor(is_loop, dtype=torch.bool, device=dev).reshape(1),
        torch.ones((1,), dtype=torch.bool, device=dev),
    )


def _place_keyframes(cfg: PoseGraphConfig, st: PoseGraphState, scans: LaserScan, poses: Tensor,
                     valid: Tensor):
    """Store the keyframes of ``valid`` bool[B] in order, as B conditional
    ``add_keyframe`` calls would, without their edges. Returns the new state
    and, per keyframe, its index i64[B], whether it was placed bool[B] (not
    dropped at capacity) and its chain predecessor i64[B] (-1: none)."""
    cap = cfg.max_keyframes
    n0 = st.n_kf.to(torch.int64)
    # the store fills in order: a valid keyframe is dropped once n0 + (valid
    # ones before it) reaches the capacity
    placed = valid & (n0 + _exclusive_count(valid) < cap)
    before = _exclusive_count(placed)
    kf_idx = n0 + before
    prev = torch.where(before > 0, kf_idx - 1, st.last_kf.to(torch.int64))
    slot = torch.where(placed, kf_idx, cap)
    n_placed = placed.sum()
    new = dataclasses.replace(
        st,
        kf_poses=_write_rows(st.kf_poses, slot, poses),
        kf_scans=LaserScan(
            _write_rows(st.kf_scans.ranges, slot, scans.ranges),
            _write_rows(st.kf_scans.bearings, slot, scans.bearings),
            _write_rows(st.kf_scans.valid, slot, scans.valid),
        ),
        n_kf=(n0 + n_placed).to(torch.int32),
        kf_overflow=st.kf_overflow | (valid & ~placed).any(),
        last_kf=torch.where(n_placed > 0, n0 + n_placed - 1, st.last_kf.to(torch.int64)).to(
            torch.int32),
    )
    return new, kf_idx, placed, prev


def _odom_edges(cfg: PoseGraphConfig, st: PoseGraphState, kf_idx, placed, prev, poses):
    """The chain edges of a placed batch: (i, j, delta, info, is_loop, take)
    with a leading [B]."""
    dev = st.device
    delta = between(st.kf_poses.index_select(0, torch.clamp(prev, min=0)), poses)
    info = torch.tensor(cfg.odom_info, dtype=torch.float32, device=dev).expand(poses.shape[0], 3)
    return (prev, kf_idx, delta, info, torch.zeros_like(placed), placed & (prev >= 0))


def add_keyframe(
    cfg: PoseGraphConfig, st: PoseGraphState, pose: Tensor, scan: LaserScan
) -> PoseGraphState:
    """Unconditionally append a keyframe and its odometric chain edge
    (callers gate with :func:`should_add_keyframe`). At capacity the keyframe
    is dropped and ``kf_overflow`` latches, so that the host can
    :func:`grow` and add it again."""
    one = torch.ones((1,), dtype=torch.bool, device=st.device)
    new, kf_idx, placed, prev = _place_keyframes(cfg, st, scan[None], pose[None], one)
    return _append_edges(new, *_odom_edges(cfg, new, kf_idx, placed, prev, pose[None]))


def process_keyframes(
    cfg: PoseGraphConfig,
    model,
    st: PoseGraphState,
    scans: LaserScan,  # stacked [B, R]
    poses: Tensor,  # f32[B, 3]
    valid: Tensor,  # bool[B] padding mask
):
    """Add a batch of keyframes and detect their loops.

    When the batch is no wider than ``min_index_gap`` (and the submap radius
    lies below the gap), detection across the batch is independent: keyframe
    b's candidate filter ``idx <= kf_idx_b - min_index_gap`` leaves out every
    keyframe of the same batch. Then the keyframes are placed first, every
    match of the batch runs in one rasterisation and one score launch, and
    the edges are appended in the order the sequential loop would give:
    odometric edge, then loop edges, keyframe by keyframe. Wider batches go
    keyframe by keyframe. A keyframe dropped at capacity detects no loops.
    Returns ``(graph, new loops i64[])``.
    """
    b = poses.shape[0]
    if b <= cfg.min_index_gap and cfg.submap_radius < cfg.min_index_gap:
        return _process_keyframes_batched(cfg, model, st, scans, poses, valid)
    total = torch.zeros((), dtype=torch.int64, device=st.device)
    for i in range(b):
        st, n = _process_keyframes_batched(
            cfg, model, st, scans[i:i + 1], poses[i:i + 1], valid[i:i + 1])
        total = total + n
    return st, total


def _process_keyframes_batched(cfg, model, st, scans, poses, valid):
    """Place the keyframes (writes only), detect over the whole batch (reads
    only), append the edges in the sequential order (writes only)."""
    st2, kf_idx, placed, prev = _place_keyframes(cfg, st, scans, poses, valid)
    cand, accept, poses_m, infos = _detect_candidates(cfg, model, st2, scans, poses, kf_idx)
    accept = accept & placed[:, None]
    # per keyframe: its odometric edge, then its accepted loop edges
    o_i, o_j, o_delta, o_info, o_loop, o_take = _odom_edges(cfg, st2, kf_idx, placed, prev, poses)
    l_delta = between(st2.kf_poses[cand], poses_m)  # [B, C, 3]

    def rows(odom, loop):  # [B, ...], [B, C, ...] -> [B * (1 + C), ...]
        return torch.cat([odom[:, None], loop], dim=1).flatten(0, 1)

    st3 = _append_edges(
        st2,
        rows(o_i, cand), rows(o_j, kf_idx[:, None].expand_as(cand)), rows(o_delta, l_delta),
        rows(o_info, infos), rows(o_loop, torch.ones_like(accept)), rows(o_take, accept),
    )
    return st3, accept.sum()


# --- loop closure -------------------------------------------------------------


def _render_local_maps(cfg: PoseGraphConfig, model, st: PoseGraphState, ci: Tensor):
    """Submaps around the keyframes ``ci`` i64[M]: each keyframe's scan plus
    its +-``submap_radius`` neighbours, inserted at their current pose
    estimates. Returns a batched ``GridMap`` (cells f32[M, n, n, C], origin
    f32[M, 2]).

    For cell models whose fold is additive (``fold_additive``: BayesAvg) all
    M x (2 radius + 1) scans are rasterised by one call, summed into their
    submap's planes, and folded once; other models (TBM) keep the serial
    chain of inserts, each step one ``raycast.insert_scan_windows`` call
    over the M submaps at once (K3's fold of P maps). Samples that fall off
    a submap are dropped."""
    n, scale = cfg.local_map_size, cfg.local_map_scale
    dev = st.device
    m = ci.shape[0]
    center = st.kf_poses[ci]
    origin = center[:, :2] - n * scale / 2.0
    fresh = gridlib.make_grid_map(model, n, n, scale, device=dev).cells
    gm = gridlib.GridMap(cells=fresh[None].expand(m, *fresh.shape), origin=origin, scale=scale)
    beam = raycast.BeamConfig(wall_blur=True)
    span = 2 * cfg.submap_radius + 1

    idx = ci[:, None] + torch.arange(span, device=dev) - cfg.submap_radius  # [M, span]
    ok = (idx >= 0) & (idx < st.n_kf)
    idx_c = torch.clamp(idx, 0, cfg.max_keyframes - 1)
    nb_scans = LaserScan(
        st.kf_scans.ranges[idx_c], st.kf_scans.bearings[idx_c],
        st.kf_scans.valid[idx_c] & ok[..., None],
    )  # [M, span, R]
    nb_poses = st.kf_poses[idx_c]  # [M, span, 3]

    if getattr(model, "fold_additive", False):
        flat = LaserScan(nb_scans.ranges.flatten(0, 1), nb_scans.bearings.flatten(0, 1),
                         nb_scans.valid.flatten(0, 1))
        plane_of = torch.arange(m, device=dev).repeat_interleave(span)
        w_all, s_all = raycast.scan_observation_planes_batched(
            origin[plane_of], n, n, scale, nb_poses.flatten(0, 1), flat, beam, plane_of, m)
        return gridlib.apply_observations(gm, model, w_all, s_all)
    for k in range(span):
        gm = raycast.insert_scan_windows(gm, model, nb_poses[:, k], nb_scans[:, k], beam)
    return gm


def _render_local_map(cfg: PoseGraphConfig, model, st: PoseGraphState, ci) -> gridlib.GridMap:
    """The submap around keyframe ``ci`` (an int or an integer tensor)."""
    gm = _render_local_maps(cfg, model, st, torch.as_tensor(ci, device=st.device).reshape(1).long())
    return gridlib.GridMap(cells=gm.cells[0], origin=gm.origin[0], scale=gm.scale)


def _match_loop(cfg: PoseGraphConfig, view, scan, pose):
    """The loop-closure match shared by :func:`detect_loops` and
    :func:`densify_loops`: the configured matcher (the brute-force grid,
    M3RSM with a pyramid a submap, the hill climb or the gradient ascent),
    then (opt-in, not with M3RSM) a per-axis parabolic peak fit through the
    score at the matched pose and its +-1-grid-step neighbours (one cell and
    0.05 rad for a matcher without a grid), bounded to half a step per axis,
    then the information estimate at the refined pose. ``view``, ``scan``
    and ``pose`` may carry a leading map dimension: M matches, one launch of
    each stage.
    Returns ``(pose, prob, info)``."""
    dev = pose.device
    _, loop_match_fn = matcherslib.MATCHERS[cfg.loop_matcher_kind]
    res = loop_match_fn(view, scan, pose, None, cfg.loop_matcher)
    matched = res.pose
    if cfg.loop_subcell_refine:
        lm = cfg.loop_matcher
        # the grid's pitches; a matcher without a grid (hill climbing,
        # gradient) falls back to one cell and 0.05 rad, as the reference
        sx = 2.0 * getattr(lm, "half_x", 0.0) / max(
            getattr(lm, "n_x", 1) - 1, 1) or cfg.local_map_scale
        sy = 2.0 * getattr(lm, "half_y", 0.0) / max(
            getattr(lm, "n_y", 1) - 1, 1) or cfg.local_map_scale
        st_ = 2.0 * getattr(lm, "half_theta", 0.0) / max(
            getattr(lm, "n_theta", 1) - 1, 1) or 0.05
        offs = torch.tensor(
            [
                [0.0, 0.0, 0.0],
                [-sx, 0.0, 0.0], [sx, 0.0, 0.0],
                [0.0, -sy, 0.0], [0.0, sy, 0.0],
                [0.0, 0.0, -st_], [0.0, 0.0, st_],
            ],
            dtype=torch.float32, device=dev,
        )
        probs7 = scoring.score_poses(view, scan, matched[..., None, :] + offs, lm.scoring)

        def peak(sm, s0, sp, step):
            denom = sm + sp - 2.0 * s0
            t = 0.5 * (sm - sp) / torch.where(torch.abs(denom) < 1e-12, torch.inf, denom)
            # move only toward a concave peak; flat or convex stays put
            return torch.where(denom < 0, torch.clamp(t, -0.5, 0.5) * step, 0.0)

        matched = matched + torch.stack([
            peak(probs7[..., 1], probs7[..., 0], probs7[..., 2], sx),
            peak(probs7[..., 3], probs7[..., 0], probs7[..., 4], sy),
            peak(probs7[..., 5], probs7[..., 0], probs7[..., 6], st_),
        ], dim=-1)
    base = torch.tensor(cfg.loop_info, dtype=torch.float32, device=dev)
    if cfg.estimate_loop_info:
        info = scoring.estimate_information(view, scan, matched, cfg.loop_matcher.scoring)
        info = torch.clamp(info, min=0.1 * base, max=cfg.loop_info_cap * base)
    else:
        info = base.expand(matched.shape)
    return matched, res.prob, info


def _norm2(v: Tensor) -> Tensor:
    """Euclidean norm over the last axis as ``sqrt(sum(v^2))``, the
    reference's arithmetic."""
    return libm.sqrt((v * v).sum(-1), inplace=True)


def _correction_ok(cfg: PoseGraphConfig, corr: Tensor) -> Tensor:
    """The perceptual-aliasing gate: a matched pose must stay near the
    current estimate; high-scoring matches at wrong translations fail."""
    return (_norm2(corr[..., :2]) <= cfg.max_loop_correction_xy) & (
        torch.abs(wrap_angle(corr[..., 2])) <= cfg.max_loop_correction_theta
    )


def _repeat_scan(scans: LaserScan, c: int) -> LaserScan:
    """[B, R] -> [B * c, R]: every scan c times in a row."""
    return LaserScan(*(a.repeat_interleave(c, dim=0) for a in
                       (scans.ranges, scans.bearings, scans.valid)))


def _detect_candidates(
    cfg: PoseGraphConfig, model, st: PoseGraphState, scan: LaserScan, pose: Tensor, kf_idx,
):
    """The compute half of :func:`detect_loops`: pick candidates, match,
    gate; no state is written. ``scan`` [R], ``pose`` f32[3] and ``kf_idx``
    describe one keyframe, or [B, R], f32[B, 3] and int[B] a batch. Returns
    ``(cand, accept, poses_m, infos)`` with a leading ``[C]`` or ``[B, C]``.

    It reads only keyframes with index <= kf_idx - min_index_gap, all older
    than ``kf_idx``: that is what makes the detection of a whole batch
    exact (:func:`process_keyframes`)."""
    if pose.dim() == 1:
        out = _detect_candidates(
            cfg, model, st, scan[None], pose[None],
            torch.as_tensor(kf_idx, device=st.device).reshape(1))
        return tuple(o[0] for o in out)
    b = pose.shape[0]
    idxs = torch.arange(cfg.max_keyframes, device=st.device)
    dist = _norm2(st.kf_poses[None, :, :2] - pose[:, None, :2])  # [B, K]
    ok = (
        (idxs < st.n_kf)
        & (idxs <= kf_idx[:, None] - cfg.min_index_gap)
        & (dist < cfg.loop_radius)
    )
    # the closest max_candidates; equal keys (the infs) keep index order
    order = torch.argsort(torch.where(ok, dist, torch.inf), dim=-1, stable=True)
    cand = order[:, : cfg.max_candidates]
    c = cand.shape[1]
    cand_ok = torch.gather(ok, 1, cand)

    gm = _render_local_maps(cfg, model, st, cand.reshape(-1))
    view = scoring.MapView.of(gm, model)
    poses_m, probs, infos = _match_loop(
        cfg, view, _repeat_scan(scan, c), pose.repeat_interleave(c, dim=0))
    poses_m, probs, infos = poses_m.reshape(b, c, 3), probs.reshape(b, c), infos.reshape(b, c, 3)
    accept = cand_ok & (probs > cfg.min_prob) & _correction_ok(cfg, poses_m - pose[:, None, :])
    return cand, accept, poses_m, infos


def _append_loop_edges(
    cfg: PoseGraphConfig, st: PoseGraphState, kf_idx, cand, accept, poses_m, infos,
) -> PoseGraphState:
    delta = between(st.kf_poses[cand], poses_m)
    j = torch.as_tensor(kf_idx, device=st.device).expand_as(cand)
    return _append_edges(st, cand, j, delta, infos, torch.ones_like(accept), accept)


def detect_loops(
    cfg: PoseGraphConfig, model, st: PoseGraphState, scan: LaserScan, pose: Tensor
):
    """Match the newest keyframe's scan against up to ``max_candidates`` old
    keyframes and append the accepted constraints. Returns ``(graph, new
    loops i64[])``."""
    kf_idx = st.last_kf.to(torch.int64)
    cand, accept, poses_m, infos = _detect_candidates(cfg, model, st, scan, pose, kf_idx)
    st = _append_loop_edges(cfg, st, kf_idx, cand, accept, poses_m, infos)
    return st, accept.sum()


def densify_loops(cfg: PoseGraphConfig, model, st: PoseGraphState):
    """Propose loop closures over all keyframe pairs, not just the newest.

    :func:`detect_loops` matches only the tracking tail, so a trajectory
    that closes one big loop gets constraints at its ends while keyframes in
    the middle keep their drift. This pass runs at optimize rate: for every
    keyframe j find its nearest index-distant keyframe i, drop the pairs a
    loop edge already constrains, take the ``max_candidates`` closest pairs,
    and match them as :func:`detect_loops` does, in one batch. Returns
    ``(graph, new loops i64[])``."""
    kmax = cfg.max_keyframes
    dev = st.device
    idxs = torch.arange(kmax, device=dev)
    xy = st.kf_poses[:, :2]
    dist = _norm2(xy[None, :, :] - xy[:, None, :])  # [i, j]
    in_use = idxs < st.n_kf
    pair_ok = (
        in_use[:, None]
        & in_use[None, :]
        & (idxs[:, None] <= idxs[None, :] - cfg.min_index_gap)
        & (dist < cfg.loop_radius)
    )
    # drop the pairs a loop edge already constrains (either direction)
    live = (torch.arange(st.edge_i.shape[0], device=dev) < st.n_edges) & st.edge_is_loop
    ei = torch.where(live, st.edge_i.long(), kmax)
    ej = torch.where(live, st.edge_j.long(), kmax)
    has_edge = torch.zeros((kmax + 1, kmax + 1), dtype=torch.bool, device=dev)
    has_edge[ei, ej] = True
    has_edge[ej, ei] = True
    pair_ok = pair_ok & ~has_edge[:kmax, :kmax]

    # one candidate i per j (the closest), then the closest max_candidates js
    best_i = torch.argmin(torch.where(pair_ok, dist, torch.inf), dim=0)  # [K]
    j_ok = pair_ok[best_i, idxs]
    j_dist = dist[best_i, idxs]
    order = torch.argsort(torch.where(j_ok, j_dist, torch.inf), stable=True)
    cand_j = order[: cfg.max_candidates]
    cand_i = best_i[cand_j]
    cand_ok = j_ok[cand_j]

    gm = _render_local_maps(cfg, model, st, cand_i)
    view = scoring.MapView.of(gm, model)
    pose_j = st.kf_poses[cand_j]
    scan_j = st.kf_scans[cand_j]
    poses_m, probs, infos = _match_loop(cfg, view, scan_j, pose_j)
    accept = cand_ok & (probs > cfg.min_prob) & _correction_ok(cfg, poses_m - pose_j)
    delta = between(st.kf_poses[cand_i], poses_m)
    st = _append_edges(st, cand_i, cand_j, delta, infos, torch.ones_like(accept), accept)
    return st, accept.sum()


# --- Gauss-Newton solve -------------------------------------------------------


def _edge_residual_jac(pi: Tensor, pj: Tensor, z: Tensor):
    """Residual ``[..., 3]`` and Jacobians ``[..., 3, 3]`` with respect to
    pose i and pose j of edges ``z`` between ``pi`` and ``pj``."""
    s, c = libm.sincos(pi[..., 2])
    dx, dy = pj[..., 0] - pi[..., 0], pj[..., 1] - pi[..., 1]
    e = torch.stack([
        (c * dx + s * dy) - z[..., 0],
        (-s * dx + c * dy) - z[..., 1],
        wrap_angle(pj[..., 2] - pi[..., 2] - z[..., 2]),
    ], dim=-1)
    zero, one = torch.zeros_like(c), torch.ones_like(c)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    # d(R^T dt)/dth = [[-s, c], [-c, -s]] dt
    ji = mat([[-c, -s, -s * dx + c * dy], [s, -c, -c * dx + -s * dy], [zero, zero, -one]])
    jj = mat([[c, s, zero], [-s, c, zero], [zero, zero, one]])
    return e, ji, jj


def optimize_checked(cfg: PoseGraphConfig, st: PoseGraphState):
    """Gauss-Newton over all edges with dense ``[3K, 3K]`` normal equations;
    returns the optimised state and ``info`` i32[], the largest status of
    the iterations' Cholesky factorisations (0: every one succeeded), for
    the caller to fetch with its other counters.

    Unused keyframe DOFs and keyframe 0 (the gauge anchor) get identity
    rows. The normal equations are a dense product ``A^T W A`` with the
    ``[3E, 3K]`` Jacobian ``A`` of all edges (each edge's two 3x3 blocks
    placed by one-hot factors): the blocks of neighbouring edges meet in the
    same entries, and a product sums them in a fixed order where a
    scatter-add would use atomics. The system is solved by Cholesky; nothing
    is read on the host here, so after a failed factorisation the poses are
    NaN and ``info`` says so."""
    kmax = cfg.max_keyframes
    n_dof = 3 * kmax
    dev = st.device
    n_e = st.edge_i.shape[0]
    e_mask = (torch.arange(n_e, device=dev) < st.n_edges).to(torch.float32)
    ei, ej = st.edge_i.long(), st.edge_j.long()
    oh_i = torch.nn.functional.one_hot(ei, kmax).to(torch.float32)  # [E, K]
    oh_j = torch.nn.functional.one_hot(ej, kmax).to(torch.float32)
    k_idx = torch.arange(kmax, device=dev)
    dof_used = ((k_idx < st.n_kf) & (k_idx > 0)).repeat_interleave(3)
    both_used = dof_used[:, None] & dof_used[None, :]
    diag = torch.diag(torch.where(dof_used, cfg.gn_damping, 1.0))
    delta = torch.full((n_e,), cfg.huber_delta, dtype=torch.float32, device=dev)

    poses = st.kf_poses
    info = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(cfg.gn_iterations):
        e, ji, jj = _edge_residual_jac(poses[ei], poses[ej], st.edge_delta)
        w = st.edge_info * e_mask[:, None]  # diagonal information, masked
        if cfg.huber_delta > 0:
            # Huber kernel on loop edges: w *= min(1, delta / chi)
            chi = libm.sqrt(torch.clamp((w * e * e).sum(-1), min=1e-12), inplace=True)
            rw = torch.clamp(delta / chi, max=1.0)
            w = w * torch.where(st.edge_is_loop, rw, 1.0)[:, None]
        # A[e, a, k, c]: row a of edge e, column c of keyframe k
        a = (oh_i[:, None, :, None] * ji[:, :, None, :]
             + oh_j[:, None, :, None] * jj[:, :, None, :]).reshape(3 * n_e, n_dof)
        wa = w.reshape(-1, 1) * a
        h = a.T @ wa
        b = wa.T @ e.reshape(-1)
        h = torch.where(both_used, h, 0.0) + diag
        b = torch.where(dof_used, b, 0.0)
        chol, failed = torch.linalg.cholesky_ex(h)
        info = torch.maximum(info, failed)
        dx = torch.cholesky_solve(-b[:, None], chol)[:, 0].reshape(kmax, 3)
        new = poses + dx
        poses = torch.cat([new[:, :2], wrap_angle(new[:, 2:])], dim=-1)
    return dataclasses.replace(st, kf_poses=poses), info


def optimize(cfg: PoseGraphConfig, st: PoseGraphState) -> PoseGraphState:
    """:func:`optimize_checked` without the status: a failed factorisation
    shows as NaN poses, as in the reference."""
    return optimize_checked(cfg, st)[0]


def graph_error(st: PoseGraphState) -> Tensor:
    """Total weighted squared residual over the active edges (diagnostic)."""
    e_mask = (torch.arange(st.edge_i.shape[0], device=st.device) < st.n_edges).to(torch.float32)
    e, _, _ = _edge_residual_jac(
        st.kf_poses[st.edge_i.long()], st.kf_poses[st.edge_j.long()], st.edge_delta)
    return ((st.edge_info * e * e).sum(-1) * e_mask).sum()


def schur_solve(h: Tensor, b: Tensor, split: int) -> Tensor:
    """Solve ``H x = b`` by Schur-complement elimination of the trailing
    block: ``H = [[A, B], [B^T, C]]`` with ``A = h[:split, :split]``; the
    reduced system ``(A - B C^-1 B^T) x1 = b1 - B C^-1 b2`` is solved first."""
    a = h[:split, :split]
    bb = h[:split, split:]
    c = h[split:, split:]
    b1, b2 = b[:split], b[split:]
    c_inv_bt = torch.linalg.solve(c, bb.T)
    c_inv_b2 = torch.linalg.solve(c, b2)
    s = a - bb @ c_inv_bt
    x1 = torch.linalg.solve(s, b1 - bb @ c_inv_b2)
    x2 = c_inv_b2 - c_inv_bt @ x1
    return torch.cat([x1, x2])


def _masked_keyframe_scans(st: PoseGraphState, lo: int, hi: int) -> LaserScan:
    """The stored scans of slots lo..hi-1, those past ``n_kf`` with no valid
    beam."""
    used = torch.arange(lo, hi, device=st.device) < st.n_kf
    return LaserScan(st.kf_scans.ranges[lo:hi], st.kf_scans.bearings[lo:hi],
                     st.kf_scans.valid[lo:hi] & used[:, None])


def joint_refine(
    cfg: PoseGraphConfig,
    model,
    st: PoseGraphState,
    gm_template: gridlib.GridMap,
    beam: raycast.BeamConfig,
    rounds: int = 4,
    damping: float = 0.5,
    matcher: str = "brute_force",
    matcher_cfg=None,
) -> PoseGraphState:
    """Joint pose/map refinement by damped leave-one-out alternation.

    Each round re-matches every keyframe pose against the map built from all
    the other keyframes and moves it ``damping`` of the way to its match.
    The map without scan i is the fold of ``(W_total - W_i, S_total - S_i)``:
    one rasterisation pass a round. Keyframe 0 stays fixed (the gauge). All
    K matches of a round run together, on the K leave-one-out maps: one
    launch of the batched score (brute force), of ``kernels.hill_climb``,
    of ``kernels.gradient_refine``, or of ``kernels.m3rsm_pyramid`` and
    ``kernels.m3rsm_search`` (M3RSM). ``matcher_cfg`` defaults to the
    reference's: its brute-force grid, else the matcher's default config.
    The Monte-Carlo matcher is refused: the reference hands it no key."""
    if matcher == "monte_carlo":
        raise NotImplementedError(_MONTE_CARLO_KEYLESS.format(where="joint_refine's matcher"))
    cfg_cls, match_fn = matcherslib.MATCHERS[matcher]
    if matcher_cfg is None:
        if matcher == "brute_force":
            matcher_cfg = matcherslib.BruteForceConfig(
                half_x=0.35, half_y=0.35, half_theta=0.12, n_x=15, n_y=15, n_theta=9,
                scoring=scoring.ScoringConfig(reducer="overlap"),
            )
        else:
            matcher_cfg = cfg_cls()
    kmax = cfg.max_keyframes
    h, w = gm_template.height, gm_template.width
    scans = _masked_keyframe_scans(st, 0, kmax)
    k_idx = torch.arange(kmax, device=st.device)
    movable = ((k_idx > 0) & (k_idx < st.n_kf))[:, None]  # the anchor and unused rows stay
    poses = st.kf_poses
    for _ in range(rounds):
        w_all, s_all = raycast.scan_observation_planes_batched(
            gm_template.origin, h, w, gm_template.scale, poses, scans, beam)  # [K, H, W]
        w_tot, s_tot = w_all.sum(0), s_all.sum(0)
        gm = gridlib.GridMap(
            cells=gm_template.cells[None].expand(kmax, *gm_template.cells.shape),
            origin=gm_template.origin[None].expand(kmax, 2), scale=gm_template.scale)
        gm = gridlib.apply_observations(gm, model, w_tot - w_all, s_tot - s_all)
        res = match_fn(scoring.MapView.of(gm, model), st.kf_scans, poses, None, matcher_cfg)
        d = res.pose - poses
        d = torch.cat([d[:, :2], wrap_angle(d[:, 2:])], dim=-1)
        new = poses + damping * d
        new = torch.cat([new[:, :2], wrap_angle(new[:, 2:])], dim=-1)
        poses = torch.where(movable, new, poses)
    return dataclasses.replace(st, kf_poses=poses)


def regenerate_map(
    cfg: PoseGraphConfig, model, st: PoseGraphState, gm: gridlib.GridMap,
    beam: raycast.BeamConfig,
    group: int = 32,
    n_used: int | None = None,
) -> gridlib.GridMap:
    """Rebuild a map by inserting every stored keyframe scan at its
    optimised pose (the pass after a loop closure).

    Cell models with an additive fold (BayesAvg) rasterise ``group``
    keyframes a call, each group summed into one pair of planes by the
    scatter, the groups' planes added in order, and fold once at the end:
    the serial chain's map up to the order of the sums. Order-sensitive
    models (TBM) keep the serial fold, one insert a keyframe.

    ``n_used`` is a count of keyframes the host knows to be at least
    ``n_kf`` (the engine's mirror); slots from there on are skipped. Without
    it every slot of the store is rasterised, the empty ones with no valid
    beam, and nothing is read from the device."""
    kmax = cfg.max_keyframes if n_used is None else min(n_used, cfg.max_keyframes)
    h, w = gm.height, gm.width
    if getattr(model, "fold_additive", False):
        w_sum = torch.zeros((h, w), dtype=torch.float32, device=st.device)
        s_sum = torch.zeros_like(w_sum)
        for lo in range(0, kmax, max(group, 1)):
            hi = min(lo + group, kmax)
            w_g, s_g = raycast.scan_observation_planes_batched(
                gm.origin, h, w, gm.scale, st.kf_poses[lo:hi], _masked_keyframe_scans(st, lo, hi),
                beam, torch.zeros((hi - lo,), dtype=torch.int64, device=st.device), 1)
            w_sum, s_sum = w_sum + w_g[0], s_sum + s_g[0]
        return gridlib.apply_observations(gm, model, w_sum, s_sum)
    scans = _masked_keyframe_scans(st, 0, kmax)
    for i in range(kmax):
        gm = raycast.insert_scan(gm, model, st.kf_poses[i], scans[i], beam)
    return gm
