"""Full SLAM pipeline: grid tracking + keyframe pose graph + loop closure
(port of ``slam_constructor_tpu.models.full``).

The single-hypothesis tracker (tiny or viny style) runs per scan; keyframes
are gated by travel distance; each new keyframe is matched against old
nearby keyframes for loop closures; when enough loops have closed, the
Gauss-Newton solver re-optimises the keyframe graph, the tracker pose is
re-anchored, and the map is regenerated from the optimised keyframes.

Host and device: a segment of scans is tracked without any host sync (the
keyframe gate, the trajectory anchors and the body-frame deltas are computed
on the device and collected as tensors); then one transfer brings the
segment's poses, flags and anchors to the host, which drives the graph work
at keyframe rate: one small fetch a keyframe batch (loop count, counters)
and one a closure burst (whether a keyframe moved, new loops).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops import grid as gridlib
from ..ops.geometry import between, compose, pose_distance
from ..ops.scan import LaserScan
from . import posegraph as pg
from .engine import EngineConfig, SlamState, init_state, slam_step
from .tiny import tiny_config

Tensor = torch.Tensor

#: "no keyframe yet": far enough that the first scan always trips the
#: keyframe gate, small enough that the f32 distance stays exact
_NO_KF = (1.0e6, 1.0e6, 0.0)


def track_segment(
    cfg: EngineConfig,
    gcfg: pg.PoseGraphConfig,
    state: SlamState,
    last_kf_pose: Tensor,
    anchor_pose: Tensor,
    base: Tensor,
    scans: LaserScan,
    odom: Tensor,
    noise: Tensor | None = None,
    generator: torch.Generator | None = None,
):
    """Track a segment of scans with the keyframe gate on the device; no
    host sync from the first scan to the last.

    After every step the gate tests the reference's keyframe distance
    against ``last_kf_pose``; a flagged scan becomes the gate's pose and the
    trajectory anchor. Every scan is recorded against the latest keyframe at
    its time (its own, if flagged): the anchor's index, counted from
    ``base`` (the graph's keyframe count before the segment, a device
    value), and the body-frame delta from the anchor's pose.

    Returns ``(state, last_kf_pose, anchor_pose, poses f32[S, 3], flags
    bool[S], anchor_idx i64[S], deltas f32[S, 3])``.
    """
    kf_cnt = torch.zeros((), dtype=torch.int64, device=odom.device)
    poses, flags, a_idx, deltas = [], [], [], []
    for i in range(len(scans)):
        state = slam_step(
            cfg, state, scans[i], odom[i],
            noise=None if noise is None else noise[i], generator=generator,
        )
        is_kf = (
            pose_distance(last_kf_pose, state.pose, gcfg.keyframe_angle_weight)
            > gcfg.keyframe_distance
        )
        last_kf_pose = torch.where(is_kf, state.pose, last_kf_pose)
        anchor_pose = torch.where(is_kf, state.pose, anchor_pose)
        kf_cnt = kf_cnt + is_kf
        poses.append(state.pose)
        flags.append(is_kf)
        a_idx.append(torch.clamp(base + kf_cnt - 1, min=0))
        deltas.append(between(anchor_pose, state.pose))
    return (state, last_kf_pose, anchor_pose, torch.stack(poses), torch.stack(flags),
            torch.stack(a_idx), torch.stack(deltas))


@dataclasses.dataclass(frozen=True)
class FullConfig:
    tracking: EngineConfig = None  # default filled in __post_init__
    graph: pg.PoseGraphConfig = pg.PoseGraphConfig()
    #: re-optimise and regenerate the map every time this many loops accumulate
    optimize_every_loops: int = 1
    #: before each optimise, run ``posegraph.densify_loops`` this many times
    #: (each pass proposes up to ``graph.max_candidates`` new pair
    #: constraints between mid-trajectory keyframes; 0 disables)
    densify_rounds: int = 1
    #: after each optimise, polish every keyframe pose against the dense
    #: leave-one-out occupancy consensus (``posegraph.joint_refine``; 0
    #: disables: a round costs a rasterisation and a match a keyframe)
    joint_refine_rounds: int = 0
    #: keyframes added and loop-matched per batch (one rasterisation and one
    #: score launch a batch, see ``posegraph.process_keyframes``)
    kf_batch: int = 8
    #: after a closure burst inside a segment, re-express the tracked poses
    #: not yet processed in the optimised frame: keyframes added after the
    #: burst must not mix the frames before and after it in a chain edge
    burst_reexpress: bool = True

    def __post_init__(self):
        if self.tracking is None:
            object.__setattr__(self, "tracking", tiny_config())
        if self.tracking.matcher == "m3rsm":
            # the reference replaces the tracker's map after a closure
            # (full.py:261, :366, :787) and keeps the pyramid of the map from
            # before it, so its M3RSM tracker matches a stale pyramid; the
            # port does not copy that
            raise NotImplementedError(
                "FullConfig with an M3RSM tracker is not ported: the reference's pipeline "
                "keeps the pyramid of the map from before a closure (a stale pyramid)"
            )


class FullSlamEngine:
    """Host-side front end of the loop-closing pipeline. Runs on the card unless
    ``device`` names another."""

    def __init__(self, cfg: FullConfig | None = None, n_beams: int = 360, device=None,
                 seed: int = 0):
        self.cfg = cfg or FullConfig()
        self.device = resolve_device(device)
        self.state: SlamState = init_state(self.cfg.tracking, self.device)
        self.graph: pg.PoseGraphState = pg.init_state(self.cfg.graph, n_beams, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.pending_loops = 0
        self.total_loops = 0
        #: tracked poses as they were recorded, f32[3] numpy rows
        self.trajectory: list = []
        #: per trajectory entry: the anchor keyframe's index and the
        #: body-frame delta from that keyframe's estimate at record time, so
        #: that a loop closure corrects the whole history
        self._anchor_idx: list = []
        self._anchor_delta: list = []
        #: the keyframe gate's pose and the trajectory anchor's, on the device
        self._last_kf_dev = torch.tensor(_NO_KF, dtype=torch.float32, device=self.device)
        self._anchor_pose_dev = torch.zeros(3, dtype=torch.float32, device=self.device)
        #: host mirrors of the graph's counters: upper bounds, so that
        #: :meth:`_ensure_capacity` reads nothing from the device
        self._n_kf_host = 0
        self._edges_upper_host = 0
        #: keyframe batches processed and closure bursts run (diagnostics)
        self.n_kf_batches = 0
        self.n_bursts = 0

    # --- capacity -------------------------------------------------------------

    def _ensure_capacity(self, n_new: int = 1) -> None:
        """Grow the graph (by doubling) before an add would saturate it, so
        that a long run never silently stops building the graph."""
        g = self.cfg.graph
        # worst case a keyframe: 1 odometric edge + max_candidates loop
        # edges + densify passes of max_candidates each
        edge_budget = n_new * (1 + g.max_candidates * (1 + self.cfg.densify_rounds))
        need_kf = self._n_kf_host + n_new > g.max_keyframes
        need_edges = self._edges_upper_host + edge_budget > g.max_edges
        if not (need_kf or need_edges):
            return

        def fit(cap, need):
            while cap < need:
                cap *= 2
            return cap

        new_cfg, self.graph = pg.grow(
            g, self.graph,
            max_keyframes=fit(g.max_keyframes, self._n_kf_host + n_new),
            max_edges=fit(g.max_edges, self._edges_upper_host + edge_budget),
        )
        self.cfg = dataclasses.replace(self.cfg, graph=new_cfg)

    # --- pieces shared by the two run loops -----------------------------------

    def _track(self, scans: LaserScan, odom: Tensor, noise: Tensor | None):
        """Track one segment and record it: the segment's one transfer to
        the host. Returns the tracked poses (device) and the indices of the
        flagged scans (host)."""
        (self.state, self._last_kf_dev, self._anchor_pose_dev, poses, flags, a_idx,
         deltas) = track_segment(
            self.cfg.tracking, self.cfg.graph, self.state, self._last_kf_dev,
            self._anchor_pose_dev, self.graph.n_kf.to(torch.int64), scans, odom, noise,
            self.generator,
        )
        rows = torch.cat(
            [poses, deltas, flags[:, None].to(torch.float32), a_idx[:, None].to(torch.float32)],
            dim=1,
        ).cpu().numpy()
        self.trajectory.extend(rows[:, 0:3])
        self._anchor_delta.extend(rows[:, 3:6])
        self._anchor_idx.extend(rows[:, 7].astype(np.int64).tolist())
        return poses, np.nonzero(rows[:, 6] > 0.5)[0]

    def _keyframe_batch(self, scans: LaserScan, poses: Tensor, chunk: np.ndarray) -> Tensor:
        """Add the flagged scans ``chunk`` of a segment to the graph and
        detect their loops; returns the count of new loops (device)."""
        idx = torch.as_tensor(chunk, dtype=torch.int64, device=self.device)
        valid = torch.ones((len(chunk),), dtype=torch.bool, device=self.device)
        self.graph, n_loops = pg.process_keyframes(
            self.cfg.graph, self.cfg.tracking.cell_model, self.graph, scans[idx], poses[idx], valid)
        self.n_kf_batches += 1
        return n_loops

    def _fetch_counts(self, *values: Tensor) -> list:
        """Small integer or boolean device values in one transfer, with the
        graph's counters behind them; resyncs the host mirrors and fails
        loudly if the graph dropped a keyframe or an edge."""
        g = self.graph
        got = torch.stack([v.to(torch.int64) for v in (
            *values, g.n_kf, g.n_edges, g.kf_overflow | g.edge_overflow)]).tolist()
        *out, self._n_kf_host, self._edges_upper_host, overflow = got
        if overflow:
            raise RuntimeError(
                "pose-graph capacity overflow (keyframes or edges were dropped on the "
                "device): the host's bounds were too small; raise "
                "PoseGraphConfig.max_keyframes/max_edges or shorten the segment"
            )
        return out

    @staticmethod
    def _check_solved(info: int) -> None:
        if info:
            raise RuntimeError(
                f"pose-graph optimisation failed: the normal equations are not positive "
                f"definite (Cholesky status {info}); the keyframe poses are not usable"
            )

    def _fresh_map(self) -> gridlib.GridMap:
        t = self.cfg.tracking
        return gridlib.make_grid_map(
            t.cell_model, t.map_height, t.map_width, t.map_scale, device=self.device)

    def _regenerate(self) -> gridlib.GridMap:
        t = self.cfg.tracking
        return pg.regenerate_map(
            self.cfg.graph, t.cell_model, self.graph, self._fresh_map(), beam=t.beam,
            n_used=self._n_kf_host)

    def _last_keyframe_pose(self) -> Tensor:
        return self.graph.kf_poses.index_select(0, self.graph.last_kf.long()[None])[0]

    # --- the fused semantics: bursts at keyframe-batch cadence ----------------

    def _burst(self, rest: Tensor) -> Tensor:
        """Closure burst: densify, optimise, re-anchor the tracker pose, the
        gate and the trajectory anchor on the optimised last keyframe,
        regenerate the map only if the optimisation moved a keyframe by more
        than half a cell, and re-express ``rest`` (the segment's tracked
        poses) in the optimised frame. One fetch."""
        t = self.cfg.tracking
        model = t.cell_model
        before = self._last_keyframe_pose()
        before_all = self.graph.kf_poses
        extra = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(self.cfg.densify_rounds):
            self.graph, n_new = pg.densify_loops(self.cfg.graph, model, self.graph)
            extra = extra + n_new
        self.graph, info = pg.optimize_checked(self.cfg.graph, self.graph)
        after = self._last_keyframe_pose()
        new_pose = compose(after, between(before, self.state.pose))
        k_idx = torch.arange(self.cfg.graph.max_keyframes, device=self.device)
        moved = torch.where(
            (k_idx < self.graph.n_kf)[:, None], torch.abs(self.graph.kf_poses - before_all), 0.0
        ).max()
        regen, n_extra, info = self._fetch_counts(moved > 0.5 * t.map_scale, extra, info)
        self._check_solved(info)
        self.total_loops += n_extra
        self.n_bursts += 1
        gm = self._regenerate() if regen else self.state.gm
        self.state = dataclasses.replace(self.state, gm=gm, pose=new_pose)
        self._last_kf_dev = after
        self._anchor_pose_dev = after
        if self.cfg.burst_reexpress:
            rest = compose(after, between(before, rest))
        return rest

    def run_segments_fused(self, scans: LaserScan, odom: Tensor, segment: int = 128,
                           noise: Tensor | None = None) -> Tensor:
        """Track a whole segment first; then take its flagged scans in
        ``kf_batch``-wide batches through ``posegraph.process_keyframes``,
        and after any batch that brings the pending loops to
        ``optimize_every_loops`` run the closure burst. A correction's
        latency therefore does not depend on the segment's length: a segment
        may be the whole sequence. Returns the corrected trajectory."""
        scans, odom = scans.to(self.device), odom.to(self.device)
        noise = None if noise is None else noise.to(self.device)
        g = self.cfg.graph
        n = odom.shape[0]
        od_all = odom.cpu().numpy()  # once, before anything is queued
        for s0 in range(0, n, segment):
            s1 = min(s0 + segment, n)
            # capacity bound from the segment's odometric path length (a
            # keyframe needs keyframe_distance of travel): 2x + slack covers
            # the matcher's corrections
            od = od_all[s0:s1]
            seg_dist = float(
                np.linalg.norm(od[:, :2], axis=1).sum()
                + g.keyframe_angle_weight * np.abs(od[:, 2]).sum()
            )
            self._ensure_capacity(min(s1 - s0, int(2.0 * seg_dist / g.keyframe_distance) + 8))
            seg_scans = scans[s0:s1]
            poses, kf_is = self._track(
                seg_scans, odom[s0:s1], None if noise is None else noise[s0:s1])
            kb = max(self.cfg.kf_batch, 1)
            for c0 in range(0, len(kf_is), kb):
                n_loops = self._keyframe_batch(seg_scans, poses, kf_is[c0:c0 + kb])
                (nl,) = self._fetch_counts(n_loops)
                self.pending_loops += nl
                self.total_loops += nl
                if self.pending_loops >= self.cfg.optimize_every_loops:
                    poses = self._burst(poses)
                    self.pending_loops = 0
        return self.corrected_trajectory()

    # --- the segmented run: closures at segment boundaries --------------------

    def run_segments(self, scans: LaserScan, odom: Tensor, segment: int = 64,
                     noise: Tensor | None = None) -> Tensor:
        """Track in ``segment``-scan chunks, do the graph work of a chunk at
        keyframe rate (one loop-count fetch a chunk), and close loops at
        chunk boundaries. Returns the corrected trajectory."""
        scans, odom = scans.to(self.device), odom.to(self.device)
        noise = None if noise is None else noise.to(self.device)
        n = odom.shape[0]
        kb = max(self.cfg.kf_batch, 1)
        for s0 in range(0, n, segment):
            s1 = min(s0 + segment, n)
            seg_scans = scans[s0:s1]
            poses, kf_is = self._track(
                seg_scans, odom[s0:s1], None if noise is None else noise[s0:s1])
            loops = torch.zeros((), dtype=torch.int64, device=self.device)
            for c0 in range(0, len(kf_is), kb):
                chunk = kf_is[c0:c0 + kb]
                self._ensure_capacity(len(chunk))
                loops = loops + self._keyframe_batch(seg_scans, poses, chunk)
                self._n_kf_host += len(chunk)
                self._edges_upper_host += (1 + self.cfg.graph.max_candidates) * len(chunk)
            if len(kf_is):
                (nl,) = self._fetch_counts(loops)  # the chunk's one loop sync
                self.pending_loops += nl
                self.total_loops += nl
            if self.pending_loops >= self.cfg.optimize_every_loops:
                self._close_loops()
                self.pending_loops = 0
        return self.corrected_trajectory()

    def _close_loops(self) -> None:
        """Optimise the graph, re-anchor the tracker, regenerate the map."""
        model = self.cfg.tracking.cell_model
        before = self._last_keyframe_pose()
        fixed_rounds = self.cfg.joint_refine_rounds == 0
        extra = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(self.cfg.densify_rounds):
            self.graph, n_new = pg.densify_loops(self.cfg.graph, model, self.graph)
            if fixed_rounds:
                # a fixed count of rounds (a round without candidates adds
                # nothing); their loop count comes with the solver's status
                extra = extra + n_new
                continue
            (n,) = self._fetch_counts(n_new)
            self.total_loops += n
            if n == 0:
                break
        self.graph, info = pg.optimize_checked(self.cfg.graph, self.graph)
        n, info = self._fetch_counts(extra, info)  # the loop count rides with the status
        self._check_solved(info)
        self.total_loops += n
        if self.cfg.joint_refine_rounds > 0:
            t = self.cfg.tracking
            self.graph = pg.joint_refine(
                self.cfg.graph, model, self.graph, self._fresh_map(), t.beam,
                rounds=self.cfg.joint_refine_rounds)
        after = self._last_keyframe_pose()
        # re-anchor the tracking pose: keep its offset from the last keyframe
        new_pose = compose(after, between(before, self.state.pose))
        self.n_bursts += 1
        self.state = dataclasses.replace(self.state, gm=self._regenerate(), pose=new_pose)
        # the gate and the trajectory anchor follow the optimised keyframe
        self._last_kf_dev = after
        self._anchor_pose_dev = after

    # --- entry points ---------------------------------------------------------

    def handle_scan(self, scan: LaserScan, odom_delta: Tensor, noise: Tensor | None = None):
        """Online mode: one scan at a time (a host sync a scan; use
        :meth:`run` for throughput)."""
        self.run_segments(
            scan[None], torch.as_tensor(odom_delta)[None], segment=1,
            noise=None if noise is None else noise[None])
        return self.state.pose

    def run(self, scans: LaserScan, odom: Tensor, segment: int = 64,
            noise: Tensor | None = None) -> Tensor:
        """Offline mode: a whole sequence ``scans`` [T, R], ``odom`` f32[T,
        3]; ``noise`` optionally holds the tracker's matcher normals
        f32[T, rounds, batch, 3]. Returns the corrected trajectory."""
        if self.cfg.joint_refine_rounds == 0:
            return self.run_segments_fused(scans, odom, segment=segment, noise=noise)
        # the joint-refine pass runs at closure rate on the segmented path
        return self.run_segments(scans, odom, segment=segment, noise=noise)

    def corrected_trajectory(self) -> Tensor:
        """The trajectory's history re-anchored to the current (optimised)
        keyframe estimates, f32[T, 3] on the engine's device: the trajectory
        after loop closure."""
        if not self._anchor_idx:
            return torch.zeros((0, 3), dtype=torch.float32, device=self.device)
        idx = torch.as_tensor(self._anchor_idx, dtype=torch.int64, device=self.device)
        deltas = torch.as_tensor(np.stack(self._anchor_delta), device=self.device)
        return compose(self.graph.kf_poses[idx], deltas)

    def _device_tree(self) -> dict:
        return {"state": self.state, "graph": self.graph, "last_kf_dev": self._last_kf_dev,
                "anchor_pose_dev": self._anchor_pose_dev, "generator": self.generator}

    def save_checkpoint(self, path: str) -> None:
        """Snapshot the whole pipeline between runs: the device half (the
        tracker's state, the pose graph, the keyframe gate's and the
        trajectory anchor's poses, the generator) through
        ``utils.checkpoint.save`` at ``path``, and the host's bookkeeping
        (loop counters, the graph's capacity and its host mirrors, the
        trajectory with its anchors, the diagnostics) at ``path +
        '.host.npz'``. A run restored from it and finished equals, bit for
        bit, the run that was never stopped (the same config and calls)."""
        from ..utils import checkpoint as ckpt

        g = self.cfg.graph
        host = {
            "pending_loops": self.pending_loops, "total_loops": self.total_loops,
            "n_kf_host": self._n_kf_host, "edges_upper_host": self._edges_upper_host,
            "n_kf_batches": self.n_kf_batches, "n_bursts": self.n_bursts,
            "max_keyframes": g.max_keyframes, "max_edges": g.max_edges,
            "anchor_idx": [int(i) for i in self._anchor_idx],
        }
        ckpt.save(path, self._device_tree())

        def rows(a):
            return np.stack(a).astype(np.float32) if a else np.zeros((0, 3), np.float32)

        np.savez_compressed(
            path + ".host.npz", trajectory=rows(self.trajectory),
            anchor_delta=rows(self._anchor_delta),
            meta=np.frombuffer(json.dumps(host).encode(), np.uint8))

    def restore_checkpoint(self, path: str) -> None:
        """The inverse of :meth:`save_checkpoint` (the same config as at the
        save; a graph grown before it is grown again). Both halves are
        checked for before anything of the engine changes."""
        from ..utils import checkpoint as ckpt

        missing = [p for p in (path, path + ".host.npz")
                   if not (os.path.exists(p) or os.path.exists(p + ".npz"))]
        if missing:
            raise FileNotFoundError(
                f"full-pipeline checkpoint incomplete: missing {missing}; save_checkpoint "
                f"writes the device half and the '.host.npz' half, and restore needs both")
        dev = ckpt.restore(path, self._device_tree())
        with np.load(path + ".host.npz") as f:
            host = json.loads(bytes(f["meta"]).decode())
            traj, deltas = f["trajectory"], f["anchor_delta"]
        self.cfg = dataclasses.replace(self.cfg, graph=dataclasses.replace(
            self.cfg.graph, max_keyframes=host["max_keyframes"], max_edges=host["max_edges"]))
        self.state, self.graph = dev["state"], dev["graph"]
        self._last_kf_dev, self._anchor_pose_dev = dev["last_kf_dev"], dev["anchor_pose_dev"]
        self.generator = dev["generator"]
        self.pending_loops, self.total_loops = host["pending_loops"], host["total_loops"]
        self._n_kf_host, self._edges_upper_host = host["n_kf_host"], host["edges_upper_host"]
        self.n_kf_batches, self.n_bursts = host["n_kf_batches"], host["n_bursts"]
        self._anchor_idx = list(host["anchor_idx"])
        self.trajectory = list(traj)
        self._anchor_delta = list(deltas)

    @property
    def keyframe_poses(self) -> Tensor:
        """The poses of the keyframes in use (reads their count back)."""
        return self.graph.kf_poses[: int(self.graph.n_kf)]

    @property
    def occupancy(self) -> Tensor:
        return gridlib.occupancy_plane(self.state.gm, self.cfg.tracking.cell_model)
