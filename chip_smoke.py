"""Smoke run of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each, in order; any failure exits non-zero:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: the CUDA kernels from ``slam_constructor_tpu_torch/csrc`` with
   nvcc for sm_90a, one process a source (seconds, and ptxas'
   register/shared-memory report);
3. ``overlap_score`` against ``overlap_score_ref`` on the card at the
   main-path shapes and at edge cases (max |diff| <= 2e-6), then both timed
   with CUDA events at the main-path shape;
4. ``polar_free_plane`` against ``polar_free_plane_ref`` on the card at the
   main-path shape (256^2 cells, 360 beams) and at edge cases: the number of
   cells whose free decision differs (at most 8 in 65,536) and the largest
   relative difference of the weight where both are free (<= 1e-6); then
   both timed;
5. the particle match (the RBPF's 30 particles' matches in one launch of
   ``csrc/mc_match.cu``) on the arguments of every 32nd match of a run of
   the gmapping path (30 maps of 256^2, 160^2 windows read in place, 180
   beams, 5 rounds of 20): ``mc_match_windows`` on them, on the windows
   clamped at each of the map's four edges and corners, on a window as
   large as the map and with the occupancy a channel of the maps' cells,
   against ``mc_match_batched`` on the same windows cut out; ``mc_match_batched`` on the cut-out windows and on edge
   cases (K = 1, 13, 64 and 100, 0 rounds, a particle without a valid beam,
   P = 1, P = 64); each against 30 single-plane ``mc_match`` launches and
   ``mc_match_rounds`` (bit for bit), ``mc_match_batched`` also against its
   plain twin (as ``mc_match`` below); then timed in turns with the
   windows cut out and matched (the path's form before the windows were
   read in place), beside 30 single launches;
6. ``mc_match`` (one launch a match) against ``mc_match_rounds`` (one
   ``overlap_score`` launch a round) on the card: (map, scan, prior) states
   taken from every 32nd scan of a tiny and a viny run over the bench
   sequence and of a run of the loop-closing pipeline over its own (a 192^2
   window of the map with a shifted origin, 180 beams, 12 rounds), plus
   edge cases (batch 8 to 100, 0 and 1 rounds, no valid
   beam, a prior 0.5 m from the map's edge, noise of zeros, duplicated
   candidates, a NaN weight): pose, prob and trace must be equal bit for
   bit. The same cases against the plain twin ``mc_match_ref``: trace and
   prob within 2e-6, or, where the two part, a round before that in which
   the twin's keep-if-better or argmax was decided by less than 4e-6.
   Then all three timed at the shapes of the tiny, the viny and the full
   path;
7. card vs CPU: the first 8 scans of the sequence on the card and on the
   CPU (plain twins) with the same matcher noise, for tinySLAM and vinySLAM;
8. tinySLAM main path (``tiny_config(map_size=256)``) over the bench
   sequence (512 scans, 360 beams, cecum world) through ``Engine.run``,
   warm-up first, then a timed run from a fresh state under
   ``torch.cuda.set_sync_debug_mode("error")``: ``mc_match`` must have been
   launched 512 times and ``overlap_score`` not at all, poses finite, ATE
   below odometry's and below 0.15 m; then once more for repeatability;
9. vinySLAM main path (``viny_config(map_size=256)``), the same way:
   ``mc_match`` and ``polar_free_plane`` launched 512 times each, poses
   finite, ATE below odometry's and no more than 0.02 m above what the JAX
   reference reads on the identical sequence (its worst of five matcher
   keys: the card draws its own matcher noise);
10. the first 64 scans of the viny path with ``mc_match_rounds`` handed in
   in the fused kernel's place (``overlap_score`` launched 64 x 17 times):
   the trajectory must equal the fused path's first 64 poses bit for bit;
11. the loop-closing pipeline, ``FullSlamEngine`` at the width of bench.py's
   ``full`` preset: 512 scans over two laps of the cecum rectangle, 360
   beams, a 256^2 map, tracker ``tiny.fast_config(map_size=256, stride=2,
   mc_rounds=12)`` (``mc_match`` on a 192^2 window), keyframes 0.7 m apart,
   up to 4 loop candidates a keyframe on 120^2 submaps, a closure burst
   every 8 loops, one segment. A warm-up run (made before phase 5) keeps
   the arguments of every 32nd match and of every launch of
   ``overlap_score_batched``; then the timed run, with
   ``torch.cuda.set_sync_debug_mode("error")`` while the segment is tracked:
   ``mc_match`` launched 512 times, ``overlap_score_batched`` twice a
   keyframe batch and twice a densify round (the brute-force grid and the
   information estimate), keyframes > 0 and loops >= 1, the corrected
   trajectory's ATE below odometry's, no more than 0.02 m above the worst
   of the JAX reference's five matcher keys on the same sequence and no
   more than 0.02 m above the same tracker's ATE without the graph; then
   once more: trajectory, graph and map equal bit for bit;
12. ``overlap_score_batched`` on the kept launches (M up to 32 submaps of
   120^2, K = 343 and K = 7, a different scan a map) and on edge cases
   (M = 1, M = 5, a map with no valid beam): against its plain twin
   (max |diff| <= 2e-6) and against M single-plane ``overlap_score``
   launches (bit for bit); then timed at M = 32, K = 343;
13. card vs CPU over a short loop-closing run (a lap and 14 scans more, 360
   beams, keyframe batches and closure bursts included) with the same
   matcher noise: the same graph structure and loop count, poses within
   1e-3;
14. the GMapping RBPF at bench.py's ``gmapping`` preset
   (``gmapping.fast_config(n_particles=30, map_size=256)``) over the bench
   sequence through ``GMappingEngine.run``, under
   ``torch.cuda.set_sync_debug_mode("error")`` (warmed up by the run of
   phase 5): ``mc_match_batched`` launched 512 times (through
   ``mc_match_windows``) and nothing else, no match window cut out, the
   winner's ATE no more than 0.02 m above the worst of the JAX reference's
   five keys (which do not beat odometry on this sequence); then once more:
   trajectory, genealogy, log-weights and maps equal bit for bit;
15. the same over the reference's two-lap quality sequence: the winner's ATE
   below odometry's and no more than 0.02 m above the reference's worst key;
16. 64 scans with the improved proposal and the minimumScore gate on:
   ``overlap_score_batched`` launched twice a scan at M = 30 (the probes,
   K = 16, and the gate, K = 1), every 8th launch of each held to its twin
   (2e-6) and to 30 single-plane launches (bit for bit), then both timed;
17. card vs CPU: the first 16 RBPF scans with the same draws (made with
   numpy): poses within 1e-4, the same ancestors, log-weights within 1e-4,
   the maps equal but for a few cells that counted a border sample;
18. vinySLAM with the M3RSM matcher (``viny_m3rsm_config(map_size=256)``)
   over the bench sequence: a warm-up run that keeps the whole match's
   arguments of every 32nd scan, then the timed run under
   ``torch.cuda.set_sync_debug_mode("error")``: ``m3rsm_search`` 512
   launches (the whole match, one a scan), ``m3rsm_pyramid`` 513 (the build
   in ``init_state`` and a refresh a scan), nothing else; ATE below
   odometry's and no more than 0.02 m above the JAX reference's (one run:
   M3RSM draws no noise); a second run equal bit for bit; the live pyramid
   equal to a rebuild of the final map;
19. card vs CPU: its first 32 scans, poses within 1e-4;
20. the same path with ``m3rsm_search_levels`` handed in in the kernel's
   place (one ``m3rsm_level`` launch a level and one
   ``overlap_score_batched`` launch a hill-climb round: 2,560 and 4,608
   launches): the trajectory equal to the timed run's bit for bit;
21. ``m3rsm_match_many``: 8 requests against the path's final map equal to
   8 single calls bit for bit;
22. ``m3rsm_search`` (K4b, the whole match in one launch) against
   ``m3rsm_search_levels`` bit for bit (pose, prob, trace) on the kept
   arguments of every 32nd viny_m3rsm scan, every 4th loop match of
   phase 25's warm-up run (M up to 32 submaps, K up to 1,024), 8 requests
   on one map, window 0, ``M3RSMConfig``'s defaults (the whole map, 5
   levels, 17 thetas) with the path's scan and with a scan of 1,081 beams,
   refine 0 and an all-unknown map; against its plain
   twin: prob within 2e-6 where the poses are equal, else the twin's
   scores of the two winners within 2e-6, the case named; then timed
   (a call, chained, replayed from a CUDA graph) beside the level launches
   and the twin;
23. ``m3rsm_score_level`` (K4b's level score, now the yardstick's) against
   its plain twin (2e-6) on the level launches of the kept arguments at
   all five levels and at edge cases (the window at the map's first and
   far corner, rects off the window, a mask of zeros), then timed at each
   level of a scan;
24. ``m3rsm_pyramid`` (K4a) against its plain twin bit for bit: the path's
   256^2 map at 4 levels, the occupancy as a channel of the cells, an
   unaligned 100 x 90 map at 5 levels, the loop closer's submap builds (32
   of 120^2 at 3 levels) kept from a warm-up run of phase 25; the 144^2
   refresh into new planes, clamped at every corner and edge, and with the
   gate at 0 (a copy), the planes handed in untouched; then timed (a call,
   chained, replayed from a CUDA graph), beside four chained
   ``max_pool2d`` calls (a call and replayed);
25. the loop-closing pipeline with the M3RSM loop matcher of the
   reference's own test (``full_m3rsm_config``): launches per loop match
   (a keyframe batch or a densify round) one ``m3rsm_pyramid``, one
   ``m3rsm_search`` and one ``overlap_score_batched`` (the information
   estimate, after the match); loops >= 1; the corrected ATE below
   odometry's and no more than 0.02 m above the reference's worst of five
   keys (the reference's graph makes its tracker worse here, so the
   tracker-alone bound is not applied); a second run equal bit for bit.

The launch counts are set to 0 just before each of these runs and read just
after it. The line before the last is a JSON object of the
kernels; the last line is ``{"ok": true, "device": {...}}``. It needs no
network and starts no process that outlives it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 2e-6  # the bound the reference holds its Pallas path to
N_SCANS, N_BEAMS, MAP = 512, 360, 256

#: ATE of the JAX reference on a CPU over this very sequence with the free
#: fill pinned to 'polar', once for each matcher key PRNGKey(0..4)
#: (`JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --preset
#: viny --keys 5 --port`). A single run's ATE is bimodal in the matcher's
#: noise alone, so a run that draws its own noise, as the card's does, is
#: held to the reference's worst key plus the margin, not to key 0. With a
#: key's noise injected the port on the CPU reads that key's figure.
VINY_REFERENCE_ATE_BY_KEY = (0.07265, 0.07982, 0.07299, 0.11143, 0.11816)
VINY_ATE_MARGIN = 0.02

#: corrected-trajectory ATE of the JAX reference's ``FullSlamEngine`` on a
#: CPU over the full path's sequence and configuration, once for each
#: matcher key PRNGKey(0..4) (`JAX_PLATFORMS=cpu python
#: scripts/torch_port/reference_ate.py --preset full --keys 5`)
FULL_REFERENCE_ATE_BY_KEY = (0.07739, 0.07623, 0.08515, 0.08183, 0.07648)
FULL_ATE_MARGIN = 0.02

#: winner ATE of the JAX reference's RBPF on a CPU over the tiny sequence
#: at bench.py's gmapping preset (30 particles, 160^2 windows), once for
#: each key PRNGKey(0..4) (`JAX_PLATFORMS=cpu python
#: scripts/torch_port/reference_ate.py --preset gmapping --keys 5 --port`)
#: The reference's RBPF does not beat odometry on this sequence (0.4532 m):
#: 0.7 of a lap in 0.0375 m steps, no loop. On the reference's own quality
#: sequence (`gmapping_quality_sequence`, `--preset gmapping_2lap`) it does,
#: and the card is held to that too.
GMAPPING_REFERENCE_ATE_BY_KEY = (0.52053, 0.49879, 0.45874, 0.64013, 0.60896)
GMAPPING_2LAP_REFERENCE_ATE_BY_KEY = (0.09649, 0.11871, 0.11003, 0.10554, 0.11708)
GMAPPING_ATE_MARGIN = 0.02

#: ATE of the JAX reference's ``viny_m3rsm_config(map_size=256)`` on a CPU
#: over the bench sequence (`JAX_PLATFORMS=cpu python scripts/torch_port/
#: reference_ate.py --preset viny_m3rsm --port`). M3RSM draws no noise, so
#: one run is the figure; the port on the CPU reads 0.12788 m.
VINY_M3RSM_REFERENCE_ATE = 0.12715
#: corrected-trajectory ATE of the reference's ``FullSlamEngine`` with the
#: M3RSM loop matcher (``full_m3rsm_config``) on a CPU over the full path's
#: sequence, once for each tracker key PRNGKey(0..4) (`JAX_PLATFORMS=cpu
#: python scripts/torch_port/reference_ate.py --preset full_m3rsm --keys 5
#: --port`). Its graph makes the tracker worse here (its tracker alone
#: reads 0.0719-0.0723 m), so the port is not held to its tracker on this
#: path; with key 0's noise the port on the CPU reads 0.13820 m, on the
#: same 247 edges.
FULL_M3RSM_REFERENCE_ATE_BY_KEY = (0.13820, 0.12036, 0.14911, 0.12296, 0.12987)
GM_PARTICLES = 30
#: cells of the 30 maps whose count may differ between card and CPU after
#: 16 scans (a DDA sample on a cell's border)
GM_MOVED_CELLS = 32
#: the improved-proposal run: its length and its minimumScore gate
GM_IMPROVED_SCANS, GM_IMPROVED_GATE = 64, 0.7

#: the card's published peaks (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

#: f32 operations a cell of `polar_free_plane`, with the math library's
#: routines counted at the length of their usual path in the built kernel's
#: SASS (scripts/torch_port/kernel_probe.py prints the instruction mix; the
#: whole kernel, slow paths and prologue included, holds 338):
#: cell centre and offsets 8, d 4 + sqrtf 8, atan2f 2 x 40, sinf + cosf
#: 2 x 20, atanf 25, three divisions 3 x 8, rint/compare/select 11
POLAR_OPS_PER_CELL = 8 + 12 + 80 + 40 + 25 + 24 + 11
#: a cell that no beam can reach stops after its centre, d and the test
POLAR_OPS_PER_FAR_CELL = 8 + 12 + 3
#: f32 operations a (candidate, beam) pair of `overlap_score`: pose
#: transform 8, to cell units 4, two axes of taps 2 x 12, blend 14, sum 3
OVERLAP_OPS_PER_POINT = 8 + 4 + 24 + 14 + 3


#: what separates `mc_match` from its plain twin: a score differs by the
#: order of its sums (TOL); two scores that decide a keep-if-better or an
#: argmax may therefore fall the other way when they lie within 2 x TOL
KNIFE_EDGE = 4e-6
ROUNDS_PATH_SCANS = 64
#: which of the full path's kept states is timed: scan 288, on the second lap
FULL_TIMED_STATE = 9


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(n_bytes: float, n_ops: float):
    """The least time the card could take: the larger of bytes over its
    memory rate and operations over its f32 rate; and which one binds."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bench_sequence(device):
    """bench.py's tiny geometry: 512 scans along the cecum rectangle, 360
    beams, odometry noise 0.01 m / 0.005 rad from a seeded numpy rng."""
    from slam_constructor_tpu_torch.utils import datagen

    occ, origin, scale = datagen.cecum_world(device=device)
    poses = datagen.rectangle_trajectory(step=9.6 / N_SCANS * 2, device=device)
    reps = (N_SCANS + poses.shape[0] - 1) // poses.shape[0]
    poses = poses.repeat(reps, 1)[:N_SCANS]
    return datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(N_BEAMS, device=device),
        rng=np.random.default_rng(0), odom_noise_xy=0.01, odom_noise_theta=0.005,
    )


def full_sequence(device, n_scans=N_SCANS, step=2 * 27.2 / N_SCANS, noise=(0.01, 0.005)):
    """bench.py's ``full`` geometry: ``n_scans`` scans over laps of the
    cecum rectangle (two laps of 27.2 m at the defaults, so that the graph
    closes loops), 360 beams, odometry noise from a seeded numpy rng."""
    from slam_constructor_tpu_torch.utils import datagen

    occ, origin, scale = datagen.cecum_world(device=device)
    lap = datagen.rectangle_trajectory(step=step, device=device)
    reps = (n_scans + lap.shape[0] - 1) // lap.shape[0]
    poses = lap.repeat(reps, 1)[:n_scans]
    return datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(N_BEAMS, device=device),
        rng=np.random.default_rng(0), odom_noise_xy=noise[0], odom_noise_theta=noise[1],
    )


def gmapping_quality_sequence(device, seed=42):
    """The JAX reference's RBPF quality protocol (``scripts/r3/
    gm_multiseed.py``): two laps of the cecum rectangle at 0.3 m a step (182
    scans), 360 beams, odometry noise 0.02 m / 0.012 rad, from a seeded
    numpy rng (the protocol's first seed)."""
    from slam_constructor_tpu_torch.utils import datagen

    occ, origin, scale = datagen.cecum_world(device=device)
    poses = datagen.rectangle_trajectory(step=0.3, device=device).repeat(2, 1)
    return datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(N_BEAMS, device=device),
        rng=np.random.default_rng(seed), odom_noise_xy=0.02, odom_noise_theta=0.012,
    )


def full_config(**kwargs):
    """bench.py's ``full`` preset."""
    from slam_constructor_tpu_torch.models import full, posegraph, tiny

    return full.FullConfig(
        tracking=tiny.fast_config(map_size=MAP, stride=2, mc_rounds=12),
        graph=posegraph.PoseGraphConfig(
            keyframe_distance=0.7, min_index_gap=8, max_candidates=4, local_map_size=120),
        **{"optimize_every_loops": 8, **kwargs},
    )


#: the M3RSM loop matcher of the reference's own test (tests/test_posegraph.py:451-455)
M3RSM_LOOP_MATCHER = dict(levels=3, half_x=0.6, half_y=0.6, half_theta=0.3, n_theta=7)


def full_m3rsm_config(**kwargs):
    """bench.py's ``full`` preset with the M3RSM loop matcher (overlap
    scoring on every second beam) in the brute-force grid's place."""
    from slam_constructor_tpu_torch.ops import m3rsm, scoring

    cfg = full_config(**kwargs)
    return dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, loop_matcher_kind="m3rsm", loop_matcher=m3rsm.M3RSMConfig(
            **M3RSM_LOOP_MATCHER, scoring=scoring.ScoringConfig(reducer="overlap", stride=2))))


def odometry_trajectory(start, odom):
    from slam_constructor_tpu_torch.ops.geometry import compose

    p, out = start, []
    for d in odom:
        p = compose(p, d)
        out.append(p)
    return torch.stack(out)


def time_ms(fn, calls: int = 50) -> list[float]:
    times = []
    for _ in range(calls):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def time_pair(kernel, plain, plain_calls: int = 50):
    """Median ms a call of both, in turns (plain, kernel, kernel, plain),
    each call between its own pair of CUDA events (50 calls a turn of the
    kernel, ``plain_calls`` of the plain version); and the kernel's ms a
    launch with 200 launches queued back to back between one pair."""
    for _ in range(20):  # warm-up
        kernel()
    for _ in range(min(20, plain_calls)):
        plain()
    torch.cuda.synchronize()
    k_ms, p_ms = [], []
    for bucket, fn, calls in ((p_ms, plain, plain_calls), (k_ms, kernel, 50), (k_ms, kernel, 50),
                              (p_ms, plain, plain_calls)):
        bucket += time_ms(fn, calls)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(200):
        kernel()
    b.record()
    b.synchronize()
    return statistics.median(k_ms), statistics.median(p_ms), a.elapsed_time(b) / 200


def phase_overlap_kernel(dev, scans, gt):
    """`overlap_score` vs its plain twin at the main paths' shapes and at
    edge cases; returns the `kernels` entry without the launch count."""
    from slam_constructor_tpu_torch.models import tiny
    from slam_constructor_tpu_torch.models.engine import init_state
    from slam_constructor_tpu_torch.ops import kernels, raycast, scoring
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    cfg = tiny.tiny_config(map_size=MAP)
    gm = init_state(cfg, dev).gm
    for i in range(0, 40, 2):  # a 256^2 map after 20 bench scans
        gm = raycast.insert_scan(gm, cfg.cell_model, gt[i], scans[i], cfg.beam)
    view = scoring.MapView.of(gm, cfg.cell_model)
    g = torch.Generator(device=dev).manual_seed(1)
    scan, pose = scans[40], gt[40]
    sig = torch.tensor([0.08, 0.08, 0.05], device=dev)
    cand = pose + torch.randn((64, 3), generator=g, device=dev) * sig
    half_off = pose + torch.randn((64, 3), generator=g, device=dev) * torch.tensor(
        [6.0, 6.0, 3.0], device=dev) + torch.tensor([9.0, 0.0, 0.0], device=dev)
    weights = torch.rand((N_BEAMS,), generator=g, device=dev)
    holes = LaserScan(scan.ranges, scan.bearings,
                      scan.valid & (torch.arange(N_BEAMS, device=dev) % 7 != 2))
    r100 = LaserScan(scan.ranges[:100], scan.bearings[:100], scan.valid[:100])
    sc = cfg.matcher_cfg.scoring
    sc2 = scoring.ScoringConfig(reducer="overlap", window=1, stride=2)
    cases = [
        ("main K=64 R=360", scan, cand, sc, None),
        ("main K=1 R=360", scan, cand[:1], sc, None),
        ("R=100 (not a warp multiple)", r100, cand, sc, None),
        ("candidates half off the map", scan, half_off, sc, None),
        ("viny: stride 2, beam weights", scan, cand, sc2, weights),
        ("random beam weights", scan, cand, sc, weights),
        ("invalid beams", holes, cand, sc, weights),
    ]
    max_err = 0.0
    for name, s, poses, c, w in cases:
        prep = scoring.prepare(view, s, c, w)
        args = (prep.plane, poses.contiguous(), prep.pts, prep.beam_w, prep.origin,
                prep.scale, prep.unknown)
        got = kernels.overlap_score(*args)
        want = kernels.overlap_score_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"kernel output not finite ({name})")
        print(f"overlap_score vs plain [{name}]: K={poses.shape[0]} R={prep.pts.shape[0]} "
              f"max|diff|={err:.3e} (tol {TOL:g})", flush=True)
        check(err <= TOL, f"kernel disagrees with plain twin ({name}): {err}")
        max_err = max(max_err, err)

    prep = scoring.prepare(view, scan, sc)
    args = (prep.plane, cand, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    ms, plain_ms, chained = time_pair(lambda: kernels.overlap_score(*args),
                                      lambda: kernels.overlap_score_ref(*args))
    # each input read once, the output written once; operations for the
    # beams that carry weight (the others are skipped)
    n_bytes = 4 * (prep.plane.numel() + cand.numel() + prep.pts.numel()
                   + prep.beam_w.numel() + 2 + cand.shape[0])
    n_ops = OVERLAP_OPS_PER_POINT * cand.shape[0] * int((prep.beam_w != 0).sum())
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"overlap_score K=64 R=360 256^2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of 100 calls each, CUDA events), kernel {chained:.4f} ms a launch over 200 "
          f"back to back; bound {b_ms:.6f} ms by {by} "
          f"({n_bytes} B, {n_ops} operations); no single PyTorch call computes it", flush=True)
    return {
        "name": "overlap_score", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/overlap_score.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "chained_ms": chained,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def phase_polar_kernel(dev, scans, gt):
    """`polar_free_plane` vs its plain twin at the main path's shape and at
    edge cases; returns the `kernels` entry without the launch count."""
    from slam_constructor_tpu_torch.models import viny
    from slam_constructor_tpu_torch.ops import kernels, raycast
    from slam_constructor_tpu_torch.utils import datagen

    beam = viny.viny_config(map_size=MAP).beam
    hole_half, max_range, scale = beam.hole_width / 2.0, beam.max_range, 0.1
    occ, w_origin, w_scale = datagen.cecum_world(device=dev)

    def origin_of(h, w):
        return torch.tensor([-w * scale / 2.0, -h * scale / 2.0], device=dev)

    def cast(pose, bearings):
        return raycast.cast_rays(occ, w_origin, w_scale, pose, bearings)

    every7 = torch.arange(N_BEAMS, device=dev) % 7 != 3
    s40, p40 = scans[40], gt[40]
    p_mid = torch.tensor([0.3, -1.45, 0.7], device=dev)
    p_edge = torch.tensor([6.6, -2.0, 2.5], device=dev)  # in the corridor's corner
    s_half = cast(p_mid, datagen.default_bearings(181, fov=math.pi, device=dev))
    s120 = cast(p_mid, datagen.default_bearings(120, device=dev))
    s90 = cast(p_mid, datagen.default_bearings(90, device=dev))
    s_edge = cast(p_edge, datagen.default_bearings(N_BEAMS, device=dev))
    cases = [
        ("main 256^2 R=360", s40.ranges, s40.valid, s40.bearings, p40, MAP, MAP),
        ("every 7th beam invalid", s40.ranges, s40.valid & every7, s40.bearings, p40, MAP, MAP),
        ("half field of view R=181", s_half.ranges, s_half.valid, s_half.bearings, p_mid, MAP, MAP),
        ("R=120", s120.ranges, s120.valid, s120.bearings, p_mid, MAP, MAP),
        ("R=90, 96 x 128 map", s90.ranges, s90.valid, s90.bearings, p_mid, 96, 128),
        ("pose near the map's edge", s_edge.ranges, s_edge.valid, s_edge.bearings, p_edge, 56, 144),
        ("all beams invalid", s40.ranges, torch.zeros_like(s40.valid), s40.bearings, p40, MAP, MAP),
    ]
    max_err, max_rel, flipped_all = 0.0, 0.0, 0
    for name, ranges, valid, bearings, pose, h, w in cases:
        args = (ranges.contiguous(), valid.contiguous(), bearings.contiguous(), pose.contiguous(),
                origin_of(h, w), h, w, scale, hole_half, max_range)
        got = kernels.polar_free_plane(*args)
        want = kernels.polar_free_plane_ref(*args)
        torch.cuda.synchronize()
        check(got.shape == (h, w) and bool(torch.isfinite(got).all()),
              f"polar_free_plane output malformed ({name})")
        flipped = int(((got > 0) != (want > 0)).sum())
        both = (got > 0) & (want > 0)
        n_free = int(both.sum())
        err = float((got - want).abs()[both].max()) if n_free else 0.0
        rel = float(((got - want).abs() / want.clamp(min=1e-30))[both].max()) if n_free else 0.0
        allowed = math.ceil(8 * h * w / 65536)
        print(f"polar_free_plane vs plain [{name}]: {h}x{w} R={ranges.shape[0]} "
              f"free cells {n_free}, flipped {flipped} (allowed {allowed}), "
              f"max rel weight diff {rel:.3e} (tol 1e-6)", flush=True)
        check(flipped <= allowed, f"polar_free_plane: {flipped} cells flipped ({name})")
        check(rel <= 1e-6, f"polar_free_plane weights disagree ({name}): {rel}")
        if name.startswith("all beams invalid"):
            check(n_free == 0 and not bool(got.any()), "free cells without a valid beam")
        else:
            check(n_free > 200, f"polar_free_plane opened no free space ({name})")
        max_err, max_rel, flipped_all = max(max_err, err), max(max_rel, rel), flipped_all + flipped

    args = (s40.ranges.contiguous(), s40.valid.contiguous(), s40.bearings.contiguous(),
            p40.contiguous(), origin_of(MAP, MAP), MAP, MAP, scale, hole_half, max_range)
    ms, plain_ms, chained = time_pair(lambda: kernels.polar_free_plane(*args),
                                      lambda: kernels.polar_free_plane_ref(*args))
    # ranges and bearings f32, valid 1 B a beam, pose, origin; the plane out
    n_bytes = 4 * MAP * MAP + N_BEAMS * (4 + 4 + 1) + 12 + 8
    # what this scan needs: the full arithmetic only for the cells some beam
    # could reach, the distance test alone for the others
    rng_eff, _, _ = kernels.polar_range_table(*args[:3])
    cells = torch.arange(MAP, device=dev, dtype=torch.float32)
    cy, cx = (args[4][1] + (cells + 0.5) * scale)[:, None], (args[4][0] + (cells + 0.5) * scale)[None]
    d = torch.sqrt((cx - p40[0]) ** 2 + (cy - p40[1]) ** 2)
    n_near = int((d < min(max_range, float(rng_eff.max()) - hole_half)).sum())
    n_ops = POLAR_OPS_PER_CELL * n_near + POLAR_OPS_PER_FAR_CELL * (MAP * MAP - n_near)
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"polar_free_plane 256^2 R=360: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of 100 calls each, CUDA events), kernel {chained:.4f} ms a launch over 200 "
          f"back to back; bound {b_ms:.6f} ms by {by} ({n_bytes} B; {n_ops} operations: "
          f"{n_near} of {MAP * MAP} cells within a beam's reach); no single PyTorch call "
          f"computes it", flush=True)
    return {
        "name": "polar_free_plane", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/polar_free.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:186",
        "max_abs_err": max_err, "max_rel_err": max_rel, "flipped_cells": flipped_all,
        "ms": ms, "plain_ms": plain_ms, "chained_ms": chained,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def bits(t):
    """A float tensor as integers, so that NaN compares equal to itself."""
    return t.reshape(-1).view(torch.int32)


@contextlib.contextmanager
def handed_in(fn, name="mc_match", module=None):
    """``fn`` stands in the package's ``kernels.mc_match`` (or another
    function of a module of the package) while the block runs, so an engine
    run goes through it."""
    from slam_constructor_tpu_torch.ops import kernels

    module = module or kernels
    kept = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, kept)


def recorder(fn, every=1, keep=None):
    """``fn`` with the arguments of every ``every``-th call kept (of the
    calls ``n`` for which ``keep(n)`` holds, where it is given): returns the
    stand-in and the list it fills."""
    kept, n = [], [0]

    def recording(*args):
        if (keep(n[0]) if keep else n[0] % every == 0):
            kept.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        n[0] += 1
        return fn(*args)

    return recording, kept


def capture_match_states(cfg, scans, odom, gt, every=32):
    """One run of the main path (it also warms the path up) that keeps the
    arguments of every ``every``-th match."""
    from slam_constructor_tpu_torch.ops import kernels

    recording, kept = recorder(kernels.mc_match, every)
    with handed_in(recording):
        run_main_path(cfg, scans, odom, gt, 0)
    return kept


def with_noise(args, rounds, batch, gen, bad_rounds=None):
    a = list(args)
    a[5] = torch.randn((rounds, batch, 3), generator=gen, device=a[4].device)
    if bad_rounds is not None:
        a[10] = bad_rounds
    return tuple(a)


def match_cases(tiny_states, viny_states, full_states, dev):
    """(name, args of mc_match): the captured states and the edge cases."""
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [(f"tiny scan {32 * i}", a) for i, a in enumerate(tiny_states)]
    cases += [(f"viny scan {32 * i}", a) for i, a in enumerate(viny_states)]
    cases += [(f"full scan {32 * i}", a) for i, a in enumerate(full_states)]
    # scans 96, 160 and 288: a map with walls on it; the last on the second lap
    t, v, f = tiny_states[3], viny_states[5], full_states[FULL_TIMED_STATE]
    for batch in (8, 32, 64, 96, 100):
        cases.append((f"tiny state, batch {batch}", with_noise(t, 12, batch, g)))
        cases.append((f"viny state, batch {batch}", with_noise(v, 16, batch, g)))
        cases.append((f"full state (window), batch {batch}", with_noise(f, 12, batch, g)))
    for rounds in (0, 1):
        cases.append((f"tiny state, rounds={rounds}", with_noise(t, rounds, 64, g)))
        cases.append((f"viny state, rounds={rounds}, batch 20", with_noise(v, rounds, 20, g)))
    cases.append(("viny state, anneal after every bad round", with_noise(v, 16, 64, g, 1)))

    def replaced(args, **kw):
        names = ("plane", "pts", "beam_w", "origin", "init_pose", "noise")
        return tuple(kw.get(n, a) for n, a in zip(names, args)) + tuple(args[6:])

    cases.append(("no valid beam", replaced(t, beam_w=torch.zeros_like(t[2]))))
    edge = torch.tensor([12.3, -1.5, 0.4], device=dev)  # the map ends at x = 12.8
    cases.append(("prior 0.5 m from the map's edge", replaced(t, init_pose=edge)))
    cases.append(("noise of zeros: every round ties", replaced(v, noise=torch.zeros_like(v[5]))))
    twice = t[5].clone()
    half = twice.shape[1] // 2
    twice[:, half:] = twice[:, :half]  # every candidate has an equal half a batch on
    cases.append(("every candidate twice: the first wins", replaced(t, noise=twice)))
    nan_w = v[2].clone()
    nan_w[5] = float("nan")
    cases.append(("a NaN beam weight: NaN scores, never better", replaced(v, beam_w=nan_w)))
    cases.append(("full state, no valid beam", replaced(f, beam_w=torch.zeros_like(f[2]))))
    # the window's origin is shifted: a prior 0.4 m inside its far corner
    reach = f[0].shape[0] * f[6] - 0.4
    corner = torch.cat([f[3] + reach, f[4][2:]])
    cases.append(("full state, prior in the window's corner", replaced(f, init_pose=corner)))
    return cases


def twin_record(args):
    """The plain twin's match with, for every round, how closely it was
    decided: the gap between its two best scores and between the best and
    the best so far. Returns (pose, prob, trace), margins f32[rounds]; with
    a leading particle dimension on the arguments, of every particle
    (margins f32[P, rounds])."""
    from slam_constructor_tpu_torch.ops import kernels

    scores = []

    def score(*a):
        out = kernels.overlap_score_ref(*a)
        scores.append(out)
        return out

    out = kernels.mc_match_loop(score, *args)
    best, margins = scores[0][..., 0], []
    for probs in scores[1:]:
        top = torch.topk(probs, min(2, probs.shape[-1]), dim=-1).values
        gap = ((top[..., 0] - top[..., -1]).abs() if top.shape[-1] > 1
               else torch.full_like(best, math.inf))
        margins.append(torch.minimum(gap, (top[..., 0] - best).abs()))
        best = torch.maximum(best, top[..., 0])
    return out, (torch.stack(margins, dim=-1) if margins
                 else torch.empty((*best.shape, 0), device=best.device))


def against_twin(name, got, twin, margins):
    """One match's (pose, prob, trace) against its plain twin's: within TOL
    round by round; where they part, a round decided by less than
    KNIFE_EDGE must come before. Returns (the largest difference up to
    there, whether they parted)."""
    n_rounds = got[2].shape[0]
    diff = (got[2] - twin[2]).abs()
    diff = torch.where(torch.isnan(got[2]) & torch.isnan(twin[2]), 0.0, diff)
    far = (diff > TOL).nonzero().flatten().tolist()
    first = far[0] if far else n_rounds
    err = float(diff[:first].max()) if first else 0.0
    if far:
        edge = float(margins[:first + 1].min())
        print(f"  [{name}] parts from the twin at round {first}; closest decision up to there "
              f"{edge:.3e} (limit {KNIFE_EDGE:g})", flush=True)
        check(edge < KNIFE_EDGE, f"a match parts from its twin with no close decision ({name})")
        return err, True
    p_err = float((got[1] - twin[1]).abs().nan_to_num(nan=0.0))
    pose_err = float((got[0] - twin[0]).abs().max())
    check(p_err <= TOL, f"match prob differs from its twin ({name}): {p_err}")
    check(pose_err <= 1e-6 or float(margins.min()) < KNIFE_EDGE,
          f"match pose differs from its twin ({name}): {pose_err}")
    return max(err, p_err), False


def phase_mc_match(dev, tiny_states, viny_states, full_states):
    """`mc_match` vs `mc_match_rounds` (bitwise) and vs `mc_match_ref` over
    real states of the three main paths and edge cases; then the three
    timed at each path's shapes. Returns the `kernels` entry without the
    launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    f = full_states[FULL_TIMED_STATE]
    check((tuple(f[0].shape), f[1].shape[0], tuple(f[5].shape)) == ((192, 192), 180, (12, 64, 3)),
          f"the full path's match is {tuple(f[0].shape)} R'={f[1].shape[0]} noise "
          f"{tuple(f[5].shape)}, not a 192^2 window, 180 beams and 12 rounds of 64")
    cases = match_cases(tiny_states, viny_states, full_states, dev)
    max_err, parted = 0.0, 0
    for name, args in cases:
        got = kernels.mc_match(*args)
        rounds = kernels.mc_match_rounds(*args)
        (twin, margins) = twin_record(args)
        torch.cuda.synchronize()
        n_rounds, batch = args[5].shape[0], args[5].shape[1]
        check(got[0].shape == (3,) and got[1].shape == () and got[2].shape == (n_rounds,),
              f"mc_match output malformed ({name})")
        same = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, rounds))
        check(same, f"mc_match differs from mc_match_rounds ({name}): pose {got[0].tolist()} vs "
                    f"{rounds[0].tolist()}, max |trace diff| "
                    f"{float((got[2] - rounds[2]).abs().nan_to_num(nan=0.0).max()) if n_rounds else 0.0}")
        err, apart = against_twin(name, got, twin, margins)
        parted += apart
        max_err = max(max_err, err)
        print(f"mc_match [{name}]: K={batch} rounds={n_rounds} R'={args[1].shape[0]} "
              f"{args[0].shape[0]}x{args[0].shape[1]} equal to "
              f"mc_match_rounds bit for bit; vs plain twin max|diff|={err:.3e} over the rounds "
              f"{'before they part' if apart else 'all'} (tol {TOL:g})", flush=True)
    print(f"mc_match: {len(cases)} cases equal to mc_match_rounds bit for bit; {parted} part from "
          f"the plain twin after a round decided by less than {KNIFE_EDGE:g}", flush=True)

    entry = {}
    for preset, args in (("tiny", tiny_states[3]), ("viny", viny_states[5]),
                         ("full", full_states[FULL_TIMED_STATE])):
        ms, plain_ms, chained = time_pair(lambda: kernels.mc_match(*args),
                                          lambda: kernels.mc_match_ref(*args), plain_calls=10)
        rounds_ms = statistics.median(time_ms(lambda: kernels.mc_match_rounds(*args), 20))
        n_rounds, batch = args[5].shape[0], args[5].shape[1]
        # every input read once, pose, prob and trace written once
        n_bytes = 4 * (sum(a.numel() for a in args[:6]) + 3 + 1 + n_rounds)
        n_ops = OVERLAP_OPS_PER_POINT * (1 + n_rounds * batch) * int((args[2] != 0).sum())
        b_ms, by = bound_ms(n_bytes, n_ops)
        print(f"mc_match {preset} K={batch} rounds={n_rounds} R'={args[1].shape[0]} "
              f"{args[0].shape[0]}x{args[0].shape[1]}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, one overlap_score launch a round "
              f"{rounds_ms:.4f} ms (medians of 100, 20 and 20 calls, CUDA events), kernel "
              f"{chained:.4f} ms a launch over 200 back to back; bound {b_ms:.6f} ms by {by} "
              f"({n_bytes} B, {n_ops} operations); no single PyTorch call computes it", flush=True)
        entry[preset] = {"ms": ms, "plain_ms": plain_ms, "rounds_ms": rounds_ms,
                         "chained_ms": chained, "bound_ms": b_ms, "bound_by": by}
    return {
        "name": "mc_match", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/mc_match.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "max_abs_err": max_err, "cases_bitwise_equal_to_rounds": len(cases),
        "cases_parted_from_twin": parted, **entry["viny"], "by_path": entry,
        "library_ms": None,
    }


def phase_card_vs_cpu(name, cfg, dev, scans, odom, gt, n=8):
    """First ``n`` scans on the card and on the CPU with the same noise (a
    Monte-Carlo matcher's; M3RSM draws none)."""
    from slam_constructor_tpu_torch.models import engine

    noise = None
    if cfg.matcher == "monte_carlo":
        rounds, batch = cfg.matcher_cfg.rounds, cfg.matcher_cfg.batch
        noise = torch.from_numpy(
            np.random.default_rng(5).standard_normal((n, rounds, batch, 3)).astype(np.float32))
    trajs = []
    for d in (dev, torch.device("cpu")):
        e = engine.Engine(cfg, device=d)
        e.state.pose = gt[0].to(d).clone()
        traj, _ = e.run(scans[:n], odom[:n], noise=None if noise is None else noise.to(d))
        trajs.append(traj.cpu())
    diff = float((trajs[0] - trajs[1]).abs().max())
    print(f"{name} card vs CPU, {n} scans: max|pose diff|={diff:.3e} (tol 1e-4)", flush=True)
    check(diff <= 1e-4, f"{name}: card and CPU runs disagree: {diff}")


def run_main_path(cfg, scans, odom, gt, sync_mode):
    """One run of the sequence from a fresh state through the entry points
    a user calls; the engine takes the card because no device is named."""
    from slam_constructor_tpu_torch.models import engine

    e = engine.Engine(cfg, seed=0)
    check(e.device.type == "cuda", f"Engine defaulted to {e.device}, not the card")
    e.state.pose = gt[0].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(sync_mode)
    t0 = time.perf_counter()
    traj, probs = e.run(scans, odom)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return traj, probs, time.perf_counter() - t0, e


def phase_main_path(name, cfg, want_launches, scans, odom, gt, odo_ate, ate_limit):
    """The timed run (the path was warmed up by the run that captured the
    match states) with the counts at 0 before and read after, then once
    more for repeatability; returns the launch counts, the trajectory and
    the engine of the timed run."""
    from slam_constructor_tpu_torch.utils import evaluate

    reset_launches()
    traj, probs, secs, e = run_main_path(cfg, scans, odom, gt, "error")
    launches = read_launches()
    print(f"{name} main path: {N_SCANS} scans in {secs:.3f} s = {N_SCANS / secs:.1f} scans/s "
          f"with the sync check on, no host sync; launches {launches} "
          f"(expected {want_launches})", flush=True)
    check(launches == want_launches, f"{name}: launches {launches}, expected {want_launches}")
    check(traj.shape == (N_SCANS, 3) and bool(torch.isfinite(traj).all()),
          f"{name}: non-finite poses")
    ate = float(evaluate.ate(traj, gt, align=False))
    print(f"{name} main path: ATE {ate:.4f} m (no alignment; limit {ate_limit:.4f}), "
          f"odometry-only ATE {odo_ate:.4f} m, min prob {float(probs[1:].min()):.4f}", flush=True)
    check(ate < odo_ate and ate <= ate_limit,
          f"{name}: ATE {ate} not below odometry {odo_ate} and {ate_limit}")
    traj2, _, secs2, _ = run_main_path(cfg, scans, odom, gt, 0)
    rep = float((traj2 - traj).abs().max())
    print(f"{name} repeatability: max|pose diff| between two runs {rep:.3e}; second run, "
          f"sync check off: {N_SCANS / secs2:.1f} scans/s", flush=True)
    check(torch.equal(traj2, traj), f"{name}: two runs differ by {rep}")
    return launches, traj, e


def expect(**counts) -> dict:
    """The launch counts of every kernel wrapper: those named, 0 the rest."""
    from slam_constructor_tpu_torch.ops import kernels

    return {name: counts.get(name, 0) for name in kernels.launch_counts()}


def reset_launches() -> None:
    from slam_constructor_tpu_torch.ops import kernels

    kernels.reset_launch_counts()


def read_launches() -> dict:
    from slam_constructor_tpu_torch.ops import kernels

    return kernels.launch_counts()


def phase_rounds_path(cfg, scans, odom, gt, fused_traj):
    """The first scans of the viny path with `mc_match_rounds` handed in in
    the fused kernel's place: the same trajectory bit for bit, and the
    launches of `overlap_score` it takes."""
    from slam_constructor_tpu_torch.ops import kernels

    n = ROUNDS_PATH_SCANS
    with handed_in(kernels.mc_match_rounds):
        reset_launches()
        traj, _, secs, _ = run_main_path(cfg, scans[:n], odom[:n], gt, "error")
        launches = read_launches()
    want = expect(overlap_score=n * (cfg.matcher_cfg.rounds + 1), polar_free_plane=n)
    diff = float((traj - fused_traj[:n]).abs().max())
    print(f"viny path with one overlap_score launch a round, {n} scans: {n / secs:.1f} scans/s; "
          f"launches {launches} (expected {want}); max|pose diff| to the fused path {diff:.3e}",
          flush=True)
    check(launches == want, f"rounds path: launches {launches}, expected {want}")
    check(torch.equal(traj, fused_traj[:n]),
          f"the fused match and one launch a round give different trajectories: {diff}")
    return launches


def run_full_path(cfg, scans, odom, gt, sync_mode, noise=None, device=None):
    """One run of the loop-closing pipeline from a fresh state through
    ``FullSlamEngine.run``, the whole sequence as one segment; the sync
    check is on only while the segment is tracked (the graph work that
    follows fetches its counters by design). Returns the engine, the
    corrected trajectory, the seconds of the whole run and of the tracking."""
    from slam_constructor_tpu_torch.models import full

    e = full.FullSlamEngine(cfg, n_beams=N_BEAMS, device=device, seed=0)
    on_card = e.device.type == "cuda"
    check(device is not None or on_card, f"FullSlamEngine defaulted to {e.device}, not the card")
    e.state.pose = gt[0].to(e.device).clone()
    tracked, track_secs = full.track_segment, [0.0]

    def guarded(*args, **kwargs):
        t0 = time.perf_counter()
        if on_card:
            torch.cuda.set_sync_debug_mode(sync_mode)
        try:
            out = tracked(*args, **kwargs)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
        track_secs[0] += time.perf_counter() - t0
        return out

    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with handed_in(guarded, "track_segment", full):
        traj = e.run(scans, odom, segment=len(scans), noise=noise)
    if on_card:
        torch.cuda.synchronize()
    return e, traj, time.perf_counter() - t0, track_secs[0]


def capture_full_launches(cfg, scans, odom, gt, every=32):
    """A run of the full path (it also warms the path up) that keeps the
    arguments of every ``every``-th match and of every launch of
    ``overlap_score_batched``."""
    from slam_constructor_tpu_torch.ops import kernels

    match, states = recorder(kernels.mc_match, every)
    batched, kept = recorder(kernels.overlap_score_batched)
    with handed_in(match), handed_in(batched, "overlap_score_batched"):
        run_full_path(cfg, scans, odom, gt, 0)
    return states, kept


def graph_bits(e):
    """Everything of an engine's graph, map and live pose, as one list of
    tensors, for comparing two runs bit for bit."""
    g = e.graph
    return [g.kf_poses, g.kf_scans.ranges, g.kf_scans.valid, g.n_kf, g.edge_i, g.edge_j,
            g.edge_delta, g.edge_info, g.edge_is_loop, g.n_edges, g.last_kf, e.state.gm.cells,
            e.state.pose]


def loop_match_launches(graph_cfg, calls: int) -> dict:
    """The launches of ``calls`` loop-closing matches (``_match_loop``, one
    a keyframe batch and one a densify round): the brute-force grid and the
    information estimate, two of the batched score; or M3RSM's pyramid of
    the submaps, the whole match in one launch and the information
    estimate."""
    if graph_cfg.loop_matcher_kind != "m3rsm":
        return {"overlap_score_batched": 2 * calls}
    return {"m3rsm_pyramid": calls, "m3rsm_search": calls, "overlap_score_batched": calls}


def phase_full_path(cfg, scans, odom, gt, odo_ate, name="full", reference=FULL_REFERENCE_ATE_BY_KEY,
                    hold_to_tracker=True):
    """The timed run of the full path with the counts at 0 before and read
    after, its checks (with ``hold_to_tracker``, ATE within the margin of
    the same tracker's without the graph), and once more for
    repeatability; returns the launch counts."""
    from slam_constructor_tpu_torch.models import engine
    from slam_constructor_tpu_torch.utils import evaluate

    reset_launches()
    e, traj, secs, track_secs = run_full_path(cfg, scans, odom, gt, "error")
    launches = read_launches()
    n_kf, n_edges = int(e.graph.n_kf), int(e.graph.n_edges)
    want = expect(mc_match=N_SCANS, **loop_match_launches(
        cfg.graph, e.n_kf_batches + cfg.densify_rounds * e.n_bursts))
    print(f"{name} main path: {N_SCANS} scans in {secs:.3f} s = {N_SCANS / secs:.1f} scans/s "
          f"(tracking {track_secs:.3f} s with the sync check on, no host sync; keyframe work and "
          f"bursts {secs - track_secs:.3f} s); {n_kf} keyframes in {e.n_kf_batches} batches, "
          f"{n_edges} edges, {e.total_loops} loops, {e.n_bursts} bursts; launches {launches} "
          f"(expected {want})", flush=True)
    check(launches == want, f"{name}: launches {launches}, expected {want}")
    check(n_kf > 0 and e.total_loops >= 1, f"{name}: {n_kf} keyframes, {e.total_loops} loops")
    check(e.n_kf_batches == math.ceil(n_kf / cfg.kf_batch), f"{name}: keyframe batches do not add up")
    check(traj.shape == (N_SCANS, 3) and bool(torch.isfinite(traj).all()), f"{name}: non-finite poses")
    check(bool(torch.isfinite(e.occupancy).all()) and e.occupancy.shape == (MAP, MAP),
          f"{name}: the map is malformed")
    ate = float(evaluate.ate(traj, gt, align=False))
    raw_ate = float(evaluate.ate(torch.from_numpy(np.stack(e.trajectory)).to(gt.device), gt,
                                 align=False))
    # the same tracker without the graph, the same generator seed
    t = engine.Engine(cfg.tracking, seed=0)
    t.state.pose = gt[0].clone()
    tracker_ate = float(evaluate.ate(t.run(scans, odom)[0], gt, align=False))
    limit = max(reference) + FULL_ATE_MARGIN
    print(f"{name} main path: corrected-trajectory ATE {ate:.4f} m (no alignment; limits: the "
          f"reference's worst key + margin {limit:.4f}, the tracker alone + margin "
          f"{tracker_ate + FULL_ATE_MARGIN:.4f}{'' if hold_to_tracker else ', not held'}), as tracked {raw_ate:.4f} m, the same tracker "
          f"without the graph {tracker_ate:.4f} m, odometry only {odo_ate:.4f} m", flush=True)
    check(ate < odo_ate, f"{name}: ATE {ate} not below odometry's {odo_ate}")
    check(ate <= limit, f"{name}: ATE {ate} above the reference's worst key + margin {limit}")
    check(not hold_to_tracker or ate <= tracker_ate + FULL_ATE_MARGIN,
          f"{name}: the graph degrades the tracker: {ate} against {tracker_ate}")
    e2, traj2, secs2, _ = run_full_path(cfg, scans, odom, gt, 0)
    same = torch.equal(traj2, traj) and all(
        torch.equal(a, b) for a, b in zip(graph_bits(e), graph_bits(e2)))
    print(f"{name} repeatability: max|pose diff| between two runs "
          f"{float((traj2 - traj).abs().max()):.3e}, graph and map equal: {same}; second run, "
          f"sync check off: {N_SCANS / secs2:.1f} scans/s", flush=True)
    check(same, f"{name}: two runs differ")
    return launches


def phase_batched_kernel(dev, kept):
    """`overlap_score_batched` on the launches kept from a full run and on
    edge cases: against its plain twin and against M single-plane launches;
    then timed. Returns the `kernels` entry without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    grids = [a for a in kept if a[1].shape[1] > 7]
    sevens = [a for a in kept if a[1].shape[1] == 7]
    check(grids and sevens, "the full run launched no grid or no information estimate")
    big = max(grids, key=lambda a: a[0].shape[0])
    n_m, k = big[1].shape[:2]
    check((n_m, k, big[0].shape[1:], big[2].shape[1]) == (32, 343, (120, 120), 180),
          f"the widest kept launch is M={n_m} K={k} {tuple(big[0].shape[1:])} R'={big[2].shape[1]}")

    def sub(a, m):  # the maps m of a launch
        return tuple(t[m].contiguous() for t in a[:5]) + tuple(a[5:])

    def edited(a, i, t):
        return a[:i] + (t,) + a[i + 1:]

    no_beam = big[3].clone()
    no_beam[1] = 0.0
    shifted = torch.stack([big[2][m].roll(3 * m, 0) for m in range(n_m)])  # other points a map
    cases = [
        ("kept: the widest grid", big),
        ("kept: its information estimate", max(sevens, key=lambda a: a[0].shape[0])),
        ("kept: the narrowest grid", min(grids, key=lambda a: a[0].shape[0])),
        ("kept: every 16th launch", None),
        ("M=1", sub(big, slice(0, 1))),
        ("M=5", sub(big, slice(3, 8))),
        ("a map with no valid beam", edited(big, 3, no_beam)),
        ("differing points a map", edited(big, 2, shifted)),
        ("poses of map 0 far off their submap", edited(big, 1, big[1] + torch.tensor(
            [40.0, 0.0, 0.0], device=dev) * (torch.arange(n_m, device=dev) == 0)[:, None, None])),
    ]
    max_err = 0.0
    for name, args in cases:
        for a in (kept[::16] if args is None else [args]):
            got = kernels.overlap_score_batched(*a)
            want = kernels.overlap_score_ref(*a)
            singles = torch.stack([kernels.overlap_score(*sub(a, m)) for m in range(a[0].shape[0])])
            torch.cuda.synchronize()
            check(got.shape == a[1].shape[:2] and bool(torch.isfinite(got).all()),
                  f"overlap_score_batched output malformed ({name})")
            err = float((got - want).abs().max())
            check(err <= TOL, f"overlap_score_batched disagrees with its twin ({name}): {err}")
            check(torch.equal(bits(got), bits(singles)),
                  f"overlap_score_batched differs from single-plane launches ({name}): "
                  f"{float((got - singles).abs().max())}")
            max_err = max(max_err, err)
        shape = "" if args is None else (f" M={args[0].shape[0]} K={args[1].shape[1]} "
                                         f"R'={args[2].shape[1]}")
        print(f"overlap_score_batched [{name}]:{shape} max|diff| to the plain twin so far "
              f"{max_err:.3e} (tol {TOL:g}); equal to single-plane launches bit for bit", flush=True)
    check(not bool(kernels.overlap_score_batched(*cases[6][1])[1].any()),
          "a map with no valid beam must score 0")

    ms, plain_ms, chained = time_pair(lambda: kernels.overlap_score_batched(*big),
                                      lambda: kernels.overlap_score_ref(*big))
    singles_ms = statistics.median(time_ms(
        lambda: [kernels.overlap_score(*sub(big, m)) for m in range(n_m)], 20))
    n_bytes = 4 * (sum(t.numel() for t in big[:5]) + n_m * k)
    n_ops = OVERLAP_OPS_PER_POINT * k * int((big[3] != 0).sum())
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"overlap_score_batched M={n_m} K={k} R'=180 120^2: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (median of 100 calls each, CUDA events), kernel {chained:.4f} ms a "
          f"launch over 200 back to back, {n_m} single-plane launches {singles_ms:.4f} ms (median "
          f"of 20); bound {b_ms:.6f} ms by {by} ({n_bytes} B, {n_ops} operations); no single "
          f"PyTorch call computes it", flush=True)
    return {
        "name": "overlap_score_batched", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/overlap_score.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "chained_ms": chained,
        "single_plane_launches_ms": singles_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": None,
    }


def phase_full_card_vs_cpu(dev):
    """A short loop-closing run (a lap of the rectangle and 14 scans more,
    keyframe batches and closure bursts included) on the card and on the CPU
    with the same matcher noise."""
    n = 92
    scans, odom, gt = full_sequence(dev, n_scans=n, step=0.35, noise=(0.02, 0.012))
    cfg = full_config(optimize_every_loops=2)
    mc = cfg.tracking.matcher_cfg
    noise = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (n, mc.rounds, mc.batch, 3)).astype(np.float32))
    runs = []
    for d in (None, "cpu"):
        e, traj, _, _ = run_full_path(cfg, scans, odom, gt, 0, noise=noise, device=d)
        runs.append((e, traj.cpu()))
    (a, ta), (b, tb) = runs
    diff = float((ta - tb).abs().max())
    n_e = int(a.graph.n_edges)
    same = (int(b.graph.n_edges) == n_e and int(a.graph.n_kf) == int(b.graph.n_kf)
            and a.total_loops == b.total_loops and a.n_bursts == b.n_bursts
            and torch.equal(a.graph.edge_i.cpu(), b.graph.edge_i)
            and torch.equal(a.graph.edge_j.cpu(), b.graph.edge_j))
    print(f"full card vs CPU, {n} scans: {int(a.graph.n_kf)} keyframes, {n_e} edges, "
          f"{a.total_loops} loops, {a.n_bursts} bursts on the card; the same graph structure on "
          f"the CPU: {same}; max|pose diff| of the corrected trajectory {diff:.3e} (tol 1e-3)",
          flush=True)
    check(a.total_loops >= 1 and a.n_bursts >= 1, "full card vs CPU: no loop closed")
    check(same, "full card vs CPU: the graphs differ in structure")
    check(diff <= 1e-3, f"full card vs CPU: trajectories disagree: {diff}")


def gmapping_config(**kwargs):
    """bench.py's ``gmapping`` preset: ``fast_config(n_particles=30,
    map_size=256)``."""
    from slam_constructor_tpu_torch.models import gmapping

    return gmapping.fast_config(n_particles=GM_PARTICLES, map_size=MAP, **kwargs)


def run_gmapping_path(cfg, scans, odom, gt, sync_mode, draws=None, device=None):
    """One RBPF run from a fresh state through ``GMappingEngine.run``; the
    engine takes the card unless a device is named. Returns the engine,
    the best particle's trajectory, Neff and the seconds."""
    from slam_constructor_tpu_torch.models import gmapping

    e = gmapping.GMappingEngine(cfg, device=device, seed=0)
    on_card = e.device.type == "cuda"
    check(device is not None or on_card, f"GMappingEngine defaulted to {e.device}, not the card")
    e.state.poses = gt[0].to(e.device).expand(cfg.n_particles, 3).clone()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(sync_mode)
    t0 = time.perf_counter()
    try:
        traj, neffs = e.run(scans, odom, draws=draws)
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    return e, traj, neffs, time.perf_counter() - t0


def capture_particle_matches(cfg, scans, odom, gt, every=32):
    """A run of the gmapping path (it also warms the path up) that keeps
    the arguments of every ``every``-th particle match: the windows read in
    place (``mc_match_windows``)."""
    from slam_constructor_tpu_torch.ops import kernels

    recording, kept = recorder(kernels.mc_match_windows, every)
    with handed_in(recording, "mc_match_windows"):
        run_gmapping_path(cfg, scans, odom, gt, 0)
    return kept


def cut_out(a):
    """The args of ``mc_match_batched`` for the args ``a`` of
    ``mc_match_windows``: each window cut out of its map, where(known, occ,
    unknown), as ``kernels.mc_match_windows_ref`` does."""
    from slam_constructor_tpu_torch.ops import grid as gridlib

    occ, known, row, col, sh, sw = a[:6]
    plane = torch.where(gridlib.take_window(known, row, col, sh, sw),
                        gridlib.take_window(occ, row, col, sh, sw), a[12])
    return (plane.contiguous(), *a[6:])


def window_cases(states, dev):
    """(name, args of mc_match_windows): the captured states, the windows
    clamped at each of the map's four edges and corners, a window as large
    as the map, and the occupancy as a channel of the maps' cells."""
    from slam_constructor_tpu_torch.ops import grid as gridlib

    s = states[8]  # scan 256, on the second lap of the rectangle
    cases = [(f"gmapping scan {32 * i}, in place", a) for i, a in enumerate(states)]
    occ, known, _, _, sh, sw = s[:6]
    h, w = occ.shape[1:]
    scale = s[11]
    # the maps' origin, as gridlib.make_grid_map centres them
    map_origin = torch.tensor([-w * scale / 2.0, -h * scale / 2.0], device=dev).expand(
        occ.shape[0], 2).contiguous()
    far = 2.0 * max(h, w) * scale
    for name, dx, dy in (("left edge", -1, 0), ("right edge", 1, 0), ("bottom edge", 0, -1),
                         ("top edge", 0, 1), ("bottom-left corner", -1, -1),
                         ("bottom-right corner", 1, -1), ("top-left corner", -1, 1),
                         ("top-right corner", 1, 1)):
        centre = s[9][:, :2] + torch.tensor([dx * far, dy * far], device=dev)
        row, col, origin = gridlib.window_corner(map_origin, centre, scale, sh, sw, h, w)
        cases.append((f"windows clamped at the map's {name}",
                      (occ, known, row, col, sh, sw, s[6], s[7], origin, *s[9:])))
    zero = torch.zeros_like(s[2])
    cases.append((f"a window as large as the map ({h}x{w})",
                  (occ, known, zero, zero, h, w, s[6], s[7], map_origin, *s[9:])))
    cells = torch.stack([occ, known.to(torch.float32)], -1)  # as a Bayes cell map holds them
    cases.append(("occupancy a channel of the maps' cells", (cells[..., 0], cells[..., 1] > 0, *s[2:])))
    return cases


def particle_cases(states, dev):
    """(name, args of mc_match_batched): the captured states' windows cut
    out, and edge cases."""
    g = torch.Generator(device=dev).manual_seed(11)
    states = [cut_out(a) for a in states]
    cases = [(f"gmapping scan {32 * i}, cut out", a) for i, a in enumerate(states)]
    s = states[8]  # scan 256, on the second lap of the rectangle

    def with_p_noise(a, rounds, batch):
        noise = torch.randn((a[0].shape[0], rounds, batch, 3), generator=g, device=dev)
        return a[:5] + (noise,) + a[6:]

    def sliced(a, sl):
        return tuple(t[sl].contiguous() for t in a[:6]) + a[6:]

    for batch in (1, 13, 64, 100):
        cases.append((f"K={batch}", with_p_noise(s, 5, batch)))
    cases.append(("0 rounds", with_p_noise(s, 0, 20)))
    no_beam = s[2].clone()
    no_beam[3] = 0.0
    cases.append(("particle 3 without a valid beam", s[:2] + (no_beam,) + s[3:]))
    cases.append(("P=1", sliced(s, slice(0, 1))))
    wide = tuple(torch.cat([states[4][i], states[8][i], states[12][i][:4]]) for i in range(6))
    cases.append(("P=64 (three scans' particles)", wide + s[6:]))
    return cases


def phase_particle_match(dev, states):
    """The particle match: `mc_match_windows` (the windows read in place,
    the main path's form) against `mc_match_batched` on the same windows
    cut out, against P single `mc_match` launches and `mc_match_rounds`
    (all bit for bit), on states of the gmapping path and edge cases; then
    `mc_match_batched` on the cut-out windows and edge cases against the
    same and against its plain twin; then timed at the path's shape, in
    turns with the windows cut out and matched (the path's form before they
    were read in place). Returns the `kernels` entry without the
    launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    s = states[8]
    check((tuple(s[0].shape), s[4:6], tuple(s[6].shape), tuple(s[10].shape)) ==
          ((GM_PARTICLES, MAP, MAP), (160, 160), (GM_PARTICLES, 180, 2), (GM_PARTICLES, 5, 20, 3)),
          f"the gmapping match reads {tuple(s[0].shape)} maps, {s[4:6]} windows, pts "
          f"{tuple(s[6].shape)}, noise {tuple(s[10].shape)}: not 30 maps of 256^2, 160^2 windows, "
          f"180 beams and 5 rounds of 20")

    def singles_of(fn, args):
        n_p = args[0].shape[0]
        out = [fn(*(t[m] for t in args[:6]), *args[6:]) for m in range(n_p)]
        return [torch.stack([o[i] for o in out]) for i in range(3)]

    def held(name, got, args, what):
        for i, part in enumerate(("pose", "prob", "trace")):
            for ref, by in ((singles_of(kernels.mc_match, args), "single-plane mc_match launches"),
                            (singles_of(kernels.mc_match_rounds, args), "mc_match_rounds")):
                check(torch.equal(bits(got[i]), bits(ref[i])),
                      f"{what} {part} differs from {by} ({name}): max |diff| "
                      f"{float((got[i] - ref[i]).abs().nan_to_num(nan=0.0).max()) if ref[i].numel() else 0}")

    n_in_place = 0
    for name, args in window_cases(states, dev):
        got = kernels.mc_match_windows(*args)
        cut = cut_out(args)
        want = kernels.mc_match_batched(*cut)
        torch.cuda.synchronize()
        n_p, n_rounds, k = args[10].shape[:3]
        check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)),
              f"mc_match_windows differs from mc_match_batched on the cut-out windows ({name})")
        held(name, got, cut, "mc_match_windows")
        n_in_place += n_p
        print(f"mc_match_windows [{name}]: P={n_p} K={k} rounds={n_rounds} R'={args[6].shape[1]} "
              f"{args[4]}x{args[5]} windows of {args[0].shape[1]}x{args[0].shape[2]} maps (cell "
              f"stride {args[0].stride(-1)}), rows {int(args[2].min())}..{int(args[2].max())}, cols "
              f"{int(args[3].min())}..{int(args[3].max())}: equal to mc_match_batched on the cut-out "
              f"windows, {n_p} single launches and mc_match_rounds bit for bit", flush=True)

    max_err, parted, n_matches = 0.0, 0, 0
    cases = particle_cases(states, dev)
    for name, args in cases:
        n_p, n_rounds, k = args[5].shape[:3]
        got = kernels.mc_match_batched(*args)
        twin, margins = twin_record(args)
        torch.cuda.synchronize()
        check(got[0].shape == (n_p, 3) and got[1].shape == (n_p,) and got[2].shape == (n_p, n_rounds),
              f"mc_match_batched output malformed ({name})")
        held(name, got, args, "mc_match_batched")
        errs = [against_twin(f"{name}, particle {m}", [t[m] for t in got], [t[m] for t in twin],
                             margins[m]) for m in range(n_p)]
        err = max(e for e, _ in errs)
        parted += sum(a for _, a in errs)
        n_matches += n_p
        max_err = max(max_err, err)
        print(f"mc_match_batched [{name}]: P={n_p} K={k} rounds={n_rounds} R'={args[1].shape[1]} "
              f"{args[0].shape[1]}x{args[0].shape[2]} equal to {n_p} single launches and to "
              f"mc_match_rounds bit for bit; vs plain twin max|diff|={err:.3e} (tol {TOL:g})",
              flush=True)
    no_beam = dict(cases)["particle 3 without a valid beam"]
    check(not bool(kernels.mc_match_batched(*no_beam)[2][3].any()),
          "a particle with no valid beam must score 0")
    print(f"particle match: {n_in_place} matches in place equal to the cut-out windows; "
          f"{len(cases)} cases, {n_matches} matches of mc_match_batched equal to single launches "
          f"bit for bit; {parted} part from the plain twin after a round decided by less than "
          f"{KNIFE_EDGE:g}", flush=True)

    cut = cut_out(s)
    # in turns: windows cut out and matched, in place, in place, cut out and matched
    ms, cut_path_ms, chained = time_pair(lambda: kernels.mc_match_windows(*s),
                                         lambda: kernels.mc_match_batched(*cut_out(s)))
    cut_ms, cut_plain_ms, cut_chained = time_pair(lambda: kernels.mc_match_batched(*cut),
                                                  lambda: kernels.mc_match_ref(*cut), plain_calls=10)
    plain_ms = statistics.median(time_ms(lambda: kernels.mc_match_windows_ref(*s), 20))
    singles_ms = statistics.median(time_ms(lambda: singles_of(kernels.mc_match, cut), 20))
    n_p, n_rounds, k = s[10].shape[:3]
    sh, sw = s[4:6]
    # every input read once (each window's occupancy and mask once, its
    # corner, the scan, origin, prior and noise), poses, probs and traces
    # written once; the operations of the beams that carry weight
    scan_bytes = 4 * (sum(a.numel() for a in s[6:11]) + n_p * (3 + 1 + n_rounds))
    n_bytes = n_p * sh * sw * (4 + 1) + 8 * 2 * n_p + scan_bytes
    cut_bytes = 4 * cut[0].numel() + scan_bytes
    n_ops = OVERLAP_OPS_PER_POINT * (1 + n_rounds * k) * int((s[7] != 0).sum())
    b_ms, by = bound_ms(n_bytes, n_ops)
    cut_b_ms, cut_by = bound_ms(cut_bytes, n_ops)
    print(f"mc_match_windows P={n_p} K={k} rounds={n_rounds} R'=180 {sh}x{sw} windows read in place: "
          f"kernel {ms:.4f} ms, plain (cut, where, mc_match_ref) {plain_ms:.4f} ms, the windows cut "
          f"out and matched {cut_path_ms:.4f} ms (medians of 100, 20 and 100 calls in turns, CUDA "
          f"events), kernel {chained:.4f} ms a launch over 200 back to back; bound {b_ms:.6f} "
          f"ms by {by} ({n_bytes} B, {n_ops} operations). mc_match_batched on the cut-out windows: "
          f"{cut_ms:.4f} ms, plain {cut_plain_ms:.4f} ms, {cut_chained:.4f} ms chained, bound "
          f"{cut_b_ms:.6f} ms by {cut_by} ({cut_bytes} B); {n_p} single-plane mc_match launches "
          f"{singles_ms:.4f} ms (median of 20); no single PyTorch call computes it", flush=True)
    return {
        "name": "mc_match_batched", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/mc_match.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "max_abs_err": max_err, "cases_bitwise_equal_to_single_launches": len(cases),
        "matches_in_place_equal_to_cut_out": n_in_place, "matches_parted_from_twin": parted,
        "ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "cut_out_path_ms": cut_path_ms,
        "cut_out_ms": cut_ms, "cut_out_chained_ms": cut_chained, "cut_out_bound_ms": cut_b_ms,
        "single_launches_ms": singles_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def gmapping_bits(e):
    """The RBPF's genealogy, weights and maps, for comparing two runs."""
    return [*e.genealogy, e.state.log_weights, e.state.gm.cells, e.state.poses]


def phase_gmapping_path(cfg, scans, odom, gt, odo_ate, smi):
    """The timed RBPF run with the counts at 0 before and read after, its
    checks, and once more for repeatability; returns the launch counts."""
    from slam_constructor_tpu_torch.models import gmapping
    from slam_constructor_tpu_torch.ops import scoring
    from slam_constructor_tpu_torch.utils import evaluate

    # the match reads the windows in place: nothing cuts one out
    cuts, views = (recorder(scoring.WindowView.cut), recorder(scoring.window_view))
    with handed_in(cuts[0], "cut", scoring.WindowView), handed_in(views[0], "window_view", scoring):
        reset_launches()
        e, traj, neffs, secs = run_gmapping_path(cfg, scans, odom, gt, "error")
        launches = read_launches()
    want = expect(mc_match_batched=N_SCANS)
    resamples = int((e.genealogy[1] != torch.arange(cfg.n_particles, device=traj.device)).any(1).sum())
    print(f"gmapping main path ({cfg.n_particles} particles): {N_SCANS} scans in {secs:.3f} s = "
          f"{N_SCANS / secs:.1f} scans/s on {smi}, with the sync check on, no host sync; "
          f"{resamples} resamplings, min Neff {float(neffs.min()):.2f}; launches {launches} "
          f"(expected {want}); windows cut out for the match: {len(cuts[1]) + len(views[1])}",
          flush=True)
    check(launches == want, f"gmapping: launches {launches}, expected {want}")
    check(not cuts[1] and not views[1], "gmapping: the match windows were cut out, not read in place")
    winner = e.winner_trajectory()
    check(winner.shape == (N_SCANS, 3) and bool(torch.isfinite(winner).all())
          and bool(torch.isfinite(traj).all()), "gmapping: non-finite poses")
    check(bool(torch.isfinite(e.occupancy).all()) and e.occupancy.shape == (MAP, MAP),
          "gmapping: the map is malformed")
    ate = float(evaluate.ate(winner, gt, align=False))
    online = float(evaluate.ate(traj, gt, align=False))
    mean = float(evaluate.ate(gmapping.weighted_mean_trajectory(*e.genealogy, e.state.log_weights),
                              gt, align=False))
    limit = max(GMAPPING_REFERENCE_ATE_BY_KEY) + GMAPPING_ATE_MARGIN
    print(f"gmapping main path: winner ATE {ate:.4f} m (no alignment; limit: the reference's worst "
          f"key + margin {limit:.4f}; the reference's five keys "
          f"{min(GMAPPING_REFERENCE_ATE_BY_KEY):.4f}-{max(GMAPPING_REFERENCE_ATE_BY_KEY):.4f}), online "
          f"(best particle a scan) {online:.4f} m, weighted mean {mean:.4f} m, odometry only "
          f"{odo_ate:.4f} m (the reference does not beat it on this sequence either)", flush=True)
    check(ate <= limit, f"gmapping: winner ATE {ate} above the reference's worst key + margin")
    e2, traj2, _, secs2 = run_gmapping_path(cfg, scans, odom, gt, 0)
    same = torch.equal(traj2, traj) and all(
        torch.equal(a, b) for a, b in zip(gmapping_bits(e), gmapping_bits(e2)))
    print(f"gmapping repeatability: trajectory, genealogy, log-weights and maps of two runs equal: "
          f"{same}; second run, sync check off: {N_SCANS / secs2:.1f} scans/s", flush=True)
    check(same, "gmapping: two runs differ")
    return launches


def phase_gmapping_quality(cfg, dev):
    """The gmapping path over the reference's quality sequence (two laps):
    the winner's ATE below odometry's and within the reference's worst of
    five keys + margin on the same sequence."""
    from slam_constructor_tpu_torch.utils import evaluate

    scans, odom, gt = gmapping_quality_sequence(dev)
    e, traj, _, secs = run_gmapping_path(cfg, scans, odom, gt, 0)
    ate = float(evaluate.ate(e.winner_trajectory(), gt, align=False))
    odo = float(evaluate.ate(odometry_trajectory(gt[0], odom), gt, align=False))
    limit = max(GMAPPING_2LAP_REFERENCE_ATE_BY_KEY) + GMAPPING_ATE_MARGIN
    print(f"gmapping, the reference's quality sequence ({len(gt)} scans, two laps): winner ATE "
          f"{ate:.4f} m (limits: odometry {odo:.4f}, the reference's worst key + margin "
          f"{limit:.4f}), online {float(evaluate.ate(traj, gt, align=False)):.4f} m; "
          f"{len(gt) / secs:.1f} scans/s", flush=True)
    check(ate < odo, f"gmapping 2 laps: winner ATE {ate} not below odometry's {odo}")
    check(ate <= limit, f"gmapping 2 laps: winner ATE {ate} above the reference's worst key + margin")


def phase_gmapping_improved(dev, scans, odom, gt):
    """64 scans of the gmapping path with the improved proposal and the
    minimumScore gate on: `overlap_score_batched` at M = 30 scores the
    probes (K = 16) and the gate (K = 1) every scan; every 8th launch of
    each is held to its twin and to 30 single-plane launches. Returns the
    launch counts and the batched kernel's times at the probes' shape."""
    import warnings

    from slam_constructor_tpu_torch.ops import kernels

    n = GM_IMPROVED_SCANS
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the preset's note on the improved proposal
        cfg = dataclasses.replace(gmapping_config(proposal="improved"),
                                  min_match_prob=GM_IMPROVED_GATE)
    match_probs, match = [], kernels.mc_match_batched

    def matched(*args):
        out = match(*args)
        match_probs.append(out[1])
        return out

    batched, kept = recorder(kernels.overlap_score_batched)
    with handed_in(batched, "overlap_score_batched"), handed_in(matched, "mc_match_batched"):
        reset_launches()
        _, traj, _, secs = run_gmapping_path(cfg, scans[:n], odom[:n], gt, "error")
        launches = read_launches()
    want = expect(overlap_score_batched=2 * n, mc_match_batched=n)
    print(f"gmapping, improved proposal and gate {GM_IMPROVED_GATE}, {n} scans: {n / secs:.1f} "
          f"scans/s with the sync check on; launches {launches} (expected {want})", flush=True)
    check(launches == want, f"gmapping improved: launches {launches}, expected {want}")
    check(bool(torch.isfinite(traj).all()), "gmapping improved: non-finite poses")
    probes = [a for a in kept if a[1].shape[1] == cfg.proposal_samples]
    gates = [a for a in kept if a[1].shape[1] == 1]
    check(len(probes) == n and len(gates) == n, "the improved path scored no probes or no gate")
    turned = float((torch.stack(match_probs) < GM_IMPROVED_GATE).float().mean())
    print(f"the gate turned back {turned:.3f} of the particles' matches", flush=True)
    max_err = 0.0
    for name, group in (("probes K=16", probes), ("gate K=1", gates)):
        for a in group[::8]:
            got = kernels.overlap_score_batched(*a)
            want_t = kernels.overlap_score_ref(*a)
            singles = torch.stack([kernels.overlap_score(*(t[m].contiguous() for t in a[:5]), *a[5:])
                                   for m in range(a[0].shape[0])])
            torch.cuda.synchronize()
            err = float((got - want_t).abs().max())
            check(err <= TOL, f"overlap_score_batched disagrees with its twin ({name}): {err}")
            check(torch.equal(bits(got), bits(singles)),
                  f"overlap_score_batched differs from single-plane launches ({name})")
            max_err = max(max_err, err)
        a = group[0]
        print(f"overlap_score_batched on the improved path [{name}]: M={a[0].shape[0]} "
              f"K={a[1].shape[1]} R'={a[2].shape[1]} {a[0].shape[1]}x{a[0].shape[2]}, "
              f"{len(group[::8])} launches: max|diff| to the twin {max_err:.3e} (tol {TOL:g}); equal "
              f"to {a[0].shape[0]} single-plane launches bit for bit", flush=True)
    times = {}
    for name, a in (("probes", probes[-1]), ("gate", gates[-1])):
        ms, plain_ms, chained = time_pair(lambda: kernels.overlap_score_batched(*a),
                                          lambda: kernels.overlap_score_ref(*a))
        n_m, k = a[1].shape[:2]
        n_bytes = 4 * (sum(t.numel() for t in a[:5]) + n_m * k)
        n_ops = OVERLAP_OPS_PER_POINT * k * int((a[3] != 0).sum())
        b_ms, by = bound_ms(n_bytes, n_ops)
        print(f"overlap_score_batched M={n_m} K={k} R'=180 160^2 (the {name}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, kernel {chained:.4f} ms a launch over 200 back to back; "
              f"bound {b_ms:.6f} ms by {by} ({n_bytes} B, {n_ops} operations)", flush=True)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "bound_ms": b_ms,
                       "bound_by": by}
    return launches, {**times, "max_abs_err": max_err}


def phase_gmapping_card_vs_cpu(dev, scans, odom, gt):
    """The first 16 scans of the gmapping path on the card and on the CPU
    with the same draws (made with numpy)."""
    from slam_constructor_tpu_torch.models import gmapping

    n = 16
    cfg = gmapping_config()
    mc, p = cfg.matcher_cfg, cfg.n_particles
    rng = np.random.default_rng(5)

    def normals(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    draws = gmapping.Draws(proposal=normals(n, p, 3), match=normals(n, p, mc.rounds, mc.batch, 3),
                           u0=torch.from_numpy(rng.uniform(0, 1 / p, n).astype(np.float32)))
    runs = []
    for d in (None, "cpu"):
        on = torch.device(d) if d else dev
        e, _, _, _ = run_gmapping_path(cfg, scans[:n].to(on), odom[:n].to(on), gt.to(on), 0,
                                       draws=draws, device=d)
        runs.append([t.cpu() for t in gmapping_bits(e)])
    (pa, aa, la, ca, _), (pb, ab, lb, cb, _) = runs
    diff = float((pa - pb).abs().max())
    # a free sample on a cell's border may fall to either side (sin and cos
    # round differently): that cell's count then differs by one for good
    moved = ca[..., -1] != cb[..., -1]
    belief = float((ca[..., :-1] - cb[..., :-1]).abs().amax(-1)[~moved].max())
    print(f"gmapping card vs CPU, {n} scans, the same draws: max|pose diff| {diff:.3e} (tol 1e-4), "
          f"ancestors equal: {torch.equal(aa, ab)}, max|log-weight diff| "
          f"{float((la - lb).abs().max()):.3e} (tol 1e-4); {int(moved.sum())} of {moved.numel()} "
          f"cells counted one sample more or less (at most {GM_MOVED_CELLS}), max|belief diff| "
          f"elsewhere {belief:.3e} (tol 1e-5)", flush=True)
    check(diff <= 1e-4 and torch.equal(aa, ab), "gmapping card vs CPU: trajectories disagree")
    check(float((la - lb).abs().max()) <= 1e-4, "gmapping card vs CPU: weights disagree")
    check(int(moved.sum()) <= GM_MOVED_CELLS and belief <= 1e-5, "gmapping card vs CPU: maps disagree")


# --- M3RSM: the pyramid (K4a), the level score (K4b) and their paths ---------


def snapshot(search):
    """A copy of an ``M3RSMSearch``'s tensors, the pyramid packed into one
    buffer as the kernels lay it out, so that later steps cannot change
    what was kept."""
    buf = torch.cat([p.reshape(-1) for p in search.planes])
    planes = tuple(v.view(p.shape) for v, p in zip(
        buf.split([p.numel() for p in search.planes]), search.planes))
    tensors = {f.name: getattr(search, f.name).clone() for f in dataclasses.fields(search)
               if isinstance(getattr(search, f.name), torch.Tensor)}
    return dataclasses.replace(search, planes=planes, **tensors)


def search_recorder(keep=lambda n: True):
    """``kernels.m3rsm_search`` with a snapshot of the arguments of every
    call ``n`` for which ``keep(n)`` holds: returns the stand-in and the list
    it fills."""
    from slam_constructor_tpu_torch.ops import kernels

    fn, kept, n = kernels.m3rsm_search, [], [0]

    def recording(search):
        if keep(n[0]):
            kept.append(snapshot(search))
        n[0] += 1
        return fn(search)

    return recording, kept


def capture_m3rsm_searches(cfg, scans, odom, gt, every=32):
    """A run of the viny_m3rsm path (it also warms the path up) that keeps
    the arguments of the match of every ``every``-th scan; returns them and
    the run's engine."""
    recording, kept = search_recorder(lambda n: n % every == 0)
    with handed_in(recording, "m3rsm_search"):
        _, _, _, e = run_main_path(cfg, scans, odom, gt, 0)
    return kept, e


def level_launches_of(searches):
    """The arguments of the level-score launches of ``m3rsm_search_levels``
    on each kept match, in order (levels + 1 a match)."""
    from slam_constructor_tpu_torch.ops import kernels

    recording, kept = recorder(kernels.m3rsm_score_level)
    with handed_in(recording, "m3rsm_score_level"):
        for search in searches:
            kernels.m3rsm_search_levels(search)
    return kept


def capture_full_m3rsm(cfg, scans, odom, gt):
    """A run of the full path with the M3RSM loop matcher (it also warms the
    path up) that keeps the arguments of every pyramid build of the submaps
    and of every loop match."""
    from slam_constructor_tpu_torch.ops import kernels

    recording, builds = recorder(kernels.m3rsm_pyramid)
    searching, matches = search_recorder()
    with handed_in(recording, "m3rsm_pyramid"), handed_in(searching, "m3rsm_search"):
        run_full_path(cfg, scans, odom, gt, 0)
    return builds, matches


def graph_ms(fn, n: int = 50, replays: int = 5) -> float:
    """ms a call with ``n`` calls of ``fn`` captured into one CUDA graph and
    replayed (the median over ``replays``): the device's time a launch with
    the gap between two launches, and no host in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up where the capture will run
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def pyramid_bytes(n_cells: int, stored: int, read_per_cell: int = 5) -> int:
    """Bytes a pyramid build or refresh must move: the occupancy (4 B) and
    the mask (1 B) of each level-0 cell read once, every level's cells
    (``stored``, f32) written once."""
    return read_per_cell * n_cells + 4 * stored


def pyramid_ops(n_cells: int, stored: int) -> int:
    """f32 operations of a pyramid: the where of a level-0 cell, three
    maxes a coarser cell."""
    return n_cells + 3 * (stored - n_cells)


def phase_m3rsm_pyramid_kernel(dev, gm, model, kept_builds):
    """K4a against its plain twin, bit for bit: the main path's 256^2 map at
    4 levels, the loop closer's kept submap builds (M up to 32 of 120^2 at 3
    levels), the occupancy as a channel of the cells, an unaligned 100 x 90
    map at 5 levels; the 144^2 refresh clamped at every corner and edge and
    in the middle, and a gate at 0 that leaves the planes untouched. Then
    timed. Returns the `kernels` entry without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels, scoring

    g = torch.Generator(device=dev).manual_seed(11)
    view = scoring.MapView.of(gm, model)
    occ, known = view.occ.contiguous(), view.known.contiguous()
    check(kept_builds, "the loop closer built no submap pyramid")
    widest = max(kept_builds, key=lambda a: a[0].shape[0])
    check(tuple(widest[0].shape) == (32, 120, 120) and widest[2] == 3,
          f"the widest submap build is {tuple(widest[0].shape)} at {widest[2]} levels")
    rand_occ = torch.rand((100, 90), generator=g, device=dev)
    rand_known = torch.rand((100, 90), generator=g, device=dev) < 0.7
    cells = torch.stack([occ, torch.zeros_like(occ)], dim=-1)
    builds = [("main path map 256^2, 4 levels", (occ, known, 4, 0.5)),
              ("the occupancy a channel of the cells", (cells[..., 0], known, 4, 0.5)),
              ("unaligned 100 x 90, 5 levels", (rand_occ, rand_known, 5, 0.5)),
              ("3 levels on a 256^2 map", (occ, known, 3, 0.5))]
    builds += [(f"loop closer's submaps, M={a[0].shape[0]}", a) for a in kept_builds[::4]]
    for name, a in builds:
        got = kernels.m3rsm_pyramid(*a)
        want = kernels.m3rsm_pyramid_ref(*a)
        torch.cuda.synchronize()
        same = len(got) == len(want) and all(torch.equal(bits(x), bits(y))
                                             for x, y in zip(got, want))
        print(f"m3rsm_pyramid build [{name}]: {tuple(a[0].shape)} {a[2]} levels, equal to the "
              f"plain twin bit for bit: {same}", flush=True)
        check(same, f"m3rsm_pyramid differs from its twin ({name})")
    planes = kernels.m3rsm_pyramid(occ, known, 4, 0.5)
    edited = torch.where(torch.rand(occ.shape, generator=g, device=dev) < 0.3, 0.97, occ)
    size, top = 144, MAP - 1
    centres = [(128, 128), (0, 0), (0, top), (top, 0), (top, top), (0, 128), (top, 128),
               (128, 0), (128, top)]
    kept = [p.clone() for p in planes]
    for c in centres:
        center = torch.tensor(c, device=dev)
        for gate in (1.0, 0.0):
            gate_t = torch.full((), gate, device=dev)
            got = kernels.m3rsm_pyramid_update(planes, edited, known, center, size, 0.5, gate_t)
            want = kernels.m3rsm_pyramid_update_ref(planes, edited, known, center, size, 0.5,
                                                    gate_t)
            torch.cuda.synchronize()
            ok = all(torch.equal(bits(x), bits(y)) for x, y in zip(got, want))
            if gate == 0.0:
                ok = ok and all(torch.equal(bits(x), bits(y)) for x, y in zip(got, planes))
            check(ok, f"m3rsm_pyramid update at {c}, gate {gate}: differs from its twin")
            check(all(torch.equal(bits(x), bits(y)) for x, y in zip(planes, kept)),
                  f"m3rsm_pyramid update at {c}, gate {gate}: wrote into the planes handed in")
    print(f"m3rsm_pyramid update: a {size}^2 region of the 256^2 map at {len(centres)} centres "
          f"(every corner and edge, the middle) into new planes equal to the twin bit for bit; a "
          f"gate at 0 copied the planes; the planes handed in untouched", flush=True)

    center, gate_t = torch.tensor((128, 128), device=dev), torch.ones((), device=dev)
    stored0 = sum(p.numel() for p in planes)
    region = sum((size >> lvl) ** 2 for lvl in range(5))
    sub = widest[0].shape[0] * sum(((120 + (1 << lvl) - 1) >> lvl) ** 2 for lvl in range(4))
    shapes = {
        "build_256": ((lambda: kernels.m3rsm_pyramid(occ, known, 4, 0.5)),
                      (lambda: kernels.m3rsm_pyramid_ref(occ, known, 4, 0.5)),
                      occ.numel(), stored0),
        "update_144": ((lambda: kernels.m3rsm_pyramid_update(planes, edited, known, center,
                                                             size, 0.5, gate_t)),
                       (lambda: kernels.m3rsm_pyramid_update_ref(planes, edited, known, center,
                                                                 size, 0.5, gate_t)),
                       size * size, region),
        "build_32x120": ((lambda: kernels.m3rsm_pyramid(*widest)),
                         (lambda: kernels.m3rsm_pyramid_ref(*widest)),
                         widest[0].numel(), sub),
    }
    plane0 = torch.where(known, occ, 0.5)[None, None]

    def pooled():  # the yardstick: max_pool2d, which pads nothing, on an even map
        p = plane0
        for _ in range(4):
            p = torch.nn.functional.max_pool2d(p, 2)
        return p

    for _ in range(20):
        pooled()
    library_ms = statistics.median(time_ms(pooled, 100))
    library_device_ms = graph_ms(pooled)
    out = {}
    for name, (kernel, plain, n_cells, stored) in shapes.items():
        ms, plain_ms, chained = time_pair(kernel, plain, plain_calls=20)
        device = graph_ms(kernel)
        n_bytes = pyramid_bytes(n_cells, stored)
        if name == "update_144":  # new planes: the region pooled, the rest copied
            n_bytes = pyramid_bytes(n_cells, stored0) + 4 * (stored0 - region)
        b_ms, by = bound_ms(n_bytes, pyramid_ops(n_cells, stored))
        print(f"m3rsm_pyramid {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (medians, CUDA "
              f"events), kernel {chained:.4f} ms a launch over 200 back to back, {device:.4f} ms "
              f"a launch replayed from a CUDA graph; bound {b_ms:.6f} ms by {by} ({n_bytes} B)",
              flush=True)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "device_ms": device,
                     "bound_ms": b_ms, "bound_by": by}
    print(f"four chained torch.nn.functional.max_pool2d calls on the even 256^2 plane (the "
          f"yardstick, not the port): {library_ms:.4f} ms a call, {library_device_ms:.4f} ms "
          f"replayed from a CUDA graph", flush=True)
    return {
        "name": "m3rsm_pyramid", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/m3rsm_pyramid.cu",
        "replaces": "slam_constructor_tpu/ops/m3rsm.py:102",
        "max_abs_err": 0.0, **out["update_144"], "by_shape": out,
        "library_ms": library_ms, "library_device_ms": library_device_ms,
        "library_call": "4 chained torch.nn.functional.max_pool2d on the even 256^2 plane",
    }


#: f32 and integer operations of a (rect, beam) pair of `m3rsm_score_level`:
#: the cell 2, a corner 2 adds, 2 shifts, 4 compares and a max, the sums 3
def level_ops(level: int) -> int:
    return 2 + (4 if level else 1) * 9 + 3


def phase_m3rsm_level_kernel(dev, kept):
    """K4b against its plain twin (2e-6) on the arguments of every 32nd
    scan of the viny_m3rsm path at all five levels, and at edge cases: the
    window at the map's first and far corner, rects off the window, a mask
    of zeros; then timed at each level of a scan. Returns the `kernels`
    entry without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    levels = sorted({a[2] for a in kept})
    check(levels == [0, 1, 2, 3, 4], f"the path scored levels {levels}")
    per_scan = len(levels)
    cases = [(f"scan {32 * (i // per_scan)} level {a[2]}", a) for i, a in enumerate(kept)]
    scan_args = {a[2]: a for a in kept[8 * per_scan:9 * per_scan]}  # scan 256's five
    for lvl, a in scan_args.items():
        plane, corner, _, wh, ww, c0, cands, mask, unknown = a
        side = (wh << lvl)
        far = torch.full_like(corner, MAP - side)

        def edited(i, t, a=a):
            return a[:i] + (t,) + a[i + 1:]

        off = cands + torch.tensor([0, 64, -64], dtype=torch.int32, device=dev)
        mixed = cands + (torch.arange(cands.shape[1], device=dev) % 2 == 0)[None, :, None].int() * \
            torch.tensor([0, 200, 0], dtype=torch.int32, device=dev)
        cases += [(f"level {lvl}: the window at the map's first corner",
                   edited(1, torch.zeros_like(corner))),
                  (f"level {lvl}: the window at the map's far corner", edited(1, far)),
                  (f"level {lvl}: rects off the window", edited(6, off.contiguous())),
                  (f"level {lvl}: every other rect far off the window",
                   edited(6, mixed.contiguous())),
                  (f"level {lvl}: a mask of zeros", edited(7, torch.zeros_like(mask)))]
    max_err = 0.0
    for name, a in cases:
        got = kernels.m3rsm_score_level(*a)
        want = kernels.m3rsm_score_level_ref(*a)
        again = kernels.m3rsm_score_level(*a)
        torch.cuda.synchronize()
        check(got.shape == a[6].shape[:2] and bool(torch.isfinite(got).all()),
              f"m3rsm_score_level output malformed ({name})")
        err = float((got - want).abs().max())
        check(err <= TOL, f"m3rsm_score_level disagrees with its twin ({name}): {err}")
        check(torch.equal(bits(got), bits(again)), f"m3rsm_score_level not repeatable ({name})")
        if "zeros" in name:
            check(not bool(got.any()), "a mask of zeros must score 0")
        max_err = max(max_err, err)
    print(f"m3rsm_score_level: {len(cases)} cases ({len(kept)} kept from the path, every 32nd "
          f"scan at all five levels) within {max_err:.3e} of the plain twin (tol {TOL:g}), "
          f"repeatable bit for bit", flush=True)
    by_level, sums = {}, {"ms": 0.0, "plain_ms": 0.0, "chained_ms": 0.0, "bound_ms": 0.0}
    n_bytes_all = n_ops_all = 0
    for lvl in levels:
        a = scan_args[lvl]
        plane, corner, _, wh, ww, c0, cands, mask, _ = a
        ms, plain_ms, chained = time_pair(lambda: kernels.m3rsm_score_level(*a),
                                          lambda: kernels.m3rsm_score_level_ref(*a))
        k, r = cands.shape[1], mask.shape[1]
        # the window's cells, the endpoint cells, the rects, the mask and
        # the corner read once, the scores written once
        n_bytes = 4 * (wh * ww + c0.numel() + cands.numel() + mask.numel() + 2 + k)
        n_ops = k * r * level_ops(lvl)
        b_ms, by = bound_ms(n_bytes, n_ops)
        print(f"m3rsm_score_level level {lvl} K={k} R={r} window {wh}x{ww}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (median of 100 calls each, CUDA events), kernel "
              f"{chained:.4f} ms a launch over 200 back to back; bound {b_ms:.6f} ms by {by} "
              f"({n_bytes} B, {n_ops} operations); no single PyTorch call computes it", flush=True)
        by_level[lvl] = {"k": k, "ms": ms, "plain_ms": plain_ms, "chained_ms": chained,
                         "bound_ms": b_ms, "bound_by": by}
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("chained_ms", chained),
                       ("bound_ms", b_ms)):
            sums[key] += v
        n_bytes_all += n_bytes
        n_ops_all += n_ops
    return {
        "name": "m3rsm_level", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/m3rsm_level.cu",
        "replaces": "slam_constructor_tpu/ops/m3rsm.py:160",
        "max_abs_err": max_err, **sums, "bound_by": bound_ms(n_bytes_all, n_ops_all)[1],
        "shape": "a scan's five launches, levels 4 to 0", "by_level": by_level,
        "library_ms": None,
    }


def search_work(search):
    """(bytes, operations) an ``m3rsm_search`` call needs: every level's
    window (each request's, at most the maps' whole pyramids), the refine
    window's occupancy and mask, the endpoints, weights, rects and priors
    read once, the results written once; the endpoint cells of every theta,
    a level's (rect, beam) pairs for the beams that carry weight, a sort's
    K log2 K comparisons of a level that selects, and the hill climb's poses
    x weighted beams."""
    from slam_constructor_tpu_torch.ops import kernels

    levels = len(search.planes) - 1
    n_b = search.prior.shape[0]
    wh, ww = (search.window,) * 2 if search.window else tuple(search.occ.shape[-2:])
    window = n_b * sum(-(-wh // (1 << lvl)) * -(-ww // (1 << lvl)) for lvl in range(levels + 1))
    window = min(window, sum(p.numel() for p in search.planes))
    refine = min(n_b * wh * ww, search.occ.numel()) if search.iterations else 0
    small = (search.origin, search.pts, search.mask, search.top, search.thetas, search.prior)
    n_bytes = (4 * window + 5 * refine + 4 * sum(t.numel() for t in small)
               + 4 * n_b * (4 + search.iterations))
    ks = kernels.m3rsm_frontiers(search.top.shape[0], search.beam_width, levels)
    beams = int((search.mask != 0).sum())  # over the requests
    n_ops = n_b * search.thetas.shape[0] * search.mask.shape[1] * 12  # the endpoint cells
    n_ops += sum(k * beams * level_ops(levels - i) for i, k in enumerate(ks))
    n_ops += n_b * sum(int(k * math.log2(max(k, 2))) for k in ks[:-1])
    climbed = int((search.mask[:, ::search.stride] != 0).sum())
    n_ops += (1 + 6 * search.iterations) * climbed * OVERLAP_OPS_PER_POINT
    return n_bytes, n_ops


def m3rsm_search_cases(dev, path_searches, loop_searches, cfg, e, scans, gt):
    """(name, M3RSMSearch) of phase 22: the kept matches of the viny_m3rsm
    path and of the loop closer (every 4th), and edge cases on the path's
    final map."""
    from slam_constructor_tpu_torch.models import engine
    from slam_constructor_tpu_torch.ops import kernels, m3rsm, scoring
    from slam_constructor_tpu_torch.ops.scan import LaserScan
    from slam_constructor_tpu_torch.utils import datagen

    cases = [(f"viny_m3rsm scan {32 * i}", a) for i, a in enumerate(path_searches)]
    cases += [(f"full_m3rsm loop match {4 * i}, M={a.prior.shape[0]}", a)
              for i, a in enumerate(loop_searches[::4])]
    view = scoring.MapView.of(e.state.gm, cfg.cell_model)
    idx = list(range(0, N_SCANS, 64))
    priors = gt[idx] + torch.tensor([0.1, -0.05, 0.03], device=dev)
    batch = LaserScan(scans.ranges[idx], scans.bearings[idx], scans.valid[idx])
    pws = torch.stack([engine._point_weights(cfg, scans[i]) for i in idx])
    recording, kept = search_recorder()
    mc = cfg.matcher_cfg
    # M3RSMConfig's defaults (the whole map, 5 levels, 17 thetas, K up to
    # 1,024) with the path's scan and with a scan of 1,081 beams
    defaults = m3rsm.M3RSMConfig(scoring=scoring.ScoringConfig(reducer="overlap"))
    occ, origin, scale = datagen.cecum_world(device=dev)
    wide, _, _ = datagen.synth_sequence(occ, origin, scale, gt[idx[4]][None],
                                        datagen.default_bearings(1081, device=dev), rng=0)
    with handed_in(recording, "m3rsm_search"):
        m3rsm.m3rsm_match_many(view, batch, priors, mc, pws)
        m3rsm.m3rsm_match(view, scans[idx[4]], priors[4], None, dataclasses.replace(mc, window=0),
                          pws[4])
        m3rsm.m3rsm_match(view, scans[idx[4]], priors[4], None, defaults, pws[4])
        m3rsm.m3rsm_match(view, wide[0], priors[4], None, defaults, None)
    cases += [("8 requests on one map", kept[0]), ("window 0 (the whole 256^2 map)", kept[1]),
              ("M3RSMConfig's defaults", kept[2]),
              ("M3RSMConfig's defaults, 1081 beams", kept[3])]
    mid = path_searches[8]  # scan 256
    cases.append(("scan 256, refine 0", dataclasses.replace(mid, iterations=0)))
    unknown = torch.zeros_like(mid.known)
    planes = kernels.m3rsm_pyramid(mid.occ, unknown, len(mid.planes) - 1, mid.unknown)
    cases.append(("scan 256 on an all-unknown map",
                  dataclasses.replace(mid, planes=planes, known=unknown)))
    return cases


def twin_scores(search, pose):
    """The plain twin's score of each request's ``pose`` f32[B, 3] on its
    refine window (the hill climb's score)."""
    from slam_constructor_tpu_torch.ops import grid as gridlib
    from slam_constructor_tpu_torch.ops import kernels

    n_b = search.prior.shape[0]
    corner, (wh, ww), origin, _ = kernels.m3rsm_window_cells(search)
    occ = search.occ if search.occ.dim() == 3 else search.occ[None]
    known = search.known if search.known.dim() == 3 else search.known[None]
    occ, known = occ.expand(n_b, -1, -1), known.expand(n_b, -1, -1)
    row, col = corner[:, 0].long(), corner[:, 1].long()
    plane = torch.where(gridlib.take_window(known, row, col, wh, ww),
                        gridlib.take_window(occ, row, col, wh, ww), search.unknown)
    return kernels.overlap_score_ref(
        plane, pose[:, None, :].contiguous(), search.pts[:, ::search.stride].contiguous(),
        search.mask[:, ::search.stride].contiguous(), origin.contiguous(), search.scale,
        search.unknown)[:, 0]


def phase_m3rsm_search_kernel(dev, cases):
    """The whole match in one launch (K4b) against the level launches bit
    for bit and against its plain twin, then timed. Returns the `kernels`
    entry without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    max_err, parted = 0.0, []
    for name, a in cases:
        got = kernels.m3rsm_search(a)
        levels = kernels.m3rsm_search_levels(a)
        again = kernels.m3rsm_search(a)
        twin = kernels.m3rsm_search_ref(a)
        torch.cuda.synchronize()
        n_b = a.prior.shape[0]
        check(got[0].shape == (n_b, 3) and got[2].shape == (n_b, a.iterations)
              and bool(torch.isfinite(got[0]).all()), f"m3rsm_search output malformed ({name})")
        same = all(torch.equal(bits(x), bits(y)) for x, y in zip(got, levels))
        check(same, f"m3rsm_search differs from the level launches ({name})")
        check(all(torch.equal(bits(x), bits(y)) for x, y in zip(got, again)),
              f"m3rsm_search not repeatable ({name})")
        apart = (got[0] != twin[0]).any(-1)
        err = float((got[1] - twin[1]).abs()[~apart].max()) if bool((~apart).any()) else 0.0
        check(err <= TOL, f"m3rsm_search prob differs from its twin ({name}): {err}")
        if bool(apart.any()):
            # the two winners, each scored by the twin
            if a.iterations:
                gap = (twin_scores(a, got[0]) - twin[1]).abs()[apart]
            else:
                gap = (got[1] - twin[1]).abs()[apart]
            gap = float(gap.max())
            parted.append(f"{name} ({int(apart.sum())} of {n_b}, winners' scores {gap:.2e} apart)")
            check(gap <= TOL, f"m3rsm_search and its twin pick winners {gap} apart ({name})")
        max_err = max(max_err, err)
    print(f"m3rsm_search: {len(cases)} cases equal to the level launches bit for bit (pose, prob, "
          f"trace) and repeatable; prob within {max_err:.3e} of the plain twin where the poses "
          f"agree (tol {TOL:g}); other winners than the twin's: {parted or 'none'}", flush=True)

    out = {}
    timed = {"viny_m3rsm scan 256": cases[8][1],
             "full_m3rsm widest loop match": max((a for n, a in cases if n.startswith("full")),
                                                 key=lambda a: a.prior.shape[0])}
    for shape, a in timed.items():
        ms, plain_ms, chained = time_pair(lambda a=a: kernels.m3rsm_search(a),
                                          lambda a=a: kernels.m3rsm_search_ref(a), plain_calls=10)
        levels_ms = statistics.median(time_ms(lambda a=a: kernels.m3rsm_search_levels(a), 50))
        device = graph_ms(lambda a=a: kernels.m3rsm_search(a))
        n_bytes, n_ops = search_work(a)
        b_ms, by = bound_ms(n_bytes, n_ops)
        ks = kernels.m3rsm_frontiers(a.top.shape[0], a.beam_width, len(a.planes) - 1)
        print(f"m3rsm_search [{shape}] B={a.prior.shape[0]} K={ks} R={a.mask.shape[1]} "
              f"stride {a.stride}, {a.iterations} rounds: kernel {ms:.4f} ms a call, "
              f"{chained:.4f} ms chained, {device:.4f} ms replayed from a CUDA graph; the level "
              f"launches {levels_ms:.4f} ms a call; plain twin {plain_ms:.4f} ms; bound "
              f"{b_ms:.6f} ms by {by} ({n_bytes} B, {n_ops} operations); no single PyTorch "
              f"call computes it", flush=True)
        out[shape] = {"ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "device_ms": device,
                      "levels_ms": levels_ms, "bound_ms": b_ms, "bound_by": by}
    return {
        "name": "m3rsm_search", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/m3rsm_match.cu",
        "replaces": "slam_constructor_tpu/ops/m3rsm.py:210",
        "max_abs_err": max_err, **out["viny_m3rsm scan 256"], "by_shape": out,
        "library_ms": None,
    }


def phase_m3rsm_path(cfg, scans, odom, gt, odo_ate):
    """The viny_m3rsm main path: the timed run (counts, ATE, no host sync,
    a second run bit for bit) and its live pyramid against a rebuild of the
    map; returns the launch counts and the engine."""
    from slam_constructor_tpu_torch.ops import m3rsm, scoring

    levels = cfg.matcher_cfg.levels
    want = expect(m3rsm_search=N_SCANS, m3rsm_pyramid=N_SCANS + 1)
    launches, traj, e = phase_main_path("viny_m3rsm", cfg, want, scans, odom, gt, odo_ate,
                                        VINY_M3RSM_REFERENCE_ATE + VINY_ATE_MARGIN)
    rebuilt = m3rsm.build_pyramid(scoring.MapView.of(e.state.gm, cfg.cell_model), levels,
                                  cfg.matcher_cfg.scoring.unknown_prob)
    same = all(torch.equal(bits(a), bits(b)) for a, b in zip(e.state.pyramid, rebuilt))
    print(f"viny_m3rsm: the live pyramid after {N_SCANS} refreshes equal to a rebuild of the map "
          f"bit for bit: {same}", flush=True)
    check(same, "viny_m3rsm: the live pyramid differs from a rebuild")
    return launches, traj, e


def phase_m3rsm_levels_path(cfg, scans, odom, gt, traj):
    """The viny_m3rsm path with ``m3rsm_search_levels`` handed in in the
    kernel's place (a level-score launch a level, a batched score launch a
    hill-climb round): the same trajectory bit for bit; returns its
    launches."""
    from slam_constructor_tpu_torch.ops import kernels

    mc = cfg.matcher_cfg
    with handed_in(kernels.m3rsm_search_levels, "m3rsm_search"):
        reset_launches()
        got, _, secs, _ = run_main_path(cfg, scans, odom, gt, 0)
        launches = read_launches()
    want = expect(m3rsm_level=(mc.levels + 1) * N_SCANS, m3rsm_pyramid=N_SCANS + 1,
                  overlap_score_batched=(1 + mc.refine_iterations) * N_SCANS)
    diff = float((got - traj).abs().max())
    print(f"viny_m3rsm with a level launch a level and a score launch a hill-climb round: "
          f"{N_SCANS} scans at {N_SCANS / secs:.1f} scans/s; launches {launches} (expected "
          f"{want}); max|pose diff| to the one-launch match's run {diff:.3e}", flush=True)
    check(launches == want, f"viny_m3rsm levels path: launches {launches}, expected {want}")
    check(torch.equal(bits(got), bits(traj)),
          f"the one-launch match and the level launches give different trajectories: {diff}")
    return launches


def phase_m3rsm_match_many(cfg, e, scans, gt):
    """``m3rsm_match_many``: 8 requests (every 64th scan of the sequence,
    priors 0.1 m and 0.03 rad off) against the path's final map together,
    equal to 8 single calls bit for bit."""
    from slam_constructor_tpu_torch.models import engine
    from slam_constructor_tpu_torch.ops import m3rsm, scoring
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    view = scoring.MapView.of(e.state.gm, cfg.cell_model)
    idx = list(range(0, N_SCANS, 64))
    dev = gt.device
    priors = gt[idx] + torch.tensor([0.1, -0.05, 0.03], device=dev)
    batch = LaserScan(scans.ranges[idx], scans.bearings[idx], scans.valid[idx])
    pws = torch.stack([engine._point_weights(cfg, scans[i]) for i in idx])
    many = m3rsm.m3rsm_match_many(view, batch, priors, cfg.matcher_cfg, pws)
    singles = [m3rsm.m3rsm_match(view, scans[i], priors[b], None, cfg.matcher_cfg, pws[b])
               for b, i in enumerate(idx)]
    torch.cuda.synchronize()
    pose = torch.stack([s.pose for s in singles])
    prob = torch.stack([s.prob for s in singles])
    same = torch.equal(bits(many.pose), bits(pose)) and torch.equal(bits(many.prob), bits(prob))
    err = float((many.pose[:, :2] - gt[idx, :2]).abs().max())
    print(f"m3rsm_match_many: {len(idx)} requests on one map equal to {len(idx)} single calls bit "
          f"for bit: {same}; largest |x, y error| against the truth {err:.4f} m", flush=True)
    check(same, "m3rsm_match_many differs from single calls")


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    from slam_constructor_tpu_torch.models import tiny, viny
    from slam_constructor_tpu_torch.ops import _build
    from slam_constructor_tpu_torch.utils import evaluate

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)  # name, power limit

    res = _build.build()
    print(f"build: {res.path.name} in {res.seconds:.2f} s (nvcc, sm_90a)", flush=True)
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    _build.load()

    scans, odom, gt = bench_sequence(dev)
    k1 = phase_overlap_kernel(dev, scans, gt)
    k2 = phase_polar_kernel(dev, scans, gt)

    tiny_cfg, viny_cfg = tiny.tiny_config(map_size=MAP), viny.viny_config(map_size=MAP)
    gm_cfg = gmapping_config()
    k5 = phase_particle_match(dev, capture_particle_matches(gm_cfg, scans, odom, gt))
    fscans, fodom, fgt = full_sequence(dev)
    full_cfg = full_config()
    full_states, kept = capture_full_launches(full_cfg, fscans, fodom, fgt)
    k3 = phase_mc_match(dev, capture_match_states(tiny_cfg, scans, odom, gt),
                        capture_match_states(viny_cfg, scans, odom, gt), full_states)
    phase_card_vs_cpu("tiny", tiny_cfg, dev, scans, odom, gt)
    phase_card_vs_cpu("viny", viny_cfg, dev, scans, odom, gt)

    odo_ate = float(evaluate.ate(odometry_trajectory(gt[0], odom), gt, align=False))
    tiny_launches, _, _ = phase_main_path(
        "tiny", tiny_cfg, expect(mc_match=N_SCANS), scans, odom, gt, odo_ate, 0.15)
    viny_launches, viny_traj, _ = phase_main_path(
        "viny", viny_cfg, expect(mc_match=N_SCANS, polar_free_plane=N_SCANS),
        scans, odom, gt, odo_ate, max(VINY_REFERENCE_ATE_BY_KEY) + VINY_ATE_MARGIN)
    rounds_launches = phase_rounds_path(viny_cfg, scans, odom, gt, viny_traj)

    full_odo_ate = float(evaluate.ate(odometry_trajectory(fgt[0], fodom), fgt, align=False))
    full_launches = phase_full_path(full_cfg, fscans, fodom, fgt, full_odo_ate)
    k4 = phase_batched_kernel(dev, kept)
    phase_full_card_vs_cpu(dev)

    gm_launches = phase_gmapping_path(gm_cfg, scans, odom, gt, odo_ate, smi)
    phase_gmapping_quality(gm_cfg, dev)
    improved_launches, k4["rbpf_m30_k16_and_k1"] = phase_gmapping_improved(dev, scans, odom, gt)
    phase_gmapping_card_vs_cpu(dev, scans, odom, gt)

    m3_cfg = viny.viny_m3rsm_config(map_size=MAP)
    path_searches, m3_warm = capture_m3rsm_searches(m3_cfg, scans, odom, gt)
    m3_launches, m3_traj, m3_engine = phase_m3rsm_path(m3_cfg, scans, odom, gt, odo_ate)
    phase_card_vs_cpu("viny_m3rsm", m3_cfg, dev, scans, odom, gt, n=32)
    levels_launches = phase_m3rsm_levels_path(m3_cfg, scans, odom, gt, m3_traj)
    phase_m3rsm_match_many(m3_cfg, m3_engine, scans, gt)
    full_m3_cfg = full_m3rsm_config()
    builds, loop_searches = capture_full_m3rsm(full_m3_cfg, fscans, fodom, fgt)
    k8 = phase_m3rsm_search_kernel(dev, m3rsm_search_cases(
        dev, path_searches, loop_searches, m3_cfg, m3_engine, scans, gt))
    k7 = phase_m3rsm_level_kernel(dev, level_launches_of(path_searches))
    k6 = phase_m3rsm_pyramid_kernel(dev, m3_warm.state.gm, m3_cfg.cell_model, builds)
    full_m3_launches = phase_full_path(full_m3_cfg, fscans, fodom, fgt, full_odo_ate,
                                       name="full_m3rsm", reference=FULL_M3RSM_REFERENCE_ATE_BY_KEY,
                                       hold_to_tracker=False)

    # `launches`: of a main path's timed run, held to the expected counts
    # above: the viny path's for the kernels of the earlier slices, the full
    # path's for the batched score, the gmapping path's for the particle
    # match, the viny_m3rsm path's for the M3RSM kernels. `overlap_score`
    # and `m3rsm_level` left the main paths (for `score_poses` and the
    # whole match), so they read 0 there; the paths driven with their
    # yardsticks handed in stand under `launches_by_path` only
    main_path = {"overlap_score_batched": full_launches, "mc_match_batched": gm_launches,
                 "overlap_score": m3_launches, "m3rsm_pyramid": m3_launches,
                 "m3rsm_level": m3_launches, "m3rsm_search": m3_launches}
    for k in (k1, k3, k2, k4, k5, k6, k7, k8):
        k["launches"] = main_path.get(k["name"], viny_launches)[k["name"]]
        k["launches_by_path"] = {
            "tiny": tiny_launches[k["name"]], "viny": viny_launches[k["name"]],
            "full": full_launches[k["name"]], "gmapping": gm_launches[k["name"]],
            "viny_m3rsm": m3_launches[k["name"]], "full_m3rsm": full_m3_launches[k["name"]],
            f"viny, one overlap_score launch a round, {ROUNDS_PATH_SCANS} scans":
                rounds_launches[k["name"]],
            f"gmapping, improved proposal, {GM_IMPROVED_SCANS} scans": improved_launches[k["name"]],
            "viny_m3rsm, a level launch a level and a score launch a round":
                levels_launches[k["name"]]}
    print(json.dumps({"kernels": [k1, k3, k2, k4, k5, k6, k7, k8]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
