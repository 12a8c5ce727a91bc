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
5. ``mc_match`` (one launch a match) against ``mc_match_rounds`` (one
   ``overlap_score`` launch a round) on the card: (map, scan, prior) states
   taken from every 32nd scan of a tiny and a viny run over the bench
   sequence, plus edge cases (batch 8 to 100, 0 and 1 rounds, no valid
   beam, a prior 0.5 m from the map's edge, noise of zeros, duplicated
   candidates, a NaN weight): pose, prob and trace must be equal bit for
   bit. The same cases against the plain twin ``mc_match_ref``: trace and
   prob within 2e-6, or, where the two part, a round before that in which
   the twin's keep-if-better or argmax was decided by less than 4e-6.
   Then all three timed at tiny's and viny's shapes;
6. card vs CPU: the first 8 scans of the sequence on the card and on the
   CPU (plain twins) with the same matcher noise, for tinySLAM and vinySLAM;
7. tinySLAM main path (``tiny_config(map_size=256)``) over the bench
   sequence (512 scans, 360 beams, cecum world) through ``Engine.run``,
   warm-up first, then a timed run from a fresh state under
   ``torch.cuda.set_sync_debug_mode("error")``: ``mc_match`` must have been
   launched 512 times and ``overlap_score`` not at all, poses finite, ATE
   below odometry's and below 0.15 m; then once more for repeatability;
8. vinySLAM main path (``viny_config(map_size=256)``), the same way:
   ``mc_match`` and ``polar_free_plane`` launched 512 times each, poses
   finite, ATE below odometry's and no more than 0.02 m above what the JAX
   reference reads on the identical sequence (its worst of five matcher
   keys: the card draws its own matcher noise);
9. the first 64 scans of the viny path with ``mc_match_rounds`` handed in
   in the fused kernel's place (``overlap_score`` launched 64 x 17 times):
   the trajectory must equal the fused path's first 64 poses bit for bit.

The launch counts are set to 0 just before each of these runs and read just
after it. The line before the last is a JSON object of the
kernels; the last line is ``{"ok": true, "device": {...}}``. It needs no
network and starts no process that outlives it.
"""

from __future__ import annotations

import contextlib
import functools
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
def handed_in(fn):
    """``fn`` stands in the package's ``kernels.mc_match`` while the block
    runs, so an engine run goes through it."""
    from slam_constructor_tpu_torch.ops import kernels

    fused = kernels.mc_match
    kernels.mc_match = fn
    try:
        yield
    finally:
        kernels.mc_match = fused


def capture_match_states(cfg, scans, odom, gt, every=32):
    """One run of the main path (it also warms the path up) that keeps the
    arguments of every ``every``-th match."""
    from slam_constructor_tpu_torch.ops import kernels

    fused, kept, n = kernels.mc_match, [], [0]

    def recording(*args):  # the wrapper counts its launches on the name it is called by
        if n[0] % every == 0:
            kept.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        n[0] += 1
        return fused(*args)

    recording.n_launches = 0
    with handed_in(recording):
        run_main_path(cfg, scans, odom, gt, 0)
    return kept


def with_noise(args, rounds, batch, gen, bad_rounds=None):
    a = list(args)
    a[5] = torch.randn((rounds, batch, 3), generator=gen, device=a[4].device)
    if bad_rounds is not None:
        a[10] = bad_rounds
    return tuple(a)


def match_cases(tiny_states, viny_states, dev):
    """(name, args of mc_match): the captured states and the edge cases."""
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [(f"tiny scan {32 * i}", a) for i, a in enumerate(tiny_states)]
    cases += [(f"viny scan {32 * i}", a) for i, a in enumerate(viny_states)]
    t, v = tiny_states[3], viny_states[5]  # scans 96 and 160: a map with walls on it
    for batch in (8, 32, 64, 96, 100):
        cases.append((f"tiny state, batch {batch}", with_noise(t, 12, batch, g)))
        cases.append((f"viny state, batch {batch}", with_noise(v, 16, batch, g)))
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
    return cases


def twin_record(args):
    """The plain twin's match with, for every round, how closely it was
    decided: the gap between its two best scores and between the best and
    the best so far. Returns (pose, prob, trace), margins f32[rounds]."""
    from slam_constructor_tpu_torch.ops import kernels

    scores = []

    def score(*a):
        out = kernels.overlap_score_ref(*a)
        scores.append(out)
        return out

    out = kernels.mc_match_loop(score, *args)
    best, margins = scores[0][0], []
    for probs in scores[1:]:
        top = torch.topk(probs, min(2, probs.shape[0])).values
        margins.append(torch.minimum((top[0] - top[-1]).abs() if top.shape[0] > 1
                                     else torch.full_like(best, math.inf), (top[0] - best).abs()))
        best = torch.maximum(best, top[0])
    return out, torch.stack(margins) if margins else torch.empty((0,), device=best.device)


def phase_mc_match(dev, tiny_states, viny_states):
    """`mc_match` vs `mc_match_rounds` (bitwise) and vs `mc_match_ref` over
    real states and edge cases; then the three timed at the main paths'
    shapes. Returns the `kernels` entry without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    cases = match_cases(tiny_states, viny_states, dev)
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
        # against the twin: within TOL round by round; where they part, a
        # closely decided round must come before
        diff = (got[2] - twin[2]).abs()
        diff = torch.where(torch.isnan(got[2]) & torch.isnan(twin[2]), 0.0, diff)
        far = (diff > TOL).nonzero().flatten().tolist()
        first = far[0] if far else n_rounds
        err = float(diff[:first].max()) if first else 0.0
        if far:
            parted += 1
            edge = float(margins[:first + 1].min())
            print(f"mc_match vs plain [{name}]: parts from the twin at round {first}; closest "
                  f"decision up to there {edge:.3e} (limit {KNIFE_EDGE:g})", flush=True)
            check(edge < KNIFE_EDGE, f"mc_match parts from its twin with no close decision ({name})")
        else:
            p_err = float((got[1] - twin[1]).abs().nan_to_num(nan=0.0))
            pose_err = float((got[0] - twin[0]).abs().max())
            check(p_err <= TOL, f"mc_match prob differs from its twin ({name}): {p_err}")
            check(pose_err <= 1e-6 or float(margins.min()) < KNIFE_EDGE,
                  f"mc_match pose differs from its twin ({name}): {pose_err}")
            err = max(err, p_err)
        max_err = max(max_err, err)
        print(f"mc_match [{name}]: K={batch} rounds={n_rounds} R'={args[1].shape[0]} equal to "
              f"mc_match_rounds bit for bit; vs plain twin max|diff|={err:.3e} over "
              f"{first} rounds (tol {TOL:g})", flush=True)
    print(f"mc_match: {len(cases)} cases equal to mc_match_rounds bit for bit; {parted} part from "
          f"the plain twin after a round decided by less than {KNIFE_EDGE:g}", flush=True)

    entry = {}
    for preset, args in (("tiny", tiny_states[3]), ("viny", viny_states[5])):
        ms, plain_ms, chained = time_pair(lambda: kernels.mc_match(*args),
                                          lambda: kernels.mc_match_ref(*args), plain_calls=10)
        rounds_ms = statistics.median(time_ms(lambda: kernels.mc_match_rounds(*args), 20))
        n_rounds, batch = args[5].shape[0], args[5].shape[1]
        # every input read once, pose, prob and trace written once
        n_bytes = 4 * (sum(a.numel() for a in args[:6]) + 3 + 1 + n_rounds)
        n_ops = OVERLAP_OPS_PER_POINT * (1 + n_rounds * batch) * int((args[2] != 0).sum())
        b_ms, by = bound_ms(n_bytes, n_ops)
        print(f"mc_match {preset} K={batch} rounds={n_rounds} R'={args[1].shape[0]} 256^2: kernel "
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


def phase_card_vs_cpu(name, cfg, dev, scans, odom, gt):
    """First 8 scans on the card and on the CPU with the same noise."""
    from slam_constructor_tpu_torch.models import engine

    n = 8
    rounds, batch = cfg.matcher_cfg.rounds, cfg.matcher_cfg.batch
    noise = torch.from_numpy(
        np.random.default_rng(5).standard_normal((n, rounds, batch, 3)).astype(np.float32))
    trajs = []
    for d in (dev, torch.device("cpu")):
        e = engine.Engine(cfg, device=d)
        e.state.pose = gt[0].to(d).clone()
        traj, _ = e.run(scans[:n], odom[:n], noise=noise.to(d))
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
    return traj, probs, time.perf_counter() - t0


def phase_main_path(name, cfg, want_launches, scans, odom, gt, odo_ate, ate_limit):
    """The timed run (the path was warmed up by the run that captured the
    match states) with the counts at 0 before and read after, then once
    more for repeatability; returns the launch counts and the trajectory
    of the timed run."""
    from slam_constructor_tpu_torch.utils import evaluate

    reset_launches()
    traj, probs, secs = run_main_path(cfg, scans, odom, gt, "error")
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
    traj2, _, secs2 = run_main_path(cfg, scans, odom, gt, 0)
    rep = float((traj2 - traj).abs().max())
    print(f"{name} repeatability: max|pose diff| between two runs {rep:.3e}; second run, "
          f"sync check off: {N_SCANS / secs2:.1f} scans/s", flush=True)
    check(torch.equal(traj2, traj), f"{name}: two runs differ by {rep}")
    return launches, traj


@functools.cache
def launch_counters():
    """The three wrappers, looked up once, before any stand-in is handed in."""
    from slam_constructor_tpu_torch.ops import kernels

    return {"overlap_score": kernels.overlap_score, "mc_match": kernels.mc_match,
            "polar_free_plane": kernels.polar_free_plane}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.n_launches = 0


def read_launches() -> dict:
    return {k: fn.n_launches for k, fn in launch_counters().items()}


def phase_rounds_path(cfg, scans, odom, gt, fused_traj):
    """The first scans of the viny path with `mc_match_rounds` handed in in
    the fused kernel's place: the same trajectory bit for bit, and the
    launches of `overlap_score` it takes."""
    from slam_constructor_tpu_torch.ops import kernels

    n = ROUNDS_PATH_SCANS
    with handed_in(kernels.mc_match_rounds):
        reset_launches()
        traj, _, secs = run_main_path(cfg, scans[:n], odom[:n], gt, "error")
        launches = read_launches()
    want = {"overlap_score": n * (cfg.matcher_cfg.rounds + 1), "mc_match": 0,
            "polar_free_plane": n}
    diff = float((traj - fused_traj[:n]).abs().max())
    print(f"viny path with one overlap_score launch a round, {n} scans: {n / secs:.1f} scans/s; "
          f"launches {launches} (expected {want}); max|pose diff| to the fused path {diff:.3e}",
          flush=True)
    check(launches == want, f"rounds path: launches {launches}, expected {want}")
    check(torch.equal(traj, fused_traj[:n]),
          f"the fused match and one launch a round give different trajectories: {diff}")
    return launches


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

    launch_counters()
    scans, odom, gt = bench_sequence(dev)
    k1 = phase_overlap_kernel(dev, scans, gt)
    k2 = phase_polar_kernel(dev, scans, gt)

    tiny_cfg, viny_cfg = tiny.tiny_config(map_size=MAP), viny.viny_config(map_size=MAP)
    k3 = phase_mc_match(dev, capture_match_states(tiny_cfg, scans, odom, gt),
                        capture_match_states(viny_cfg, scans, odom, gt))
    phase_card_vs_cpu("tiny", tiny_cfg, dev, scans, odom, gt)
    phase_card_vs_cpu("viny", viny_cfg, dev, scans, odom, gt)

    odo_ate = float(evaluate.ate(odometry_trajectory(gt[0], odom), gt, align=False))
    tiny_launches, _ = phase_main_path(
        "tiny", tiny_cfg, {"overlap_score": 0, "mc_match": N_SCANS, "polar_free_plane": 0},
        scans, odom, gt, odo_ate, 0.15)
    viny_launches, viny_traj = phase_main_path(
        "viny", viny_cfg, {"overlap_score": 0, "mc_match": N_SCANS, "polar_free_plane": N_SCANS},
        scans, odom, gt, odo_ate, max(VINY_REFERENCE_ATE_BY_KEY) + VINY_ATE_MARGIN)
    rounds_launches = phase_rounds_path(viny_cfg, scans, odom, gt, viny_traj)

    # `launches`: of the viny main path's timed run, held to the expected
    # counts above. `overlap_score` left the main paths for `score_poses`, so
    # it reads 0 there; the path driven with one launch of it a round stands
    # under `launches_by_path` only
    for k in (k1, k3, k2):
        k["launches"] = viny_launches[k["name"]]
        k["launches_by_path"] = {
            "tiny": tiny_launches[k["name"]], "viny": viny_launches[k["name"]],
            f"viny, one overlap_score launch a round, {ROUNDS_PATH_SCANS} scans":
                rounds_launches[k["name"]]}
    print(json.dumps({"kernels": [k1, k3, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
