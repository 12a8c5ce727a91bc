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
5. card vs CPU: the first 8 scans of the sequence on the card and on the
   CPU (plain twins) with the same matcher noise, for tinySLAM and vinySLAM;
6. tinySLAM main path (``tiny_config(map_size=256)``) over the bench
   sequence (512 scans, 360 beams, cecum world) through ``Engine.run``,
   warm-up first, then a timed run from a fresh state under
   ``torch.cuda.set_sync_debug_mode("error")``: ``overlap_score`` must have
   been launched 512 x (12 + 1) times, poses finite, ATE below odometry's
   and below 0.15 m; then once more for repeatability;
7. vinySLAM main path (``viny_config(map_size=256)``), the same way:
   ``overlap_score`` launched 512 x (16 + 1) times and ``polar_free_plane``
   512 times, poses finite, ATE below odometry's and no more than 0.02 m
   above what the JAX reference reads on the identical sequence (its worst
   of five matcher keys: the card draws its own matcher noise).

The launch counts are set to 0 just before each timed main-path run and
read just after it. The line before the last is a JSON object of the
kernels; the last line is ``{"ok": true, "device": {...}}``. It needs no
network and starts no process that outlives it.
"""

from __future__ import annotations

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
#: f32 operations a (candidate, beam) pair of `overlap_score`: pose
#: transform 8, to cell units 4, two axes of taps 2 x 12, blend 14, sum 3
OVERLAP_OPS_PER_POINT = 8 + 4 + 24 + 14 + 3


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


def time_pair(kernel, plain):
    """Median ms a call of both, in turns (plain, kernel, kernel, plain),
    each call between its own pair of CUDA events; and the kernel's ms a
    launch with 200 launches queued back to back between one pair."""
    for _ in range(20):  # warm-up
        kernel()
        plain()
    torch.cuda.synchronize()
    k_ms, p_ms = [], []
    for bucket, fn in ((p_ms, plain), (k_ms, kernel), (k_ms, kernel), (p_ms, plain)):
        bucket += time_ms(fn, 50)
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
    n_ops = POLAR_OPS_PER_CELL * MAP * MAP
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"polar_free_plane 256^2 R=360: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of 100 calls each, CUDA events), kernel {chained:.4f} ms a launch over 200 "
          f"back to back; bound {b_ms:.6f} ms by {by} "
          f"({n_bytes} B, {n_ops} operations); no single PyTorch call computes it", flush=True)
    return {
        "name": "polar_free_plane", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/polar_free.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:186",
        "max_abs_err": max_err, "max_rel_err": max_rel, "flipped_cells": flipped_all,
        "ms": ms, "plain_ms": plain_ms, "chained_ms": chained,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
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


def phase_main_path(name, cfg, want_launches, scans, odom, gt, odo_ate, ate_limit, repeat):
    """Warm-up, then the timed run with the counts at 0 before and read
    after; returns the launch counts of the timed run."""
    from slam_constructor_tpu_torch.ops import kernels
    from slam_constructor_tpu_torch.utils import evaluate

    wrappers = {"overlap_score": kernels.overlap_score,
                "polar_free_plane": kernels.polar_free_plane}
    run_main_path(cfg, scans, odom, gt, 0)  # warm-up
    for fn in wrappers.values():
        fn.n_launches = 0
    traj, probs, secs = run_main_path(cfg, scans, odom, gt, "error")
    launches = {k: fn.n_launches for k, fn in wrappers.items()}
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
    if repeat:
        traj2, _, secs2 = run_main_path(cfg, scans, odom, gt, 0)
        rep = float((traj2 - traj).abs().max())
        print(f"{name} repeatability: max|pose diff| between two runs {rep:.3e}; second run, "
              f"sync check off: {N_SCANS / secs2:.1f} scans/s", flush=True)
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

    scans, odom, gt = bench_sequence(dev)
    k1 = phase_overlap_kernel(dev, scans, gt)
    k2 = phase_polar_kernel(dev, scans, gt)

    tiny_cfg, viny_cfg = tiny.tiny_config(map_size=MAP), viny.viny_config(map_size=MAP)
    phase_card_vs_cpu("tiny", tiny_cfg, dev, scans, odom, gt)
    phase_card_vs_cpu("viny", viny_cfg, dev, scans, odom, gt)

    odo_ate = float(evaluate.ate(odometry_trajectory(gt[0], odom), gt, align=False))
    tiny_launches = phase_main_path(
        "tiny", tiny_cfg,
        {"overlap_score": N_SCANS * (tiny_cfg.matcher_cfg.rounds + 1), "polar_free_plane": 0},
        scans, odom, gt, odo_ate, 0.15, repeat=True)
    viny_launches = phase_main_path(
        "viny", viny_cfg,
        {"overlap_score": N_SCANS * (viny_cfg.matcher_cfg.rounds + 1),
         "polar_free_plane": N_SCANS},
        scans, odom, gt, odo_ate, max(VINY_REFERENCE_ATE_BY_KEY) + VINY_ATE_MARGIN, repeat=True)

    for k in (k1, k2):
        k["launches"] = viny_launches[k["name"]]  # the path that runs both kernels
        k["launches_by_path"] = {"tiny": tiny_launches[k["name"]],
                                 "viny": viny_launches[k["name"]]}
        check(k["launches"] > 0, f"{k['name']} was not launched on the viny main path")
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
