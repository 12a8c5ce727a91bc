"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each, in order; any failure exits non-zero:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: the CUDA kernels from ``slam_constructor_tpu_torch/csrc`` with
   nvcc for sm_90a (seconds, and ptxas' register/shared-memory report);
3. kernel vs plain: ``overlap_score`` against ``overlap_score_ref`` on the
   card at the main-path shapes and at edge cases (max |diff| <= 2e-6),
   then both timed with CUDA events at the main-path shape;
4. card vs CPU: the first 8 scans of the sequence on the card and on the
   CPU (plain twin) with the same matcher noise;
5. main path: tinySLAM (``tiny_config(map_size=256)``) over the bench
   sequence (512 scans, 360 beams, cecum world) through ``Engine.run``,
   warm-up first, then a timed run from a fresh state under
   ``torch.cuda.set_sync_debug_mode("error")``: the kernel must have been
   launched 512 x (12 + 1) times, poses finite, ATE below odometry's and
   below 0.15 m;
6. repeatability: the main path again, max |pose diff| printed.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``. It needs no network and starts no
process that outlives it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 2e-6  # the bound the reference holds its Pallas path to
N_SCANS, N_BEAMS, MAP = 512, 360, 256


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


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


def phase_kernel(dev, scans, gt):
    """Kernel vs plain twin at the main path's shapes and edge cases."""
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
        ("stride 2", scan, cand, sc2, None),
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
        print(f"kernel vs plain [{name}]: K={poses.shape[0]} R={prep.pts.shape[0]} "
              f"max|diff|={err:.3e} (tol {TOL:g})", flush=True)
        check(err <= TOL, f"kernel disagrees with plain twin ({name}): {err}")
        max_err = max(max_err, err)

    prep = scoring.prepare(view, scan, sc)
    args = (prep.plane, cand, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    for _ in range(20):  # warm-up
        kernels.overlap_score(*args)
        kernels.overlap_score_ref(*args)
    torch.cuda.synchronize()
    plain, kern = [], []
    for bucket, fn in ((plain, kernels.overlap_score_ref), (kern, kernels.overlap_score),
                       (kern, kernels.overlap_score), (plain, kernels.overlap_score_ref)):
        bucket += time_ms(lambda: fn(*args), 50)
    ms, plain_ms = statistics.median(kern), statistics.median(plain)
    print(f"overlap_score K=64 R=360 256^2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of {len(kern)} calls each, CUDA events)", flush=True)
    return max_err, ms, plain_ms


def phase_card_vs_cpu(dev, scans, odom, gt):
    """First 8 scans on the card and on the CPU with the same noise."""
    from slam_constructor_tpu_torch.models import engine, tiny

    cfg = tiny.tiny_config(map_size=MAP)
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
    print(f"card vs CPU, {n} scans: max|pose diff|={diff:.3e} (tol 1e-4)", flush=True)
    check(diff <= 1e-4, f"card and CPU runs disagree: {diff}")


def run_main_path(dev, scans, odom, gt, sync_mode):
    from slam_constructor_tpu_torch.models import engine, tiny

    e = engine.Engine(tiny.tiny_config(map_size=MAP), device=dev, seed=0)
    e.state.pose = gt[0].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(sync_mode)
    t0 = time.perf_counter()
    traj, probs = e.run(scans, odom)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return traj, probs, time.perf_counter() - t0


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    from slam_constructor_tpu_torch.ops import _build, kernels
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
    max_err, ms, plain_ms = phase_kernel(dev, scans, gt)
    phase_card_vs_cpu(dev, scans, odom, gt)

    run_main_path(dev, scans, odom, gt, 0)  # warm-up
    kernels.overlap_score.n_launches = 0
    traj, probs, secs = run_main_path(dev, scans, odom, gt, "error")
    launches = kernels.overlap_score.n_launches
    want = N_SCANS * (12 + 1)
    print(f"main path: {N_SCANS} scans in {secs:.3f} s = {N_SCANS / secs:.1f} scans/s; "
          f"overlap_score launches {launches} (expected {want})", flush=True)
    check(launches == want, f"overlap_score launched {launches} times, expected {want}")
    check(traj.shape == (N_SCANS, 3) and bool(torch.isfinite(traj).all()), "non-finite poses")
    ate = float(evaluate.ate(traj, gt, align=False))
    odo = float(evaluate.ate(odometry_trajectory(gt[0], odom), gt, align=False))
    print(f"main path: ATE {ate:.4f} m (no alignment), odometry-only ATE {odo:.4f} m, "
          f"min prob {float(probs[1:].min()):.4f}", flush=True)
    check(ate < odo and ate < 0.15, f"ATE {ate} not below odometry {odo} and 0.15")

    traj2, _, secs2 = run_main_path(dev, scans, odom, gt, 0)
    rep = float((traj2 - traj).abs().max())
    print(f"repeatability: max|pose diff| between two runs {rep:.3e} "
          f"(second run {N_SCANS / secs2:.1f} scans/s)", flush=True)

    print(json.dumps({"kernels": [{
        "name": "overlap_score", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/overlap_score.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
