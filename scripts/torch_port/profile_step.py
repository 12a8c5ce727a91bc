"""Where a scan's time goes on the card, for one preset of the port.

    python3 scripts/torch_port/profile_step.py --preset viny [--scans 64]

After a warm-up over the bench sequence's first scans it prints:

- scans/s of ``Engine.run`` over the next ``--scans`` scans (host clock
  ending in a synchronise);
- with a synchronise after each phase of ``slam_step``: ms a scan of the
  beam weights, the match, the rasterisation and the cell fold;
- the match alone (``monte_carlo_match`` at a fixed state), synced ms a
  call and ATen calls, through the fused kernel ``mc_match`` and with
  ``mc_match_rounds`` (one ``overlap_score`` launch a round) handed in in
  its place, measured in turns;
- the rasterisation alone (``scan_observation_planes`` at a fixed pose),
  synced ms a call, with the polar fill through the kernel, with the DDA
  fill, and with the polar fill through the plain twin in the kernel's
  place, measured in turns;
- ATen calls a scan (a dispatch-mode count over one step);
- from ``torch.profiler`` over the same scans: the device's kernel time as
  a share of the unprofiled wall time, the port's own kernels and the
  kernels with the most device time, with launches.

Imports no JAX. Every figure is a measurement on the card it names.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the checkout's root


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def synced_ms(fn, calls):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=("tiny", "viny"), default="viny")
    ap.add_argument("--scans", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")

    from slam_constructor_tpu_torch.models import engine, tiny, viny
    from slam_constructor_tpu_torch.ops import grid as gridlib
    from slam_constructor_tpu_torch.ops import kernels, matchers, raycast, scoring
    from slam_constructor_tpu_torch.ops.geometry import compose
    from slam_constructor_tpu_torch.utils import datagen

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cfg = {"tiny": tiny.tiny_config, "viny": viny.viny_config}[args.preset](map_size=256)
    n_warm, n = 64, args.scans
    occ, origin, scale = datagen.cecum_world(device=dev)
    poses = datagen.rectangle_trajectory(step=9.6 / 512 * 2, device=dev)[: n_warm + n]
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(360, device=dev),
        rng=np.random.default_rng(0), odom_noise_xy=0.01, odom_noise_theta=0.005,
    )
    e = engine.Engine(cfg, seed=0)
    e.state.pose = gt[0].clone()
    e.run(scans[:n_warm], odom[:n_warm])
    torch.cuda.synchronize()
    warm = e.state

    t0 = time.perf_counter()
    e.run(scans[n_warm:], odom[n_warm:])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"{args.preset}: {n} scans in {secs:.3f} s = {n / secs:.1f} scans/s "
          f"({secs / n * 1e3:.3f} ms a scan)")

    # --- phases of slam_step, a synchronise after each ----------------------
    phases = dict.fromkeys(("weights", "match", "rasterise", "fold"), 0.0)
    state = warm
    gen = torch.Generator(device=dev).manual_seed(1)
    for i in range(n_warm, n_warm + n):
        scan, od = scans[i], odom[i]
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        torch.cuda.synchronize()
        marks[0] = time.perf_counter()
        pw = engine._point_weights(cfg, scan)
        mark()
        prior = compose(state.pose, od)
        view = scoring.MapView.of(state.gm, cfg.cell_model)
        res = matchers.monte_carlo_match(view, scan, prior, gen, cfg.matcher_cfg, pw)
        mark()
        w_obs, s_obs = raycast.scan_observation_planes(state.gm, res.pose, scan, cfg.beam)
        mark()
        gm = gridlib.apply_observations(state.gm, cfg.cell_model, w_obs, s_obs)
        mark()
        state = engine.SlamState(gm=gm, pose=res.pose, step=state.step + 1, last_prob=res.prob)
        for k, a, b in zip(phases, marks, marks[1:]):
            phases[k] += b - a
    print("synced phases, ms a scan: " + ", ".join(
        f"{k} {v / n * 1e3:.3f}" for k, v in phases.items()))

    # --- the match alone, by who runs the rounds ------------------------------
    # in turns, because the host's speed drifts within a run: the median of
    # seven rounds of 20 synced calls each, and the range over the rounds
    scan, pose, gm = scans[n_warm], gt[n_warm], warm.gm
    view = scoring.MapView.of(gm, cfg.cell_model)
    pw = engine._point_weights(cfg, scan)
    fused = kernels.mc_match
    matchers_by = {"mc_match (one launch)": fused,
                   "mc_match_rounds (one overlap_score launch a round)": kernels.mc_match_rounds}
    rounds = {k: [] for k in matchers_by}
    calls = {}
    try:
        for r in range(7):
            order = list(matchers_by) if r % 2 == 0 else list(matchers_by)[::-1]
            for name in order:
                kernels.mc_match = matchers_by[name]
                rounds[name].append(synced_ms(
                    lambda: matchers.monte_carlo_match(view, scan, pose, gen, cfg.matcher_cfg, pw),
                    20))
                if name not in calls:
                    with CountOps() as c:
                        matchers.monte_carlo_match(view, scan, pose, gen, cfg.matcher_cfg, pw)
                    calls[name] = c.n
    finally:
        kernels.mc_match = fused
    for name, ms in rounds.items():
        print(f"match through {name}: median {statistics.median(ms):.4f} ms a call synced "
              f"(rounds {min(ms):.4f}-{max(ms):.4f}), {calls[name]} ATen calls")

    # --- the rasterisation alone, by free fill -------------------------------
    # in turns again: seven rounds of 40 synced calls each
    kernel, twin = kernels.polar_free_plane, kernels.polar_free_plane_ref
    variants = {
        "polar (kernel)": ("polar", kernel),
        "dda": ("dda", kernel),
        "polar through the plain twin": ("polar", twin),
    }
    rounds = {k: [] for k in variants}
    calls = {}
    try:
        for r in range(7):
            order = list(variants) if r % 2 == 0 else list(variants)[::-1]
            for name in order:
                impl, fn = variants[name]
                kernels.polar_free_plane = fn
                beam = dataclasses.replace(cfg.beam, free_impl=impl)
                rounds[name].append(synced_ms(
                    lambda: raycast.scan_observation_planes(gm, pose, scan, beam), 40))
                if name not in calls:
                    with CountOps() as c:
                        raycast.scan_observation_planes(gm, pose, scan, beam)
                    calls[name] = c.n
    finally:
        kernels.polar_free_plane = kernel
    for name, ms in rounds.items():
        print(f"rasterise, free fill {name}: median {statistics.median(ms):.4f} ms a call "
              f"synced (rounds {min(ms):.4f}-{max(ms):.4f}), {calls[name]} ATen calls")
    pargs = (scan.ranges, scan.valid, scan.bearings, pose, gm.origin, 256, 256, gm.scale,
             cfg.beam.hole_width / 2.0, cfg.beam.max_range)
    print(f"polar_free_plane alone: kernel {synced_ms(lambda: kernel(*pargs), 200):.4f} ms, "
          f"twin {synced_ms(lambda: twin(*pargs), 200):.4f} ms a call synced")
    ms = synced_ms(lambda: gridlib.apply_observations(gm, cfg.cell_model, *raster), 200) if (
        raster := raycast.scan_observation_planes(gm, pose, scan, cfg.beam)) else 0.0
    print(f"fold ({type(cfg.cell_model).__name__}) alone: {ms:.4f} ms a call synced")

    with CountOps() as c:
        engine.slam_step(cfg, warm, scans[n_warm], odom[n_warm], generator=gen)
    print(f"ATen calls a scan (views included): {c.n}")

    # --- profiler: device busy share and kernels by device time --------------
    from torch.profiler import ProfilerActivity, profile

    e.state = warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e.run(scans[n_warm:], odom[n_warm:])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [k for k in prof.key_averages() if getattr(k, "device_time_total", 0) > 0
            and k.device_type.name == "CUDA"]
    dev_s = sum(k.device_time_total for k in rows) * 1e-6
    # the profiler slows the host several times over, so the share that
    # counts is device time over the unprofiled wall time of the same scans
    print(f"profiled {n} scans: device kernel time {dev_s:.4f} s = {dev_s / secs * 100:.1f}% of "
          f"the unprofiled {secs:.3f} s ({dev_s / wall * 100:.1f}% of the profiled {wall:.3f} s); "
          f"{sum(k.count for k in rows) / n:.0f} kernels a scan")
    ours = [k for k in rows
            if any(n in k.key for n in ("mc_match_kernel", "overlap_score_kernel", "polar_free_kernel"))]
    top = sorted(rows, key=lambda k: -k.device_time_total)[:10]
    for k in ours + [k for k in top if k not in ours]:
        print(f"  {k.device_time_total * 1e-3:9.3f} ms  {k.count:6d} x  "
              f"{k.device_time_total / k.count:8.2f} us  {k.key[:90]}")


if __name__ == "__main__":
    main()
