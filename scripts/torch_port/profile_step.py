"""Where a scan's time goes on the card, for one preset of the port.

    python3 scripts/torch_port/profile_step.py --preset viny [--scans 64]

After a warm-up over the bench sequence's first scans it prints:

- scans/s of ``Engine.run`` over the next ``--scans`` scans (host clock
  ending in a synchronise);
- with a synchronise after each phase of ``slam_step``: ms a scan of the
  beam weights, the match and the insert (K3: the rasterisation and the
  cell fold in one call of ``kernels.scan_insert``);
- the match alone (``monte_carlo_match`` at a fixed state), synced ms a
  call and ATen calls, through the fused kernel ``mc_match`` and with
  ``mc_match_rounds`` (one ``overlap_score`` launch a round) handed in in
  its place, measured in turns;
- the insert alone (``raycast.insert_scan`` at a fixed pose), synced ms a
  call and ATen calls, through K3 and with its plain twin
  (``kernels.scan_insert_ref``) handed in, each with the polar and the DDA
  fill, measured in turns;
- ATen calls a scan (a dispatch-mode count over one step) and the scatters
  (``index_put_``, ``scatter_add_``) among them;
- from ``torch.profiler`` over the same scans: the device's kernel time as
  a share of the unprofiled wall time, the port's own kernels and the
  kernels with the most device time, with launches.

With ``--preset gmapping [--slot MATCHER[+REFINE]]`` it profiles the RBPF
(with that slot of ``chip_smoke.GM_SLOTS``: the hill climb, M3RSM or the
gradient ascent as the match, or as the refine after the Monte-Carlo
match) at bench.py's gmapping
preset (30 particles, 160^2 windows) over the tiny sequence: scans/s of
``GMappingEngine.run`` over ``--scans`` scans after a warm-up of as many;
then, with a synchronise after each phase of ``gmapping_step``, ms and ATen
calls a scan of the proposal, the match windows (``gmapping.match_view``:
on this preset their corners, the windows read in place), the particle
match, the weight update, the insert (``raycast.insert_scan_windows``: K3
on the windows in place) and the resampling, and the launches of the port's kernels; and
from ``torch.profiler`` the device's kernel time as a share of the
unprofiled wall time and the kernels with the most device time.

``--preset gmapping_baseline`` profiles the same phases on the BASELINE
gmapping preset (``utils.config.preset('gmapping')``: ``GMappingConfig()``,
30 whole 256^2 maps, the obstacle reducer, 16 x 6 rounds) over the bench
sequence, and ``--preset tum_2d`` on ``configs/tum_2d.properties`` (30
particles, 384^2 windows of 1024^2 maps at 0.05 m, the improved proposal
and its probes) over the CLI's synthetic sequence. Scans are timed with
``utils.profiling.StepTimer`` (a synchronise before and after).

With ``--preset gmapping_cow`` or ``--preset mit_stata`` it profiles a
block-pool path: the copy-on-write RBPF (``chip_smoke.cow_config``) over the
bench sequence, or the tiled map of ``configs/mit_stata.properties`` over the
CLI's sequence: scans/s over ``--scans`` scans after a warm-up of as many;
ms and ATen calls a scan of each phase with a synchronise after it (the
window gather, the match, the marks and the prepare, the insert, the
resampling); the launches; and the device's busy share from
``torch.profiler``. ``--root DIR`` runs another checkout's package (a
parent unpacked under ``build/``) through the same phases, its prepare as
that checkout has it.

With ``--preset full [--loop hill_climbing|gradient]`` it profiles the
loop-closing pipeline (with that loop matcher, ``chip_smoke.full_loop_config``) over
``chip_smoke.py``'s full sequence instead (512 scans, two laps, one
segment): scans/s of ``FullSlamEngine.run``; then, from a run with a
synchronise after each phase, the seconds, the calls, the ATen calls and the
kernel launches of the tracking (a scan), the keyframe work (a batch) and
the closure bursts (a burst, with and without the map's regeneration); and
from ``torch.profiler`` over one more run the device's kernel time as a
share of the unprofiled wall time and the kernels with the most device time.

With ``--preset viny_m3rsm`` it profiles vinySLAM with the M3RSM matcher
(``viny_m3rsm_config(map_size=256)``) over the bench sequence: scans/s of
``Engine.run`` over ``--scans`` scans after a warm-up of 64; with a
synchronise after each phase of ``slam_step``, ms and ATen calls a scan of
the beam weights, the match (the branch and bound over the live pyramid,
then the hill climb), the insert (K3) and the pyramid's refresh; at a fixed state, synced ms and ATen calls of the whole match (one
``m3rsm_search`` launch), of its search alone (``refine_iterations=0``), of
the kernel's wrapper alone (the rest of the match's calls come before the
launch) and of the same match with ``m3rsm_search_levels`` handed in (a
level launch a level, a score launch a hill-climb round); and from
``torch.profiler`` the device's kernel time as a share of the unprofiled
wall time and the kernels with the most device time.

With ``--preset tiny_refined`` or ``--preset mit_csail`` it profiles the
engine built from ``configs/<preset>.properties`` (``utils/config.py``, the
config's own widths) over the CLI's synthetic sequence (the cecum
rectangle, 360 beams): scans/s of ``Engine.run`` over ``--scans`` scans
after a warm-up of 64, through the refine's kernel (``gradient_refine``,
``hill_climb``) and with its yardstick (``gradient_refine_rounds``,
``hill_climb_rounds``: a score launch a pass) handed in, in turns; for
both, with a synchronise after each phase of ``slam_step``, ms and ATen
calls a scan of the match, the refine and the insert (K3), and the
launches; the refine alone at a fixed state, synced ms a call and ATen
calls, in turns; and from ``torch.profiler`` the device's kernel time as a
share of the unprofiled wall time and the kernels with the most device
time.

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

from slam_constructor_tpu_torch.utils.profiling import StepTimer  # noqa: E402


class CountOps(TorchDispatchMode):
    """Counts the ATen calls made under it, and keeps their names."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def synced_ms(fn, calls):
    """ms a call of ``fn``, each call between synchronises
    (``utils.profiling.StepTimer``)."""
    timer = StepTimer()
    for _ in range(calls):
        with timer:
            fn()
    return timer.summary()["mean_ms"]


def run_seconds(fn) -> float:
    """Seconds of ``fn()``, the card synchronised before and after
    (``utils.profiling.StepTimer``)."""
    timer = StepTimer()
    with timer:
        fn()
    return timer.samples[-1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=("tiny", "viny", "viny_m3rsm", "full", "gmapping",
                                         "gmapping_baseline", "tum_2d", "tiny_refined",
                                         "mit_csail", "gmapping_cow", "mit_stata"),
                    default="viny")
    ap.add_argument("--scans", type=int, default=64)
    ap.add_argument("--slot", default=None, metavar="MATCHER[+REFINE]",
                    help="--preset gmapping: a matcher slot of chip_smoke.GM_SLOTS "
                         "(chip_smoke.gmapping_slot_config)")
    ap.add_argument("--loop", default=None, choices=("hill_climbing", "gradient"),
                    help="--preset full: the loop matcher (chip_smoke.full_loop_config)")
    ap.add_argument("--root", default=None,
                    help="another checkout (a parent unpacked under build/) whose package and "
                         "chip_smoke.py the presets gmapping_cow and mit_stata run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    if args.root is not None:
        sys.path.insert(0, str(Path(args.root).resolve()))
    if args.preset in ("gmapping_cow", "mit_stata"):
        profile_pool(args.preset, args.scans)
        return
    if args.preset == "full":
        profile_full(args.loop)
        return
    if args.preset in ("gmapping", "gmapping_baseline", "tum_2d"):
        profile_gmapping(args.scans, args.slot, args.preset)
        return
    if args.preset == "viny_m3rsm":
        profile_m3rsm(args.scans)
        return
    if args.preset in REFINES:
        profile_refine(args.preset, args.scans)
        return

    from slam_constructor_tpu_torch.models import engine, tiny, viny
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

    secs = run_seconds(lambda: e.run(scans[n_warm:], odom[n_warm:]))
    print(f"{args.preset}: {n} scans in {secs:.3f} s = {n / secs:.1f} scans/s "
          f"({secs / n * 1e3:.3f} ms a scan)")

    # --- phases of slam_step, a synchronise after each ----------------------
    phases = dict.fromkeys(("weights", "match", "insert"), 0.0)
    state = warm
    q = torch.ones((), device=dev)
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
        gm = raycast.insert_scan(state.gm, cfg.cell_model, res.pose, scan, cfg.beam, q)
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

    # --- the insert alone, through K3 and its twin, by free fill --------------
    # in turns again: seven rounds of 40 synced calls each
    kernel, twin = kernels.scan_insert, kernels.scan_insert_ref
    variants = {
        f"K3, {cfg.beam.free_impl} fill": (cfg.beam.free_impl, kernel),
        f"the plain twin, {cfg.beam.free_impl} fill": (cfg.beam.free_impl, twin),
        "K3, the other fill": ("dda" if cfg.beam.free_impl == "polar" else "polar", kernel),
        "the plain twin, the other fill": ("dda" if cfg.beam.free_impl == "polar" else "polar",
                                           twin),
    }
    rounds = {k: [] for k in variants}
    calls = {}
    try:
        for r in range(7):
            order = list(variants) if r % 2 == 0 else list(variants)[::-1]
            for name in order:
                impl, fn = variants[name]
                kernels.scan_insert = fn
                beam = dataclasses.replace(cfg.beam, free_impl=impl)
                rounds[name].append(synced_ms(
                    lambda: raycast.insert_scan(gm, cfg.cell_model, pose, scan, beam, q), 40))
                if name not in calls:
                    with CountOps() as c:
                        raycast.insert_scan(gm, cfg.cell_model, pose, scan, beam, q)
                    calls[name] = c.n
    finally:
        kernels.scan_insert = kernel
    for name, ms in rounds.items():
        print(f"insert through {name}: median {statistics.median(ms):.4f} ms a call "
              f"synced (rounds {min(ms):.4f}-{max(ms):.4f}), {calls[name]} ATen calls")
    pargs = (scan.ranges, scan.valid, scan.bearings, pose, gm.origin, 256, 256, gm.scale,
             cfg.beam.hole_width / 2.0, cfg.beam.max_range)
    print(f"polar_free_plane alone: kernel "
          f"{synced_ms(lambda: kernels.polar_free_plane(*pargs), 200):.4f} ms, twin "
          f"{synced_ms(lambda: kernels.polar_free_plane_ref(*pargs), 200):.4f} ms a call synced")

    with CountOps() as c:
        engine.slam_step(cfg, warm, scans[n_warm], odom[n_warm], generator=gen)
    scatters = sorted({n for n in c.names if "index_put" in n or "scatter" in n})
    print(f"ATen calls a scan (views included): {c.n}; scatters among them: {scatters or 'none'}")

    # --- profiler: device busy share and kernels by device time --------------
    from torch.profiler import ProfilerActivity, profile

    e.state = warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e.run(scans[n_warm:], odom[n_warm:])
        torch.cuda.synchronize()
    device_report(prof, n, secs, time.perf_counter() - t0,
                  ("mc_match_kernel", "overlap_score_kernel", "polar_free_kernel",
                   "insert_kernel"))


def device_report(prof, n: int, secs: float, wall: float, names: tuple) -> None:
    """The profiler's device kernel time against the unprofiled wall time
    ``secs`` of the same ``n`` scans (the profiler slows the host several
    times over, so that is the share that counts), then the port's kernels
    (``names``) and the kernels with the most device time."""
    rows = [k for k in prof.key_averages() if getattr(k, "device_time_total", 0) > 0
            and k.device_type.name == "CUDA"]
    dev_s = sum(k.device_time_total for k in rows) * 1e-6
    print(f"profiled {n} scans: device kernel time {dev_s:.4f} s = {dev_s / secs * 100:.1f}% of "
          f"the unprofiled {secs:.3f} s ({dev_s / wall * 100:.1f}% of the profiled {wall:.3f} s); "
          f"{sum(k.count for k in rows) / n:.0f} kernels a scan")
    ours = [k for k in rows if any(name in k.key for name in names)]
    top = sorted(rows, key=lambda k: -k.device_time_total)[:10]
    for k in ours + [k for k in top if k not in ours]:
        print(f"  {k.device_time_total * 1e-3:9.3f} ms  {k.count:6d} x  "
              f"{k.device_time_total / k.count:8.2f} us  {k.key[:90]}")


def profile_m3rsm(n: int) -> None:
    """vinySLAM with the M3RSM matcher: scans/s, synced phases with ATen
    calls, the match's search and refine alone, and the device's share."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import bench_sequence
    from slam_constructor_tpu_torch.models import engine, viny
    from slam_constructor_tpu_torch.ops import kernels, m3rsm, raycast, scoring
    from slam_constructor_tpu_torch.ops.geometry import compose

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cfg = viny.viny_m3rsm_config(map_size=256)
    n_warm = 64
    e = engine.Engine(cfg, seed=0)
    dev = e.device
    scans, odom, gt = bench_sequence(dev)
    e.state.pose = gt[0].clone()
    e.run(scans[:n_warm], odom[:n_warm])
    torch.cuda.synchronize()
    warm = e.state
    secs = run_seconds(lambda: e.run(scans[n_warm:n_warm + n], odom[n_warm:n_warm + n]))
    print(f"viny_m3rsm: {n} scans in {secs:.3f} s = {n / secs:.1f} scans/s "
          f"({secs / n * 1e3:.3f} ms a scan)")

    # a pass that times the phases (a synchronise after each), then one that
    # counts their ATen calls (the dispatch mode slows the host)
    names = ("weights", "match", "insert", "refresh")
    ms, aten = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    q = torch.ones((), device=dev)
    for count_ops in (False, True):
        kernels.reset_launch_counts()
        state = warm
        for i in range(n_warm, n_warm + n):
            scan, od = scans[i], odom[i]

            def phase(name, fn):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if count_ops:
                    with CountOps() as c:
                        out = fn()
                    aten[name] += c.n
                else:
                    out = fn()
                    torch.cuda.synchronize()
                    ms[name] += time.perf_counter() - t
                return out

            pw = phase("weights", lambda: engine._point_weights(cfg, scan))
            prior = compose(state.pose, od)
            view = scoring.MapView.of(state.gm, cfg.cell_model)
            res = phase("match", lambda: m3rsm.m3rsm_match(
                view, scan, prior, None, cfg.matcher_cfg, pw, pyramid=state.pyramid))
            gm = phase("insert", lambda: raycast.insert_scan(state.gm, cfg.cell_model, res.pose,
                                                             scan, cfg.beam, q))
            pyr = phase("refresh", lambda: engine._refresh_pyramid(cfg, gm, res.pose,
                                                                    state.pyramid, q))
            state = engine.SlamState(gm=gm, pose=res.pose, step=state.step + 1,
                                     last_prob=res.prob, pyramid=pyr)
    print("synced phases, ms / ATen calls a scan: " + ", ".join(
        f"{k} {ms[k] / n * 1e3:.3f} / {aten[k] / n:.0f}" for k in names)
        + f"; launches {kernels.launch_counts()}")

    scan, prior = scans[n_warm], compose(warm.pose, odom[n_warm])
    view = scoring.MapView.of(warm.gm, cfg.cell_model)
    pw = engine._point_weights(cfg, scan)
    search_cfg = dataclasses.replace(cfg.matcher_cfg, refine_iterations=0)
    searches, search = [], kernels.m3rsm_search

    def match(mcfg=cfg.matcher_cfg):
        return m3rsm.m3rsm_match(view, scan, prior, None, mcfg, pw, pyramid=warm.pyramid)

    def with_levels():  # the same match with a level launch a level, a score launch a round
        kernels.m3rsm_search = kernels.m3rsm_search_levels
        try:
            return match()
        finally:
            kernels.m3rsm_search = search

    kernels.m3rsm_search = lambda s: searches.append(s) or search(s)
    try:
        match()
    finally:
        kernels.m3rsm_search = search
    calls = {}
    for name, fn in (
            ("the whole match (one m3rsm_search launch)", match),
            ("the search alone (refine 0, one launch)", lambda: match(search_cfg)),
            ("the kernel's wrapper alone (m3rsm_search)", lambda: kernels.m3rsm_search(searches[0])),
            ("the whole match with 5 level launches and 9 score launches", with_levels)):
        with CountOps() as c:
            fn()
        calls[name] = c.n
        print(f"{name}: {synced_ms(fn, 50):.4f} ms a call synced, {c.n} ATen calls")
    whole, wrapper = list(calls.values())[0], list(calls.values())[2]
    print(f"the match's ATen calls: {whole - wrapper} before the launch (endpoint cells, mask, "
          f"window corner, the refine's beams), {wrapper} in the wrapper (its outputs)")
    with CountOps() as c:
        engine.slam_step(cfg, warm, scans[n_warm], odom[n_warm])
    print(f"ATen calls a scan (views included): {c.n}")

    e.state = warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e.run(scans[n_warm:n_warm + n], odom[n_warm:n_warm + n])
        torch.cuda.synchronize()
    device_report(prof, n, secs, time.perf_counter() - t0,
                  ("m3rsm_match_kernel", "m3rsm_pyramid_kernel", "m3rsm_level_kernel",
                   "overlap_score_kernel", "insert_kernel"))


#: the refine configs: the refine's wrapper and its yardstick in ``kernels``
REFINES = {"tiny_refined": ("gradient_refine", "gradient_refine_rounds"),
           "mit_csail": ("hill_climb", "hill_climb_rounds")}


def profile_refine(preset: str, n: int) -> None:
    """A refine config at its own widths: scans/s and the synced phases of
    a scan through the refine's kernel and with its yardstick, the refine
    alone, and the device's share."""
    from torch.profiler import ProfilerActivity, profile

    from slam_constructor_tpu_torch import run
    from slam_constructor_tpu_torch.models import engine
    from slam_constructor_tpu_torch.ops import kernels, raycast, scoring
    from slam_constructor_tpu_torch.ops import matchers as matcherslib
    from slam_constructor_tpu_torch.ops.geometry import compose
    from slam_constructor_tpu_torch.utils import config as cfglib

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    n_warm = 64
    args = run.parse_args(["--config", f"configs/{preset}.properties", "--synthetic", "cecum",
                           "--trajectory", "rectangle", "--steps", str(n_warm + n),
                           "--out", f"build/profile_{preset}"])
    cfg = cfglib.engine_config_from(cfglib.load_properties(args.config))
    e = engine.Engine(cfg, seed=0)
    dev = e.device
    scans, odom, gt = run.load_data(args, dev)
    e.state.pose = gt[0].clone()
    e.run(scans[:n_warm], odom[:n_warm])
    torch.cuda.synchronize()
    warm = e.state
    name, yard = REFINES[preset]
    fused = getattr(kernels, name)
    variants = {f"{name} (one launch)": fused, f"{yard} (a score launch a pass)":
                getattr(kernels, yard)}

    def run_with(fn):
        setattr(kernels, name, fn)
        try:
            e.state = warm
            return run_seconds(lambda: e.run(scans[n_warm:], odom[n_warm:]))
        finally:
            setattr(kernels, name, fused)

    secs = {k: [] for k in variants}
    for k in (*variants, *reversed(variants)):  # in turns: kernel, yardstick, yardstick, kernel
        secs[k].append(run_with(variants[k]))
    for k, v in secs.items():
        print(f"{preset} through {k}: {n} scans in {' and '.join(f'{t:.3f}' for t in v)} s = "
              f"{' and '.join(f'{n / t:.1f}' for t in v)} scans/s")

    # --- phases of slam_step, a synchronise after each ----------------------
    names = ("match", "refine", "insert")
    q = torch.ones((), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for k, fn in variants.items():
        ms, aten = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
        setattr(kernels, name, fn)
        try:
            for count_ops in (False, True):
                kernels.reset_launch_counts()
                state = warm
                for i in range(n_warm, n_warm + n):
                    scan, od = scans[i], odom[i]

                    def phase(what, f):
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        if count_ops:
                            with CountOps() as c:
                                out = f()
                            aten[what] += c.n
                        else:
                            out = f()
                            torch.cuda.synchronize()
                            ms[what] += time.perf_counter() - t
                        return out

                    prior = compose(state.pose, od)
                    view = scoring.MapView.of(state.gm, cfg.cell_model)
                    pw = engine._point_weights(cfg, scan)
                    match_fn = matcherslib.MATCHERS[cfg.matcher][1]
                    res = phase("match", lambda: match_fn(view, scan, prior, gen,
                                                          cfg.matcher_cfg, pw))
                    res = phase("refine", lambda: engine._refine(cfg, view, scan, res, gen, pw,
                                                                 None))
                    gm = phase("insert", lambda: raycast.insert_scan(
                        state.gm, cfg.cell_model, res.pose, scan, cfg.beam, q))
                    state = engine.SlamState(gm=gm, pose=res.pose, step=state.step + 1,
                                             last_prob=res.prob)
                launches = {a: b for a, b in kernels.launch_counts().items() if b}
        finally:
            setattr(kernels, name, fused)
        print(f"synced phases through {k}, ms / ATen calls a scan: " + ", ".join(
            f"{p} {ms[p] / n * 1e3:.3f} / {aten[p] / n:.0f}" for p in names)
            + f"; launches over {n} scans {launches}")

    # --- the refine alone at a fixed state, in turns ------------------------
    scan = scans[n_warm]
    view = scoring.MapView.of(warm.gm, cfg.cell_model)
    start = compose(warm.pose, odom[n_warm])
    res = matcherslib.MATCHERS[cfg.matcher][1](view, scan, start, gen, cfg.matcher_cfg, None)
    rounds = {k: [] for k in variants}
    calls = {}
    try:
        for r in range(7):
            for k in (variants if r % 2 == 0 else reversed(variants)):
                setattr(kernels, name, variants[k])
                rounds[k].append(synced_ms(
                    lambda: engine._refine(cfg, view, scan, res, gen, None, None), 20))
                if k not in calls:
                    with CountOps() as c:
                        engine._refine(cfg, view, scan, res, gen, None, None)
                    calls[k] = c.n
    finally:
        setattr(kernels, name, fused)
    for k, v in rounds.items():
        print(f"the refine through {k}: median {statistics.median(v):.4f} ms a call synced "
              f"(rounds {min(v):.4f}-{max(v):.4f}), {calls[k]} ATen calls")
    with CountOps() as c:
        engine.slam_step(cfg, warm, scans[n_warm], odom[n_warm], generator=gen)
    print(f"ATen calls a scan (views included): {c.n}")

    e.state = warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e.run(scans[n_warm:], odom[n_warm:])
        torch.cuda.synchronize()
    device_report(prof, n, min(secs[next(iter(variants))]), time.perf_counter() - t0,
                  ("gradient_refine_kernel", "hill_climb_kernel", "mc_match_kernel",
                   "overlap_score_grad_kernel", "overlap_score_kernel", "insert_kernel"))


def gmapping_setup(preset: str, slot: str | None, n: int, dev):
    """(config, scans, odom, gt) of an RBPF preset: bench.py's ``gmapping``
    (or one of its slots) and the BASELINE preset (``utils.config.preset(
    'gmapping')``: ``GMappingConfig()``, 30 whole 256^2 maps) over the bench
    sequence; ``tum_2d`` (``configs/tum_2d.properties`` at its widths: 30
    particles, 384^2 windows of 1024^2 maps, the improved proposal) over
    the CLI's synthetic sequence of 2 n scans."""
    from chip_smoke import bench_sequence, gmapping_config, gmapping_slot_config
    from slam_constructor_tpu_torch import run
    from slam_constructor_tpu_torch.utils import config as cfglib

    if preset == "tum_2d":
        args = run.parse_args(["--config", "configs/tum_2d.properties", "--synthetic", "cecum",
                               "--trajectory", "rectangle", "--steps", str(2 * n),
                               "--out", "build/profile_tum_2d"])
        return (cfglib.gmapping_config_from(cfglib.load_properties(args.config)),
                *run.load_data(args, dev))
    if preset == "gmapping_baseline":
        cfg = cfglib.preset("gmapping")(device=dev).cfg
    else:
        cfg = gmapping_slot_config(*(*slot.split("+"), None)[:2]) if slot else gmapping_config()
    return (cfg, *bench_sequence(dev))


def profile_gmapping(n: int, slot: str | None = None, preset: str = "gmapping") -> None:
    from slam_constructor_tpu_torch.models import gmapping
    from slam_constructor_tpu_torch.ops import grid as gridlib
    from slam_constructor_tpu_torch.ops import kernels, raycast, resample
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cfg, scans, odom, gt = gmapping_setup(preset, slot, n, dev)
    p = cfg.n_particles
    e = gmapping.GMappingEngine(cfg, seed=0)
    e.state.poses = gt[0].expand(p, 3).clone()
    e.run(scans[:n], odom[:n])  # warm-up, and the maps hold n scans
    torch.cuda.synchronize()
    warm = e.state
    secs = run_seconds(lambda: e.run(scans[n:2 * n], odom[n:2 * n]))
    print(f"{preset}{' ' + slot if slot else ''} ({p} particles): {n} scans in {secs:.3f} s = "
          f"{n / secs:.1f} scans/s "
          f"({secs / n * 1e3:.3f} ms a scan)")

    # --- phases of gmapping_step, a synchronise after each ------------------
    names = ("proposal", "windows", "match", "weights", "insert", "resample")
    ms = dict.fromkeys(names, 0.0)
    aten = dict.fromkeys(names, 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    for count_ops in (False, True):
        state = warm
        for i in range(n, 2 * n):
            scan, od = scans[i], odom[i]
            counter = CountOps()
            marks = []

            def phase(name, fn):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if count_ops:
                    with counter:
                        n0 = counter.n
                        out = fn()
                    aten[name] += counter.n - n0
                else:
                    out = fn()
                    torch.cuda.synchronize()
                    ms[name] += time.perf_counter() - t
                marks.append(name)
                return out

            def propose():
                d = gmapping.draw(cfg, gen, dev)
                return (d, *gmapping.propose(cfg, state.poses, od, d.proposal))

            d, sigma, priors, centers = phase("proposal", propose)

            def windows():  # on the bench preset the windows' corners only: read in place
                return gmapping.expand_scan(scan, p), gmapping.match_view(cfg, state.gm, priors)

            sc, view = phase("windows", windows)
            poses, incr = phase("match", lambda: gmapping.match_particles(
                cfg, view, sc, priors, centers, sigma, d))
            logw = phase("weights", lambda: resample.normalize_log_weights(state.log_weights + incr))
            gm = state.gm
            cells = phase("insert", lambda: raycast.insert_scan_windows(
                gm, cfg.cell_model, poses, sc, cfg.beam, cfg.insert_window).cells)

            def resampled():
                idx, lw, _ = resample.maybe_resample(d.u0, logw, cfg.resample_threshold)
                return gmapping.GMappingState(
                    gm=gridlib.GridMap(cells.index_select(0, idx), gm.origin.index_select(0, idx),
                                       gm.scale),
                    poses=poses.index_select(0, idx), log_weights=lw, step=state.step + 1)

            state = phase("resample", resampled)
    print("synced phases, ms and ATen calls a scan: " + ", ".join(
        f"{k} {ms[k] / n * 1e3:.3f} ms / {aten[k] / n:.0f}" for k in names)
        + f"; in all {sum(ms.values()) / n * 1e3:.3f} ms / {sum(aten.values()) / n:.0f}")
    with CountOps() as c:
        gmapping.gmapping_step(cfg, warm, scans[n], odom[n], generator=gen)
    print(f"ATen calls of one gmapping_step (views included): {c.n}")

    e.state = warm
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e.run(scans[n:2 * n], odom[n:2 * n])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"launches over {n} scans: {kernels.launch_counts()}")
    rows = [k for k in prof.key_averages() if getattr(k, "device_time_total", 0) > 0
            and k.device_type.name == "CUDA"]
    dev_s = sum(k.device_time_total for k in rows) * 1e-6
    print(f"profiled {n} scans: device kernel time {dev_s:.4f} s = {dev_s / secs * 100:.1f}% of "
          f"the unprofiled {secs:.3f} s ({dev_s / wall * 100:.1f}% of the profiled {wall:.3f} s); "
          f"{sum(k.count for k in rows) / n:.0f} kernels a scan")
    mine = [k for k in rows if any(n in k.key for n in (
        "mc_match_kernel", "insert_kernel", "gradient_refine_kernel", "hill_climb", "m3rsm"))]
    top = sorted(rows, key=lambda k: -k.device_time_total)[:12]
    for k in mine + [k for k in top if k not in mine]:
        print(f"  {k.device_time_total * 1e-3:9.3f} ms  {k.count:6d} x  "
              f"{k.device_time_total / k.count:8.2f} us  {k.key[:90]}")


def _clone_pool_state(state, rbpf: bool):
    """A copy of an engine state whose block pool, tables and counters the
    next steps may update in place."""
    gm = state.gm
    if rbpf:
        gm = dataclasses.replace(gm, pool=gm.pool.clone(), tables=gm.tables.clone(),
                                 refcnt=gm.refcnt.clone(), overflow=gm.overflow.clone())
    else:
        gm = dataclasses.replace(gm, pool=gm.pool.clone(), table=gm.table.clone(),
                                 n_alloc=gm.n_alloc.clone())
    return dataclasses.replace(state, gm=gm)


def profile_pool(preset: str, n: int) -> None:
    """A block-pool path: ``gmapping_cow`` (``chip_smoke.cow_config``: the
    copy-on-write RBPF, 30 particles, 1,024 blocks of 32^2) over the bench
    sequence, or ``mit_stata`` (``configs/mit_stata.properties``, the tiled
    map) over the CLI's synthetic sequence. Scans/s over ``n`` scans after
    a warm-up of ``n``; with a synchronise after each phase, ms and ATen
    calls a scan of the window gather, the match, the marks and the
    prepare, the insert and (the RBPF) the resampling; the launches; the
    device's busy share and the kernels with the most device time. On a
    checkout without ``kernels.pool_prepare`` the prepare is
    ``kernels.pool_touched`` (the marks), then ``cow.prepare_write`` or
    ``blockmap.allocate_tiles`` (the prepare)."""
    from torch.profiler import ProfilerActivity, profile

    from slam_constructor_tpu_torch.ops import blockmap, cow, kernels, resample, scoring
    from slam_constructor_tpu_torch.ops.geometry import compose
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    one_launch = hasattr(kernels, "pool_prepare")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"{preset}: the prepare is {'one kernels.pool_prepare launch' if one_launch else 'kernels.pool_touched, then index ops'}")
    dev = torch.device("cuda")
    rbpf = preset == "gmapping_cow"
    if rbpf:
        from chip_smoke import bench_sequence, cow_config
        from slam_constructor_tpu_torch.models import gmapping

        scans, odom, gt = bench_sequence(dev)
        cfg = cow_config()
        e = gmapping.GMappingEngine(cfg, seed=0)
        e.state.poses = gt[0].expand(cfg.n_particles, 3).clone()
        names = ("proposal", "windows", "match", "weights", "marks", "prepare", "insert",
                 "resample")
    else:
        from slam_constructor_tpu_torch import run
        from slam_constructor_tpu_torch.models import engine
        from slam_constructor_tpu_torch.utils import config as cfglib

        args = run.parse_args(["--config", "configs/mit_stata.properties", "--synthetic",
                               "cecum", "--trajectory", "rectangle", "--steps", str(2 * n),
                               "--out", "build/profile_mit_stata"])
        cfg = cfglib.engine_config_from(cfglib.load_properties(args.config))
        e = engine.Engine(cfg, seed=0)
        scans, odom, gt = run.load_data(args, dev)
        e.state.pose = gt[0].clone()
        names = ("weights", "windows", "match", "marks", "prepare", "insert")
    e.run(scans[:n], odom[:n])  # warm-up, and the map holds n scans
    torch.cuda.synchronize()
    warm = e.state
    e.state = _clone_pool_state(warm, rbpf)
    secs = run_seconds(lambda: e.run(scans[n:2 * n], odom[n:2 * n]))
    print(f"{preset}: {n} scans in {secs:.3f} s = {n / secs:.1f} scans/s "
          f"({secs / n * 1e3:.3f} ms a scan)")

    ms, aten = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    for count_ops in (False, True):
        state = _clone_pool_state(warm, rbpf)
        for i in range(n, 2 * n):
            scan, od = scans[i], odom[i]
            counter = CountOps()

            def phase(name, fn):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if count_ops:
                    with counter:
                        n0 = counter.n
                        out = fn()
                    aten[name] += counter.n - n0
                else:
                    out = fn()
                    torch.cuda.synchronize()
                    ms[name] += time.perf_counter() - t
                return out

            if rbpf:
                p = cfg.n_particles

                def propose():
                    d = gmapping.draw(cfg, gen, dev)
                    return (d, *gmapping.propose(cfg, state.poses, od, d.proposal))

                d, sigma, priors, centers = phase("proposal", propose)
                sc = gmapping.expand_scan(scan, p)
                wt = cfg.window_tiles
                view = phase("windows", lambda: scoring.MapView.of(cow.extract_window(
                    state.gm, cfg.cell_model, None, priors[:, :2], wt, wt), cfg.cell_model))
                poses, incr = phase("match", lambda: gmapping.match_particles(
                    cfg, view, sc, priors, centers, sigma, d))
                logw = phase("weights",
                             lambda: resample.normalize_log_weights(state.log_weights + incr))
                gm = state.gm
                if one_launch:
                    touched, work = phase("prepare", lambda: cow.prepare_insert(
                        gm, cfg.cell_model, poses, sc, cfg.beam))
                    phase("insert", lambda: cow.scatter_observations(
                        gm, cfg.cell_model, poses, sc, cfg.beam, touched, work))
                else:
                    touched = phase("marks", lambda: cow.touched_tiles(gm, poses, sc, cfg.beam))
                    gm = phase("prepare", lambda: cow.prepare_write(gm, cfg.cell_model, touched))
                    phase("insert", lambda: cow.scatter_observations(
                        gm, cfg.cell_model, poses, sc, cfg.beam, touched))

                def resampled():
                    idx, lw, _ = resample.maybe_resample(d.u0, logw, cfg.resample_threshold)
                    return gmapping.GMappingState(
                        gm=cow.resample(gm, idx), poses=poses.index_select(0, idx),
                        log_weights=lw, step=state.step + 1)

                state = phase("resample", resampled)
            else:
                prior = compose(state.pose, od)
                pw = phase("weights", lambda: engine._point_weights(cfg, scan))
                from slam_constructor_tpu_torch.ops import matchers as matcherslib

                _, match_fn = matcherslib.MATCHERS[cfg.matcher]
                view = phase("windows", lambda: scoring.MapView.of(blockmap.extract_window(
                    state.gm, cfg.cell_model, prior[:2], cfg.window_tiles, cfg.window_tiles),
                    cfg.cell_model))

                def match():
                    res = match_fn(view, scan, prior, gen, cfg.matcher_cfg, pw, None)
                    res = engine._refine(cfg, view, scan, res, gen, pw, None)
                    ok = (res.prob >= cfg.min_insert_prob) | (state.step == 0)
                    return res, torch.where(ok, 1.0, 0.0)

                res, q = phase("match", match)
                bm = state.gm
                one = LaserScan(scan.ranges[None], scan.bearings[None], scan.valid[None])
                pose = res.pose[None]
                if one_launch:
                    touched, work = phase("prepare", lambda: blockmap.prepare_tiles(
                        bm, cfg.cell_model, pose, one, cfg.beam, q))
                    phase("insert", lambda: kernels.pool_insert(
                        bm.pool, bm.table[None], bm.origin, bm.scale, cfg.cell_model, pose, one,
                        cfg.beam, touched, q, n_live=bm.n_alloc, work=work))
                else:
                    touched = phase("marks", lambda: kernels.pool_touched(
                        tuple(bm.table.shape), bm.block, bm.origin, bm.scale, pose, one,
                        cfg.beam, q))
                    bm = phase("prepare", lambda: blockmap.allocate_tiles(bm, touched[0]))
                    phase("insert", lambda: kernels.pool_insert(
                        bm.pool, bm.table[None], bm.origin, bm.scale, cfg.cell_model, pose, one,
                        cfg.beam, touched, q, n_live=bm.n_alloc))
                state = engine.SlamState(gm=bm, pose=res.pose, step=state.step + 1,
                                         last_prob=res.prob)
    print("synced phases, ms and ATen calls a scan: " + ", ".join(
        f"{k} {ms[k] / n * 1e3:.3f} ms / {aten[k] / n:.0f}" for k in names)
        + f"; in all {sum(ms.values()) / n * 1e3:.3f} ms / {sum(aten.values()) / n:.0f}")

    e.state = _clone_pool_state(warm, rbpf)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e.run(scans[n:2 * n], odom[n:2 * n])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"launches over {n} scans: { {k: v for k, v in kernels.launch_counts().items() if v} }")
    # (touch_kernel: a parent checkout's marking kernel)
    device_report(prof, n, secs, wall, ("mc_match_kernel", "pool_kernel", "pool_prepare_kernel",
                                        "touch_kernel"))


def profile_full(loop: str | None = None) -> None:
    from chip_smoke import N_BEAMS, N_SCANS, full_config, full_loop_config, full_sequence
    from slam_constructor_tpu_torch.models import full
    from slam_constructor_tpu_torch.ops import kernels
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    scans, odom, gt = full_sequence(dev)
    cfg = full_loop_config(loop) if loop else full_config()
    ours = ("mc_match", "overlap_score_batched", "scan_insert", "scan_planes",
            *({"hill_climbing": ("hill_climb",), "gradient": ("gradient_refine",)}.get(loop, ())))

    def engine_run(instrument=None):
        e = full.FullSlamEngine(cfg, n_beams=N_BEAMS, seed=0)
        e.state.pose = gt[0].clone()
        if instrument:
            instrument(e)
        return e, run_seconds(lambda: e.run(scans, odom, segment=N_SCANS))

    engine_run()  # warm-up
    for _ in range(2):
        e, secs = engine_run()
        print(f"full{' ' + loop if loop else ''}: {N_SCANS} scans in {secs:.3f} s = "
              f"{N_SCANS / secs:.1f} scans/s; "
              f"{int(e.graph.n_kf)} keyframes, {e.n_kf_batches} batches, {e.total_loops} loops, "
              f"{e.n_bursts} bursts")

    # --- phases: a synchronise, the ATen calls and the launches of each -----
    stats = {}

    def phased(name, fn, counter):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            n0, t0 = counter.n, time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            row = stats.setdefault(name(), {"calls": 0, "secs": 0.0, "aten": 0,
                                            **{k: 0 for k in ours}})
            row["calls"] += 1
            row["secs"] += time.perf_counter() - t0
            row["aten"] += counter.n - n0
            after = kernels.launch_counts()
            for k in ours:
                row[k] += after[k] - before[k]
            return out
        return wrapped

    for count_ops in (False, True):
        # the dispatch-mode count slows the host: times come from the run
        # without it, ATen calls from the run with it
        stats.clear()
        counter = CountOps()
        tracked = full.track_segment

        def instrument(e):
            regens = {"now": 0, "seen": 0}
            regen = e._regenerate

            def counted_regen():
                regens["now"] += 1
                return regen()

            def burst_name():  # asked after the burst has run
                moved = regens["now"] > regens["seen"]
                regens["seen"] = regens["now"]
                return "burst with regeneration" if moved else "burst without regeneration"

            e._regenerate = counted_regen
            e._keyframe_batch = phased(lambda: "keyframe batch (process + fetch)",
                                       e._keyframe_batch, counter)
            e._burst = phased(burst_name, e._burst, counter)

        full.track_segment = phased(lambda: "tracking", tracked, counter)
        try:
            if count_ops:
                with counter:
                    engine_run(instrument)
            else:
                _, wall = engine_run(instrument)
        finally:
            full.track_segment = tracked
        if not count_ops:
            timed = {k: dict(v) for k, v in stats.items()}
    print(f"full, a synchronise after each phase: {wall:.3f} s")
    for name, row in timed.items():
        per = N_SCANS if name == "tracking" else row["calls"]
        unit = "scan" if name == "tracking" else "call"
        aten = stats[name]["aten"] / per
        print(f"  {name}: {row['secs']:.3f} s in {row['calls']} calls = "
              f"{row['secs'] / per * 1e3:.3f} ms a {unit}, {aten:.0f} ATen calls a {unit}, launches "
              + ", ".join(f"{k} {row[k]}" for k in ours))
    rest = wall - sum(r["secs"] for r in timed.values())
    print(f"  the rest (capacity, transfers, the corrected trajectory): {rest:.3f} s")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, pwall = engine_run()
    rows = [k for k in prof.key_averages() if getattr(k, "device_time_total", 0) > 0
            and k.device_type.name == "CUDA"]
    dev_s = sum(k.device_time_total for k in rows) * 1e-6
    print(f"profiled run: device kernel time {dev_s:.4f} s = {dev_s / secs * 100:.1f}% of the "
          f"unprofiled {secs:.3f} s ({dev_s / pwall * 100:.1f}% of the profiled {pwall:.3f} s); "
          f"{sum(k.count for k in rows)} kernels")
    mine = [k for k in rows if any(n in k.key for n in (
        "mc_match_kernel", "overlap_score_kernel", "insert_kernel", "hill_climb_kernel",
        "gradient_refine_kernel"))]
    top = sorted(rows, key=lambda k: -k.device_time_total)[:12]
    for k in mine + [k for k in top if k not in mine]:
        print(f"  {k.device_time_total * 1e-3:9.3f} ms  {k.count:6d} x  "
              f"{k.device_time_total / k.count:8.2f} us  {k.key[:90]}")


if __name__ == "__main__":
    main()
