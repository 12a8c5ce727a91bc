"""Short first look at the port's CUDA kernels on a card: build, compiler
report, instruction mix, one launch of each new kernel against its twin,
and back-to-back launch times.

    python3 scripts/torch_port/kernel_probe.py

Prints ptxas' registers, spills and shared memory for every kernel; for
every kernel in the built library the count of SASS instructions by opcode
(``cuobjdump -sass``; the straight-line length of a kernel is what
``chip_smoke.py``'s operation counts for the roofline bound are checked
against); ``polar_free_plane`` (both ways of building its range table)
against ``polar_free_plane_ref`` at 256^2 cells and 360 beams; ``mc_match``
against ``mc_match_rounds`` (bit for bit) and ``mc_match_ref`` at the tiny
and viny main-path shapes; and three times a launch for every kernel:

- chained: 200 calls of the wrapper queued back to back between one pair of
  CUDA events, over 200 (the host's cost of a call shows here);
- graph: the same 200 calls captured once into a CUDA graph and replayed,
  between one pair of events, over 200: the device's time a launch with the
  gap between two kernels, and no host in it;
- device: ``torch.profiler``'s mean device time of the kernel over those
  replays, to hold against the graph's slope.

Imports no JAX.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the checkout's root

FP_OPS = ("FADD", "FMUL", "FFMA", "MUFU", "FSETP", "FMNMX", "FSEL", "F2I", "I2F", "FRND", "FCHK",
          "F2F", "FSET")


def sass_mix(lib: Path) -> None:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                             timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        print(f"sass: cuobjdump not usable ({e})")
        return
    name, mix = None, collections.Counter()

    def flush():
        if name:
            fp = sum(mix[o] for o in FP_OPS) + mix["FFMA"]  # an FFMA is two operations
            top = ", ".join(f"{o} {n}" for o, n in mix.most_common(14))
            print(f"sass [{name}]: {sum(mix.values())} instructions, {fp} f32 operations "
                  f"if every one ran once; {top}")

    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            flush()
            name, mix = m.group(1), collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m:
            mix[m.group(1)] += 1
    flush()


def chained_ms(fn, n: int = 200) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def graph_ms(fn, n: int = 200, replays: int = 7):
    """ms a launch with ``n`` calls of ``fn`` captured into one CUDA graph:
    the median over ``replays`` replays, and the profiler's device time by
    kernel name (us a launch) over them."""
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    device = {k.key: k.device_time_total / k.count for k in prof.key_averages()
              if getattr(k, "device_time_total", 0) > 0 and k.count >= n}
    return sorted(times)[len(times) // 2], device


def report(name, fn) -> None:
    chained = chained_ms(fn)
    graph, device = graph_ms(fn)
    rows = "; ".join(f"{k[:48]} {v:.2f} us" for k, v in device.items()) or "no device rows"
    print(f"time [{name}]: chained {chained * 1e3:.2f} us, graph {graph * 1e3:.2f} us a launch "
          f"(200 each); profiler device time: {rows}", flush=True)


def mc_case(scoring, view, scan, pose, cfg, weights, dev, seed):
    """(args of mc_match) at a preset's matcher shape around ``pose``."""
    m = cfg.matcher_cfg
    prep = scoring.prepare(view, scan, m.scoring, weights)
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((m.rounds, m.batch, 3), generator=g, device=dev)
    prior = pose + torch.tensor([0.04, -0.03, 0.02], device=dev)
    return (prep.plane, prep.pts, prep.beam_w, prep.origin, prior, noise, prep.scale,
            prep.unknown, m.sigma_xy, m.sigma_theta, m.bad_rounds_before_anneal)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from slam_constructor_tpu_torch.models import tiny, viny
    from slam_constructor_tpu_torch.models.engine import init_state
    from slam_constructor_tpu_torch.ops import _build, kernels, raycast, scoring
    from slam_constructor_tpu_torch.utils import datagen

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    res = _build.build()
    print(f"build: {res.seconds:.2f} s")
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _build.load()
    sass_mix(res.path)

    occ, origin, scale = datagen.cecum_world(device=dev)
    pose = torch.tensor([0.3, -1.45, 0.7], device=dev)
    scan = raycast.cast_rays(occ, origin, scale, pose, datagen.default_bearings(360, device=dev))
    beam = viny.viny_config().beam
    args = (scan.ranges, scan.valid, scan.bearings, pose,
            torch.tensor([-12.8, -12.8], device=dev), 256, 256, 0.1, beam.hole_width / 2.0,
            beam.max_range)

    want = kernels.polar_free_plane_ref(*args)
    got = kernels.polar_free_plane(*args)
    torch.cuda.synchronize()
    both = (got > 0) & (want > 0)
    print(f"polar_free_plane vs twin: free {int(both.sum())}, flipped "
          f"{int(((got > 0) != (want > 0)).sum())}, max |diff| "
          f"{float((got - want).abs().max()):.3e}, bitwise equal {torch.equal(got, want)}",
          flush=True)

    mc = {}
    for name, cfg, weights in (
        ("tiny", tiny.tiny_config(map_size=256), None),
        ("viny", viny.viny_config(map_size=256),
         torch.rand((360,), device=dev, generator=torch.Generator(device=dev).manual_seed(3))),
    ):
        gm = raycast.insert_scan(init_state(cfg, dev).gm, cfg.cell_model, pose, scan, cfg.beam)
        view = scoring.MapView.of(gm, cfg.cell_model)
        mc[name] = mc_case(scoring, view, scan, pose, cfg, weights, dev, seed=11)
        got = kernels.mc_match(*mc[name])
        rounds = kernels.mc_match_rounds(*mc[name])
        twin = kernels.mc_match_ref(*mc[name])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, rounds))
        print(f"mc_match [{name}] K={mc[name][5].shape[1]} rounds={mc[name][5].shape[0]} "
              f"R'={mc[name][1].shape[0]}: bitwise equal to mc_match_rounds {same}; "
              f"max |trace diff| {float((got[2] - rounds[2]).abs().max()):.3e}; vs twin: max "
              f"|trace diff| {float((got[2] - twin[2]).abs().max()):.3e}, |pose diff| "
              f"{float((got[0] - twin[0]).abs().max()):.3e}; prob {float(got[1]):.6f}", flush=True)

    cfg = tiny.tiny_config(map_size=256)
    gm = raycast.insert_scan(init_state(cfg, dev).gm, cfg.cell_model, pose, scan, cfg.beam)
    prep = scoring.prepare(scoring.MapView.of(gm, cfg.cell_model), scan, cfg.matcher_cfg.scoring)
    cand = pose + 0.05 * torch.randn((64, 3), device=dev)
    sargs = (prep.plane, cand, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    for name, fn in (
        ("polar_free_plane 256^2 R=360", lambda: kernels.polar_free_plane(*args)),
        ("overlap_score K=64 R=360", lambda: kernels.overlap_score(*sargs)),
        ("mc_match tiny", lambda: kernels.mc_match(*mc["tiny"])),
        ("mc_match viny", lambda: kernels.mc_match(*mc["viny"])),
    ):
        report(name, fn)
    for name, fn in (
        ("torch.empty((256, 256)) alone", lambda: torch.empty((256, 256), device=dev)),
        ("mc_match_rounds tiny", lambda: kernels.mc_match_rounds(*mc["tiny"])),
        ("mc_match_rounds viny", lambda: kernels.mc_match_rounds(*mc["viny"])),
        ("polar_free_plane_ref", lambda: kernels.polar_free_plane_ref(*args)),
    ):
        print(f"chained [{name}]: {chained_ms(fn, 50) * 1e3:.2f} us a call (50 back to back)",
              flush=True)


if __name__ == "__main__":
    main()
