"""Short first look at the port's CUDA kernels on a card: build, compiler
report, instruction mix, one launch of each kernel against its twin, and
back-to-back launch times; with ``--stamps``, where a round of the RBPF's
particle match, an M3RSM match, a gradient refine's pass and an overlap
score's block or warp go.

    python3 scripts/torch_port/kernel_probe.py
    python3 scripts/torch_port/kernel_probe.py --stamps [--only SECTION]
    python3 scripts/torch_port/kernel_probe.py --times [--only NAME] --root DIR [--save F.npz]
    python3 scripts/torch_port/kernel_probe.py --compare A.npz B.npz
    python3 scripts/torch_port/kernel_probe.py --sincos

Prints ptxas' registers, spills and shared memory for every kernel; for
every kernel in the built library the count of SASS instructions by opcode
(``cuobjdump -sass``; the straight-line length of a kernel is what
``chip_smoke.py``'s operation counts for the roofline bound are checked
against); ``polar_free_plane`` against ``polar_free_plane_ref`` at 256^2
cells and 360 beams; ``mc_match`` against ``mc_match_rounds`` (bit for bit)
and ``mc_match_ref`` at the tiny and viny main-path shapes;
``overlap_score_batched`` against its twin and against single-plane launches
(bit for bit) at the loop closer's shapes (M submaps of 120^2 cells cut from
the probe's map, the 343 poses of a 7^3 grid or the 7 of an information
estimate, every second beam) and the RBPF's (30 windows of 160^2, K = 16
and K = 1); the particle match at the RBPF's shape (30 windows of 160^2 cut
from the probe's map, 20 candidates x 5 rounds, every second beam) through
``mc_match_batched`` (the windows cut out) and ``mc_match_windows`` (the
same windows read in place, the occupancy a channel of the maps' cells, as
the RBPF holds it), against 30 single ``mc_match`` launches, bit for bit,
and its twin; the same on whole 256^2 maps; M3RSM's pyramid (K4a: a build
of a 256^2 map at 4 levels, the main path's 144^2 refresh, a build of 32
submaps of 120^2 at 3 levels) against its twin bit for bit, its whole match
(K4b, ``m3rsm_search``: one ``viny_m3rsm`` match on the probe's map, and the
loop closer's over 32 submaps of 120^2) against the level launches bit for
bit and its twin, the level score (the five launches of the viny_m3rsm
match's yardstick) against its twin, and a whole ``m3rsm_match`` call; and
three times a launch for every kernel:

- chained: 200 calls of the wrapper queued back to back between one pair of
  CUDA events, over 200 (the host's cost of a call shows here);
- graph: the same 200 calls captured once into a CUDA graph and replayed,
  between one pair of events, over 200: the device's time a launch with the
  gap between two kernels, and no host in it;
- device: ``torch.profiler``'s mean device time of the kernel over those
  replays, to hold against the graph's slope.

``--stamps`` builds the kernels once more with ``-DSLAM_KERNEL_PROBE``
(``csrc/overlap_sample.cuh``: thread 0 of every block writes ``clock64()``
at the boundaries of its work, and ``%globaltimer`` at its start and end)
and splits a particle match at the RBPF's shape, on the windows cut out
and read in place, into: the set-up (scan and noise copied) and the first
score (each as the time from the block's start at which it is done), and a
round's five parts: (a) the candidate and its trig, (b)
the taps and the beam sums, (c) the reduction, (d) the cluster barrier, the
reads of the scores and the argmax, (e) the state update; and a whole M3RSM
match (``m3rsm_search``: the viny_m3rsm request and the loop closer's 32)
into its set-up (the window and the endpoint cells), each level's score,
cluster barrier with the reads of the scores, and selection, the argmax,
and the hill climb's first score and rounds; and the gradient refine
(``csrc/gradient_refine.cu``) at the paths' five shapes (``gradient_shapes``:
one map at the bilinear reducer and at the overlap of extent 1.5, the
joint refine's 8 maps, the loop closer's submaps, the RBPF's 30 windows at
extent 2) into its set-up and, for the first pass and a later one, the
parts the source stamps (a build of another checkout may stamp other
parts: three, the taps, the fold and tree, the step); and the overlap
score (``csrc/overlap_score.cu``) at the paths' shapes (``overlap_shapes``)
into the parts of the layout that runs each: set-up, beams, barrier, fold
and tree. ``--only`` keeps one section (``mc_match``, ``m3rsm``,
``gradient_refine``, ``overlap_score``). Cycles are turned into time with
the SM clock that the stamps themselves give. A clock read after a barrier
may issue before the warp leaves it: the wait then falls in the part after
it.

``--times`` prints each source's build seconds where the checkout keeps
them and ptxas' report, then times (a call between its own events, the
median of 100, besides the three above) only the wrappers that every
version of the port has
(the batched score at the six shapes above, the particle match at the
RBPF's shape, ``overlap_score``, ``polar_free_plane``, ``mc_match`` tiny and
viny, and both drawing from a step's key where the checkout has
``kernels.KeyNoise``; the M3RSM kernels where the checkout has them, and a whole
``m3rsm_match`` call of the viny_m3rsm preset; the one-launch refines
where the checkout has them: the gradient refine at the five shapes, the
hill climb at mit_csail's; the overlap score at the paths' shapes), and an
empty kernel (the launch floor, ``EMPTY_KERNEL``); ``--only NAME`` keeps
those whose name holds NAME; ``--root DIR`` imports the port from another
checkout (built there): run it on two checkouts in turns (A, B, B, A), one
after another, to compare their kernels on one card; ``--save F.npz`` keeps
the overlap shapes' outputs, and ``--compare A B`` holds two such files bit
for bit (it exits 1 where any differs).

``--sincos`` builds ``sincos_check.cu`` with the port's flags and checks
that ``sincosf`` gives the bits of ``sinf`` and ``cosf`` on all 2^32
inputs (the gradient refine relies on it); it exits 1 where any differs.

Imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout's root
if "--root" in sys.argv:  # the port of another checkout, for timing in turns
    ROOT = Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
sys.path.insert(0, str(ROOT))

FP_OPS = ("FADD", "FMUL", "FFMA", "MUFU", "FSETP", "FMNMX", "FSEL", "F2I", "I2F", "FRND", "FCHK",
          "F2F", "FSET")
P, K, ROUNDS = 30, 20, 5


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


def call_ms(fn, n: int = 100) -> float:
    """The median ms of ``n`` calls, each between its own pair of CUDA
    events (the host's cost of a call included)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[n // 2]


def report(name, fn) -> None:
    chained = chained_ms(fn)
    graph, device = graph_ms(fn)
    call = call_ms(fn)
    rows = "; ".join(f"{k[:48]} {v:.2f} us" for k, v in device.items()) or "no device rows"
    print(f"time [{name}]: a call {call * 1e3:.2f} us (median of 100), chained "
          f"{chained * 1e3:.2f} us, graph {graph * 1e3:.2f} us a launch (200 each); profiler "
          f"device time: {rows}", flush=True)


def mc_case(scoring, view, scan, pose, cfg, weights, dev, seed):
    """(args of mc_match) at a preset's matcher shape around ``pose``."""
    m = cfg.matcher_cfg
    prep = scoring.prepare(view, scan, m.scoring, weights)
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((m.rounds, m.batch, 3), generator=g, device=dev)
    prior = pose + torch.tensor([0.04, -0.03, 0.02], device=dev)
    return (prep.plane, prep.pts, prep.beam_w, prep.origin, prior, noise, prep.scale,
            prep.unknown, m.sigma_xy, m.sigma_theta, m.bad_rounds_before_anneal)


def scene(dev):
    """The probe's map (one scan inserted into a 256^2 tiny map), the scan,
    its pose, and the prepared (plane, scan) of the tiny preset."""
    from slam_constructor_tpu_torch.models import tiny
    from slam_constructor_tpu_torch.models.engine import init_state
    from slam_constructor_tpu_torch.ops import raycast, scoring
    from slam_constructor_tpu_torch.utils import datagen

    occ, origin, scale = datagen.cecum_world(device=dev)
    pose = torch.tensor([0.3, -1.45, 0.7], device=dev)
    scan = raycast.cast_rays(occ, origin, scale, pose, datagen.default_bearings(360, device=dev))
    cfg = tiny.tiny_config(map_size=256)
    gm = raycast.insert_scan(init_state(cfg, dev).gm, cfg.cell_model, pose, scan, cfg.beam)
    prep = scoring.prepare(scoring.MapView.of(gm, cfg.cell_model), scan, cfg.matcher_cfg.scoring)
    return pose, scan, prep


def submaps(prep, pose, dev, n_maps, k, size=120):
    """(args of overlap_score_batched): ``size``^2 crops of the plane, each
    with its own origin, scan mask and poses."""
    from slam_constructor_tpu_torch.ops import matchers

    grid = matchers.brute_force_offsets(matchers.BruteForceConfig(
        half_x=0.6, half_y=0.6, half_theta=0.3, n_x=7, n_y=7, n_theta=7), dev)[:k]
    planes, origins, weights, poses = [], [], [], []
    for m in range(n_maps):
        r0, c0 = 60 + 2 * (m % 9), 70 + 3 * (m % 7)
        planes.append(prep.plane[r0:r0 + size, c0:c0 + size])
        origins.append(prep.origin + torch.tensor([c0 * 0.1, r0 * 0.1], device=dev))
        weights.append(prep.beam_w[::2] * (torch.arange(180, device=dev) % (5 + m % 3) != 1))
        poses.append(pose + grid + 0.01 * m)
    return (torch.stack(planes).contiguous(), torch.stack(poses).contiguous(),
            prep.pts[::2][None].expand(n_maps, -1, -1).contiguous(), torch.stack(weights),
            torch.stack(origins), prep.scale, prep.unknown)


def particle_cases(prep, pose, dev, size=160):
    """The RBPF's particle match on the probe's map: (args of
    mc_match_batched on the cut-out windows, args of mc_match_windows on
    the same windows in place). The maps are the plane as channel 0 of
    cells [P, 256, 256, 2] whose channel 1 (weight 1) marks every cell
    known, so both read the same values; ``size`` 256 is the whole map."""
    g = torch.Generator(device=dev).manual_seed(5)
    whole = size == 256
    rows = torch.zeros(P, dtype=torch.int64) if whole else 40 + 2 * torch.arange(P) % 17
    cols = torch.zeros(P, dtype=torch.int64) if whole else 50 + 3 * torch.arange(P) % 23
    rows, cols = rows.to(dev), cols.to(dev)
    cells = torch.stack([prep.plane, torch.ones_like(prep.plane)], -1).expand(P, -1, -1, -1)
    cells = cells.contiguous()
    occ, known = cells[..., 0], cells[..., 1] > 0
    planes = torch.stack([prep.plane[r:r + size, c:c + size]
                          for r, c in zip(rows.tolist(), cols.tolist())])
    origin = prep.origin + torch.stack([cols, rows], -1).to(torch.float32) * prep.scale
    rest = (prep.pts[::2][None].expand(P, -1, -1).contiguous(),
            prep.beam_w[::2][None].expand(P, -1).contiguous(), origin,
            (pose + 0.05 * torch.randn((P, 3), generator=g, device=dev)).contiguous(),
            torch.randn((P, ROUNDS, K, 3), generator=g, device=dev),
            prep.scale, prep.unknown, 0.06, 0.03, 2)
    return (planes.contiguous(), *rest), (occ, known, rows, cols, size, size, *rest)


def m3rsm_cases(pose, scan, dev):
    """K4a's arguments (a build of a ``viny_m3rsm`` map at 256^2 with one
    scan in it, the main path's 144^2 refresh of it, a build of 32 crops of
    120^2 at 3 levels) and K4b's (the whole match from 0.1 m and 0.03 rad
    off the scan's pose, the loop closer's over the 32 crops, and the five
    level launches of the first's yardstick; in a checkout without the
    whole match, the five level launches of the match), as {name:
    (wrapper, twin, args)}."""
    from slam_constructor_tpu_torch.models import engine, viny
    from slam_constructor_tpu_torch.ops import kernels, m3rsm, raycast, scoring

    cfg = viny.viny_m3rsm_config(map_size=256)
    st = engine.init_state(cfg, dev)
    gm = raycast.insert_scan(st.gm, cfg.cell_model, pose, scan, cfg.beam)
    view = scoring.MapView.of(gm, cfg.cell_model)
    g = torch.Generator(device=dev).manual_seed(5)
    rows = torch.randint(0, 136, (32,), generator=g, device=dev)
    cols = torch.randint(0, 136, (32,), generator=g, device=dev)
    crops = [view.occ[r:r + 120, c:c + 120] for r, c in zip(rows.tolist(), cols.tolist())]
    masks = [view.known[r:r + 120, c:c + 120] for r, c in zip(rows.tolist(), cols.tolist())]
    planes = kernels.m3rsm_pyramid(view.occ, view.known, 4, 0.5)
    update = (planes, view.occ, view.known, torch.tensor([128, 128], device=dev), 144, 0.5,
              torch.ones((), device=dev))
    out = {
        "m3rsm_pyramid build 256^2 L=4": (kernels.m3rsm_pyramid, kernels.m3rsm_pyramid_ref,
                                          (view.occ, view.known, 4, 0.5)),
        "m3rsm_pyramid update 144^2 of 256^2 L=4": (kernels.m3rsm_pyramid_update,
                                                    kernels.m3rsm_pyramid_update_ref, update),
        "m3rsm_pyramid build 32 x 120^2 L=3": (
            kernels.m3rsm_pyramid, kernels.m3rsm_pyramid_ref,
            (torch.stack(crops), torch.stack(masks), 3, 0.5)),
    }
    prior = pose + torch.tensor([0.1, -0.1, 0.03], device=dev)
    weights = engine._point_weights(cfg, scan)
    if not hasattr(kernels, "m3rsm_search"):  # a checkout with a level launch a level
        kept, level = [], kernels.m3rsm_score_level

        def keep(*args):
            kept.append(args)
            return level(*args)

        kernels.m3rsm_score_level = keep
        try:
            m3rsm.m3rsm_match(view, scan, prior, None, cfg.matcher_cfg, weights, pyramid=planes)
        finally:
            kernels.m3rsm_score_level = level
        for a in kept:
            out[f"m3rsm_level level {a[2]} K={a[6].shape[1]} window {a[3]}^2"] = (
                kernels.m3rsm_score_level, kernels.m3rsm_score_level_ref, a)
        return out
    # the whole match's arguments: viny_m3rsm's, and the loop closer's over 32
    # submaps (the crops) with a request each
    searches, search = [], kernels.m3rsm_search
    kernels.m3rsm_search = lambda s: searches.append(s) or search(s)
    try:
        m3rsm.m3rsm_match(view, scan, prior, None, cfg.matcher_cfg, weights, pyramid=planes)
        loop = m3rsm.M3RSMConfig(levels=3, half_x=0.6, half_y=0.6, half_theta=0.3, n_theta=7,
                                 scoring=scoring.ScoringConfig(reducer="overlap", stride=2))
        maps = scoring.MapView(occ=torch.stack(crops), known=torch.stack(masks),
                               origin=view.origin + torch.stack([cols, rows], -1) * view.scale,
                               scale=view.scale)
        scans = type(scan)(*(a.expand(32, -1) for a in (scan.ranges, scan.bearings, scan.valid)))
        priors = maps.origin + 6.0 + torch.zeros((32, 1), device=dev)
        priors = torch.cat([priors, torch.full((32, 1), 0.3, device=dev)], -1)
        m3rsm.m3rsm_match(maps, scans, priors, None, loop)
    finally:
        kernels.m3rsm_search = search
    out["m3rsm_search viny_m3rsm B=1 K=9..192"] = (
        kernels.m3rsm_search, kernels.m3rsm_search_ref, (searches[0],))
    out["m3rsm_search loop closer B=32 K=28..1024 120^2"] = (
        kernels.m3rsm_search, kernels.m3rsm_search_ref, (searches[1],))
    kept, level = [], kernels.m3rsm_score_level

    def keep(*args):
        kept.append(args)
        return level(*args)

    kernels.m3rsm_score_level = keep
    try:
        kernels.m3rsm_search_levels(searches[0])
    finally:
        kernels.m3rsm_score_level = level
    for a in kept:
        out[f"m3rsm_level level {a[2]} K={a[6].shape[1]} window {a[3]}^2"] = (
            kernels.m3rsm_score_level, kernels.m3rsm_score_level_ref, a)
    return out


def m3rsm_match_call(pose, scan, dev):
    """A whole ``m3rsm_match`` call of the viny_m3rsm preset on the probe's
    map with its live pyramid handed in: what a scan's match costs the host
    and the device, in any checkout that has M3RSM."""
    from slam_constructor_tpu_torch.models import engine, viny
    from slam_constructor_tpu_torch.ops import m3rsm, raycast, scoring

    cfg = viny.viny_m3rsm_config(map_size=256)
    gm = raycast.insert_scan(engine.init_state(cfg, dev).gm, cfg.cell_model, pose, scan, cfg.beam)
    view = scoring.MapView.of(gm, cfg.cell_model)
    planes = m3rsm.build_pyramid(view, 4, 0.5)
    prior = pose + torch.tensor([0.1, -0.1, 0.03], device=dev)
    weights = engine._point_weights(cfg, scan)
    return lambda: m3rsm.m3rsm_match(view, scan, prior, None, cfg.matcher_cfg, weights,
                                     pyramid=planes)


def gradient_shapes(prep, pose, dev):
    """The gradient refine at the five shapes of the paths, on the probe's
    map, from start poses off the truth: {name: args of
    ``kernels.gradient_refine``}. One map at the bilinear reducer and at
    the overlap of extent 1.5 on 3^2 cells (tiny_refined's CLI: 12
    iterations of 0.03 m, 0.015 rad); the joint refine's 8 maps (the
    reference's default config: bilinear, 24 iterations of 0.06 m, 0.03
    rad); the loop closer's submaps (4 crops of 120^2, every second beam,
    extent 1.5 on 3^2 cells, 12 iterations of 0.06 m, 0.03 rad); the RBPF's
    30 windows of 160^2 (every second beam, extent 2 on 5^2 cells, 8
    iterations of 0.04 m, 0.02 rad)."""
    from slam_constructor_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(7)
    start = (pose + torch.tensor([0.04, -0.03, 0.02], device=dev)).contiguous()
    one = (prep.plane, prep.pts, prep.beam_w, prep.origin, start, prep.scale, prep.unknown)

    def spread(n):
        return (start + torch.randn((n, 3), generator=g, device=dev) * torch.tensor(
            [0.04, 0.04, 0.02], device=dev)).contiguous()

    joint = (*(t.expand(8, *t.shape).contiguous() for t in one[:4]), spread(8), *one[5:])
    sub = submaps(prep, pose, dev, 4, 1)
    sub = (sub[0], sub[2], sub[3], sub[4],
           (start + 0.01 * torch.arange(4, device=dev)[:, None]).contiguous(), *sub[5:])
    cut, _ = particle_cases(prep, pose, dev)
    windows = (*cut[:5], *cut[6:8])  # without the Monte-Carlo noise
    e15, e2 = kernels.Reducer("overlap", 1, 1.5), kernels.Reducer("overlap", 2, 2.0)
    return {
        "gradient_refine one map bilinear 256^2 R=360 12 iterations": (
            *one, 0.03, 0.015, 12, 0.5, kernels.BILINEAR),
        "gradient_refine joint refine M=8 bilinear 256^2 R=360 24 iterations": (
            *joint, 0.06, 0.03, 24, 0.5, kernels.BILINEAR),
        "gradient_refine one map overlap e1.5 w1 256^2 R=360 12 iterations": (
            *one, 0.03, 0.015, 12, 0.5, e15),
        "gradient_refine submaps M=4 overlap e1.5 w1 120^2 R'=180 12 iterations": (
            *sub, 0.06, 0.03, 12, 0.5, e15),
        "gradient_refine M=30 overlap e2 w2 160^2 R'=180 8 iterations": (
            *windows, 0.04, 0.02, 8, 0.5, e2),
    }


def refine_cases(prep, pose):
    """The one-launch refines on the probe's map: the gradient refine at the
    paths' five shapes (``gradient_shapes``), the hill climb at mit_csail's
    settings (10 rounds), one map and 8, from a start pose off the truth."""
    from slam_constructor_tpu_torch.ops import kernels

    start = (pose + torch.tensor([0.04, -0.03, 0.02], device=pose.device)).contiguous()
    args = (prep.plane, prep.pts, prep.beam_w, prep.origin, start, prep.scale, prep.unknown)
    many = tuple(t.expand(8, *t.shape).contiguous() for t in args[:5])
    out = {name: (kernels.gradient_refine, a)
           for name, a in gradient_shapes(prep, pose, pose.device).items()}
    out.update({
        "hill_climb 256^2 R=360 10 rounds": (kernels.hill_climb, (*args, 0.025, 0.01, 10, 0.5)),
        "hill_climb M=8 256^2 R=360 10 rounds": (
            kernels.hill_climb, (*many, *args[5:], 0.025, 0.01, 10, 0.5)),
    })
    return out


def overlap_shapes(prep, pose, scan, dev):
    """K1's score at the shapes of the paths, on the probe's map: {name:
    (wrapper, args)}. One map: K = 1 at the obstacle reducer (tiny_refined's
    flat refine), K = 6 on a 1024^2 map at 0.05 m (mit_csail's hill-climb
    round; the probe's scan inserted into it), K = 64 (bilinear), the 1,089
    poses of the brute-force matcher's 11 x 11 x 9 grid; M maps: the loop
    closer's 32 submaps of 120^2 x 343 poses, the RBPF's 30 windows of 160^2
    x 16 and x 1 poses (every second beam); the partial mode at K = 64 on the
    first band of two of the 256^2 plane (rows 0-128 owned, 129 rows held);
    and the loop closer's narrower batches, 8, 12 and 16 submaps x 343."""
    from slam_constructor_tpu_torch.models import tiny
    from slam_constructor_tpu_torch.models.engine import init_state
    from slam_constructor_tpu_torch.ops import kernels, matchers, raycast, scoring

    g = torch.Generator(device=dev).manual_seed(13)

    def near(k):
        return (pose + torch.randn((k, 3), generator=g, device=dev) * torch.tensor(
            [0.05, 0.05, 0.03], device=dev)).contiguous()

    cfg = tiny.tiny_config(map_size=1024, map_scale=0.05)
    gm = raycast.insert_scan(init_state(cfg, dev).gm, cfg.cell_model, pose, scan, cfg.beam)
    big = scoring.prepare(scoring.MapView.of(gm, cfg.cell_model), scan, cfg.matcher_cfg.scoring)
    grid = (pose + matchers.brute_force_offsets(matchers.BruteForceConfig(), dev)).contiguous()
    one = (prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    k64 = near(64)
    return {
        "overlap_score K=1 R=360 256^2 obstacle": (
            kernels.overlap_score, (prep.plane, near(1), *one, kernels.Reducer("obstacle"))),
        "overlap_score K=6 R=360 1024^2": (
            kernels.overlap_score, (big.plane, near(6), big.pts, big.beam_w, big.origin,
                                    big.scale, big.unknown)),
        "overlap_score K=64 R=360 256^2": (kernels.overlap_score, (prep.plane, k64, *one)),
        "overlap_score K=1089 R=360 256^2 brute-force grid": (
            kernels.overlap_score, (prep.plane, grid, *one)),
        "overlap_score_batched M=32 K=343 R'=180 120^2": (
            kernels.overlap_score_batched, submaps(prep, pose, dev, 32, 343)),
        **{f"overlap_score_batched M={m} K=343 R'=180 120^2": (
            kernels.overlap_score_batched, submaps(prep, pose, dev, m, 343)) for m in (8, 12, 16)},
        "overlap_score_batched M=30 K=16 R'=180 160^2": (
            kernels.overlap_score_batched, submaps(prep, pose, dev, 30, 16, 160)),
        "overlap_score_batched M=30 K=1 R'=180 160^2": (
            kernels.overlap_score_batched, submaps(prep, pose, dev, 30, 1, 160)),
        "overlap_score_partial K=64 R=360 rows 0-128 of 256 (129-row band)": (
            kernels.overlap_score_partial,
            (prep.plane[:129].contiguous(), 0, 256, k64, *one[:5], 0, 128)),
    }


#: an empty kernel and its launcher: the launch floor a graph replay gives
EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def empty_launcher():
    """Builds ``EMPTY_KERNEL`` with the port's architecture flags (into this
    script's checkout's ``build/``) and returns a function that launches it
    on the current stream."""
    from slam_constructor_tpu_torch.ops import _build

    out = Path(__file__).resolve().parents[2] / "build" / "empty_kernel"
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(EMPTY_KERNEL)
    subprocess.run([_build.find_nvcc(), *_build.ARCH_FLAGS, "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(out / "libempty.so"), str(out / "empty.cu")], check=True)
    fn = ctypes.CDLL(str(out / "libempty.so")).empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        if fn(torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("empty kernel launch failed")

    return launch


#: the parts an overlap-score stamp build writes, by the layout's code in
#: slot 60: a group of 128 threads a pair, a beam a thread, a warp a pair
OVERLAP_PARTS = {1: ["set-up (trig, barrier)", "beams", "tree"],
                 2: ["set-up (sincosf)", "its beam", "barrier", "fold + tree"],
                 3: ["set-up (sincosf)", "beams", "tree"]}


def overlap_stamps(lib, name, n_units) -> None:
    """Prints the parts of the first ``n_units`` stamped blocks (or warps) of
    the last overlap-score launch: each part's mean, a unit's start to end,
    the first start to the last end."""
    slots, n_slots = 256, 64
    buf = (ctypes.c_ulonglong * (slots * n_slots))()
    err = lib.overlap_score_probe_stamps(ctypes.byref(buf))
    if err:
        raise RuntimeError(f"overlap_score_probe_stamps: cudaError_t {err}")
    n = min(n_units, slots)
    st = np.frombuffer(buf, np.uint64).reshape(slots, n_slots)[:n].astype(np.float64)
    # cycles over ns, summed over the units (a unit lasts a few us: the
    # globaltimer's steps average out)
    ghz = float((st[:, 62] - st[:, 0]).sum() / (st[:, 63] - st[:, 1]).sum())
    cyc = 1e-3 / ghz  # us a cycle
    layout, n_p = int(st[0, 60]), int(st[0, 61])
    names = OVERLAP_PARTS.get(layout, [f"part {k}" for k in range(n_p)])
    ends = [0] + list(range(2, 2 + n_p)) + [62]
    parts = [float(np.mean(st[:, b] - st[:, a])) * cyc for a, b in zip(ends[:-1], ends[1:])]
    print(f"stamps [{name}]: {n} units stamped, SM clock {ghz:.3f} GHz, a unit "
          f"{float(np.mean(st[:, 62] - st[:, 0])) * cyc:.3f} us: "
          + ", ".join(f"{a} {x:.3f}" for a, x in zip(names + ["write"], parts))
          + f"; the first start to the last end {(st[:, 63].max() - st[:, 1].min()) * 1e-3:.2f} us",
          flush=True)


def same_bits(a, b) -> bool:
    return all(torch.equal(x.reshape(-1).view(torch.int32), y.reshape(-1).view(torch.int32))
               for x, y in zip(a, b))


def stamps_main(dev, only: str = "") -> None:
    """The stamp build: a particle match, an M3RSM match, the gradient
    refine and the overlap score split into their parts; only the sections
    (``mc_match``, ``m3rsm``, ``gradient_refine``, ``overlap_score``) whose
    name holds ``only``."""
    from slam_constructor_tpu_torch.ops import _build, kernels

    res = _build.build(("-DSLAM_KERNEL_PROBE",))
    print(f"stamp build: {res.seconds:.2f} s")
    lib = ctypes.CDLL(str(res.path))
    _build.load = lambda: lib  # every wrapper launches the stamped kernels
    slots, n_slots = 256, 64
    pose, scan, prep = scene(dev)
    cut, in_place = particle_cases(prep, pose, dev)

    # the overlap score (overlap_score.cu) at the paths' shapes: the last
    # launch's first 256 blocks (or warps), split into the parts its source
    # stamps
    if only in "overlap_score":
        for name, (fn, a) in overlap_shapes(prep, pose, scan, dev).items():
            for _ in range(3):
                fn(*a)
            torch.cuda.synchronize()
            units = a[3].shape[0] if "partial" in name else a[1].shape[:-1].numel()
            overlap_stamps(lib, name, units)
    if only and only not in "mc_match m3rsm gradient_refine":
        return

    def split(reader, n_blocks, name):
        buf = (ctypes.c_ulonglong * (slots * n_slots))()
        err = getattr(lib, reader)(ctypes.byref(buf))
        if err:
            raise RuntimeError(f"{reader}: cudaError_t {err}")
        s = np.frombuffer(buf, np.uint64).reshape(slots, n_slots)[:n_blocks].astype(np.float64)
        ghz = float(np.median((s[:, 62] - s[:, 0]) / (s[:, 63] - s[:, 1])))
        us = 1e-3 / ghz  # a cycle

        def mean(a):
            return float(np.mean(a)) * us

        prev, parts = np.maximum(s[:, 2], s[:, 3]), np.zeros((ROUNDS, 5))
        for r in range(ROUNDS):
            b = 4 + 5 * r
            parts[r] = [mean(s[:, b] - prev)] + [mean(s[:, b + i + 1] - s[:, b + i]) for i in range(4)]
            prev = s[:, b + 4]
        whole = (s[:, 63].max() - s[:, 1].min()) * 1e-3
        print(f"stamps [{name}]: {n_blocks} blocks, SM clock {ghz:.3f} GHz, first block start "
              f"to last block end {whole:.2f} us; after the block's start the set-up is done at "
              f"{mean(s[:, 2] - s[:, 0]):.2f} us and the first score at "
              f"{mean(s[:, 3] - s[:, 0]):.2f} us, end {mean(s[:, 62] - prev):.2f} us; a "
              f"round (mean of {ROUNDS}): (a) candidate + trig {parts[:, 0].mean():.2f}, (b) taps "
              f"+ beam sums {parts[:, 1].mean():.2f}, (c) reduction {parts[:, 2].mean():.2f}, (d) "
              f"barrier + score reads + argmax {parts[:, 3].mean():.2f}, (e) state update "
              f"{parts[:, 4].mean():.2f} us; rounds "
              + ", ".join(f"{p.sum():.2f}" for p in parts) + " us", flush=True)

    for name, fn in (("cut out", lambda: kernels.mc_match_batched(*cut)),
                     ("read in place", lambda: kernels.mc_match_windows(*in_place))):
        if only not in "mc_match":
            break
        for _ in range(3):  # warm-up; the last launch's stamps stay
            fn()
        torch.cuda.synchronize()
        split("mc_match_probe_stamps", P * -(-K // 8), f"mc_match.cu for {P} particles, windows {name}")

    # the whole M3RSM match (m3rsm_match.cu): block 0 of each request's
    # cluster, from its start: the set-up, then a level's score (warp 0),
    # barrier and score reads, selection; the argmax, the first hill-climb
    # score and its rounds
    for name, (fn, _, a) in m3rsm_cases(pose, scan, dev).items():
        if not name.startswith("m3rsm_search") or only not in "m3rsm_search":
            continue
        search = a[0]
        for _ in range(3):
            fn(*a)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (slots * n_slots))()
        err = lib.m3rsm_match_probe_stamps(ctypes.byref(buf))
        if err:
            raise RuntimeError(f"m3rsm_match_probe_stamps: cudaError_t {err}")
        levels = len(search.planes) - 1
        ks = kernels.m3rsm_frontiers(search.top.shape[0], search.beam_width, levels)
        width = min(8, max(ks))  # the cluster's blocks
        n_b = min(search.prior.shape[0], slots // width)
        st = np.frombuffer(buf, np.uint64).reshape(slots, n_slots)[:n_b * width:width]
        st = st.astype(np.float64)
        ghz = float(np.median((st[:, 62] - st[:, 0]) / (st[:, 63] - st[:, 1])))

        def us(a, b):
            return float(np.mean(st[:, b] - st[:, a])) / ghz * 1e-3

        parts = [f"set-up {us(0, 2):.2f} (copies and corner {us(0, 29):.2f}, endpoint cells "
                 f"{us(29, 61):.2f}, staged windows {us(61, 2):.2f})"]
        prev = 2
        for n in range(levels + 1):
            lv = f"level {levels - n} (K={ks[n]}): score {us(prev, 3 + 3 * n):.2f}, barrier + reads "
            lv += f"{us(3 + 3 * n, 4 + 3 * n):.2f}"
            prev = 4 + 3 * n
            if n < levels:
                lv += f", selection {us(4 + 3 * n, 5 + 3 * n):.2f}"
                prev = 5 + 3 * n
            parts.append(lv)
        parts.append(f"last barrier {us(prev, 30):.2f}, argmax {us(30, 31):.2f}")
        if search.iterations:
            rounds = [us(32 + i, 33 + i) for i in range(min(search.iterations, 28))]
            parts.append(f"first hill-climb score {us(31, 32):.2f}, a round {np.mean(rounds):.2f} "
                         f"(x {search.iterations}: " + ", ".join(f"{x:.2f}" for x in rounds) + ")")
        print(f"stamps [{name}]: block 0 of {n_b} requests, SM clock {ghz:.3f} GHz, the whole "
              f"{us(0, 62):.2f} us; " + "; ".join(parts) + " (us)", flush=True)

    # the gradient refine (gradient_refine.cu) at the paths' five shapes,
    # every block: its set-up, its first pass and a later pass (the mean of
    # the others) split into the parts the source stamps
    for name, a in gradient_shapes(prep, pose, dev).items():
        if only not in "gradient_refine":
            break
        for _ in range(3):
            kernels.gradient_refine(*a)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (slots * n_slots))()
        err = lib.gradient_refine_probe_stamps(ctypes.byref(buf))
        if err:
            raise RuntimeError(f"gradient_refine_probe_stamps: cudaError_t {err}")
        n_b = a[0].shape[0] if a[0].dim() == 3 else 1
        st = np.frombuffer(buf, np.uint64).reshape(slots, n_slots)[:n_b].astype(np.float64)
        ghz = float(np.median((st[:, 62] - st[:, 0]) / (st[:, 63] - st[:, 1])))
        cyc = 1e-3 / ghz  # us a cycle
        n_p = int(st[0, 61])
        names = REFINE_PARTS.get(n_p, [f"part {k}" for k in range(n_p)])
        passes = st[:, 3 + 2 * n_p]
        first = [float(np.mean(st[:, 3 + k])) * cyc for k in range(n_p)]
        later = [float(np.mean((st[:, 3 + n_p + k] - st[:, 3 + k]) / np.maximum(passes - 1, 1)))
                 * cyc for k in range(n_p)]
        tail = float(np.mean(st[:, 62] - st[:, 2] - st[:, 3 + n_p:3 + 2 * n_p].sum(1))) * cyc
        beam = ""
        if st[0, 42] > 0:  # the first beam thread's own beam, where the source stamps it
            later_beam = np.mean((st[:, 41] - st[:, 40]) / np.maximum(st[:, 42] - 1, 1)) * cyc
            beam = (f"; the first beam thread's beam: the first pass "
                    f"{float(np.mean(st[:, 40])) * cyc:.3f}, a later pass {later_beam:.3f}")
        print(f"stamps [{name}]: {n_b} blocks, SM clock {ghz:.3f} GHz, a block "
              f"{float(np.mean(st[:, 62] - st[:, 0])) * cyc:.2f} us ({int(passes[0])} passes): "
              f"set-up {float(np.mean(st[:, 2] - st[:, 0])) * cyc:.2f}; the first pass: "
              + ", ".join(f"{n} {x:.3f}" for n, x in zip(names, first)) + "; a later pass: "
              + ", ".join(f"{n} {x:.3f}" for n, x in zip(names, later))
              + f" (sum {sum(later):.3f}){beam}; the end {tail:.2f} (us)", flush=True)


#: the names of the parts of a gradient refine's pass, by their count in the
#: stamps: three (taps to the barrier after them, fold and tree, step and
#: hand-off) or six (warp 0's candidate after a rejection, the barrier, the
#: fold, the tree across lanes, the step, the hand-off)
REFINE_PARTS = {3: ["taps", "fold + tree", "step"],
                6: ["speculate", "barrier", "fold", "tree", "step", "hand-off"]}


def times_main(dev, only: str = "", save: str = "") -> None:
    """The times of the wrappers every version of the port has, at the
    shapes of the full probe, the overlap score at the paths' shapes
    (``overlap_shapes``) and an empty kernel; only those whose name holds
    ``only``. ``save``: an ``.npz`` for the overlap shapes' outputs."""
    from slam_constructor_tpu_torch.models import tiny, viny
    from slam_constructor_tpu_torch.models.engine import init_state
    from slam_constructor_tpu_torch.ops import _build, kernels, raycast, scoring

    res = _build.build()
    print(f"build: {res.seconds:.2f} s; by source {getattr(res, 'source_seconds', 'not kept')}",
          flush=True)
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    pose, scan, prep = scene(dev)
    mc, scan_form = {}, {}
    for name, cfg in (("tiny", tiny.tiny_config(map_size=256)), ("viny", viny.viny_config(map_size=256))):
        gm = raycast.insert_scan(init_state(cfg, dev).gm, cfg.cell_model, pose, scan, cfg.beam)
        weights = (torch.rand((360,), device=dev, generator=torch.Generator(device=dev).manual_seed(3))
                   if name == "viny" else None)
        mc[name] = mc_case(scoring, scoring.MapView.of(gm, cfg.cell_model), scan, pose, cfg, weights,
                           dev, seed=11)
        scan_form[name] = (cfg, weights, mc[name])
    cut, in_place = particle_cases(prep, pose, dev)
    beam = viny.viny_config().beam
    polar_args = (scan.ranges, scan.valid, scan.bearings, pose,
                  torch.tensor([-12.8, -12.8], device=dev), 256, 256, 0.1, beam.hole_width / 2.0,
                  beam.max_range)
    cand = pose + 0.05 * torch.randn((64, 3), generator=torch.Generator(device=dev).manual_seed(2),
                                     device=dev)
    sargs = (prep.plane, cand, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    fns = [(f"overlap_score_batched M={m} K={k} {s}^2",
            lambda a=submaps(prep, pose, dev, m, k, s): kernels.overlap_score_batched(*a))
           for m, k, s in ((32, 343, 120), (32, 7, 120), (4, 343, 120), (1, 343, 120), (30, 16, 160),
                           (30, 1, 160))]
    fns += [("mc_match_batched P=30 K=20 rounds=5 160^2", lambda: kernels.mc_match_batched(*cut))]
    if hasattr(kernels, "mc_match_windows"):
        fns += [("mc_match_windows P=30 K=20 rounds=5 160^2",
                 lambda: kernels.mc_match_windows(*in_place))]
    fns += [("overlap_score K=64 R=360", lambda: kernels.overlap_score(*sargs)),
            ("polar_free_plane 256^2 R=360", lambda: kernels.polar_free_plane(*polar_args)),
            ("mc_match tiny", lambda: kernels.mc_match(*mc["tiny"])),
            ("mc_match viny", lambda: kernels.mc_match(*mc["viny"]))]
    fns += keyed_match_calls(kernels, mc, dev)
    fns += scan_match_calls(kernels, scan_form, scan, pose, dev)
    if hasattr(kernels, "beam_weights"):
        fns += [("beam_weights R=360 (viny's weights)",
                 lambda: kernels.beam_weights(scan.ranges, scan.bearings, scan.valid))]
    if hasattr(kernels, "m3rsm_pyramid"):
        fns += [(name, lambda f=f, a=a: f(*a))
                for name, (f, _, a) in m3rsm_cases(pose, scan, dev).items()]
        fns += [("m3rsm_match viny_m3rsm (the whole call)", m3rsm_match_call(pose, scan, dev))]
    if hasattr(kernels, "hill_climb"):
        fns += [(name, lambda f=f, a=a: f(*a)) for name, (f, a) in refine_cases(prep, pose).items()]
    shapes = overlap_shapes(prep, pose, scan, dev)
    fns += [(name, lambda f=f, a=a: f(*a)) for name, (f, a) in shapes.items()
            if hasattr(kernels, f.__name__)]
    for name, fn in fns:
        if only in name:
            report(name, fn)
    report("empty kernel (the launch floor)", empty_launcher())
    if save:  # the overlap shapes' outputs, to hold two checkouts bit for bit
        outs = {name: f(*a).cpu().numpy() for name, (f, a) in shapes.items()
                if hasattr(kernels, f.__name__)}
        np.savez(save, **outs)
        print(f"saved {len(outs)} outputs to {save}", flush=True)


def sincos_main() -> None:
    """Builds and runs ``sincos_check.cu`` with the port's numerics flags."""
    from slam_constructor_tpu_torch.ops import _build

    out = ROOT / "build" / "sincos_check"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.COMPILE_FLAGS if f not in ("-c", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.find_nvcc(), *flags, "-o", str(out),
                    str(Path(__file__).resolve().parent / "sincos_check.cu")], check=True)
    sys.exit(subprocess.run([str(out)]).returncode)


def compare_main(a: str, b: str) -> None:
    """Holds the outputs two ``--times --save`` runs saved bit for bit."""
    x, y = np.load(a), np.load(b)
    same = True
    for name in sorted(set(x.files) | set(y.files)):
        eq = (name in x.files and name in y.files and x[name].shape == y[name].shape
              and np.array_equal(x[name].view(np.uint32), y[name].view(np.uint32)))
        same &= eq
        print(f"compare [{name}]: {'bit for bit' if eq else 'DIFFERS'}")
    sys.exit(0 if same else 1)


def keyed_match_calls(kernels, mc, dev) -> list:
    """Where the tree has it (``kernels.KeyNoise``): tiny's and viny's
    matches drawing their numbers from a step's key inside the launch, and
    the plain step's draws alone that the launch replaces."""
    if not hasattr(kernels, "KeyNoise"):
        return []
    key = torch.tensor([0, 42], dtype=torch.int32, device=dev).view(torch.uint32)
    out = []
    for name in ("tiny", "viny"):
        a = list(mc[name])
        rounds, batch = a[5].shape[0], a[5].shape[1]
        a[5] = kernels.KeyNoise(key, rounds, batch, step=True)
        out.append((f"mc_match {name}, its draws from the step's key",
                    lambda a=tuple(a): kernels.mc_match(*a)))
    return out


def scan_match_calls(kernels, scan_form, scan, pose, dev) -> list:
    """Where the tree has it (``kernels.mc_match_scan``): tiny's and viny's
    matches from the scan and the odometry (the prior's compose and the
    scan's points in the match's prologue), drawing from a step's key, as
    the engine's step runs them; ``scan_form`` holds each preset's (config,
    point weights, ``mc_case`` arguments)."""
    if not hasattr(kernels, "mc_match_scan"):
        return []
    key = torch.tensor([0, 42], dtype=torch.int32, device=dev).view(torch.uint32)
    odom = torch.tensor([0.04, -0.03, 0.02], device=dev)
    out = []
    for name, (cfg, weights, a) in scan_form.items():
        m = cfg.matcher_cfg
        args = (a[0], scan.ranges, scan.bearings, scan.valid, weights, m.scoring.stride, a[3],
                pose, odom, kernels.KeyNoise(key, m.rounds, m.batch, step=True), *a[6:])
        out.append((f"mc_match {name}, from the scan and the odometry, its draws from the "
                    f"step's key", lambda args=args: kernels.mc_match_scan(*args)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stamps", action="store_true",
                    help="split a particle match into its parts with the stamp build")
    ap.add_argument("--times", action="store_true",
                    help="only the times of the wrappers every version of the port has")
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose port is probed")
    ap.add_argument("--only", default="", help="--times: only the wrappers whose name holds this")
    ap.add_argument("--sincos", action="store_true",
                    help="check that sincosf gives sinf's and cosf's bits on every input")
    ap.add_argument("--save", default="", help="--times: save the overlap shapes' outputs here")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="hold two --save files bit for bit, and exit 1 where any differs")
    args = ap.parse_args()
    if args.compare:
        compare_main(*args.compare)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from slam_constructor_tpu_torch.models import tiny, viny
    from slam_constructor_tpu_torch.models.engine import init_state
    from slam_constructor_tpu_torch.ops import _build, kernels, raycast, scoring

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"port: {ROOT}", flush=True)
    if args.sincos:
        sincos_main()
    if args.stamps:
        stamps_main(dev, args.only)
        return
    if args.times:
        times_main(dev, args.only, args.save)
        return
    res = _build.build()
    print(f"build: {res.seconds:.2f} s")
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _build.load()
    sass_mix(res.path)

    pose, scan, prep = scene(dev)
    beam = viny.viny_config().beam
    polar_args = (scan.ranges, scan.valid, scan.bearings, pose,
                  torch.tensor([-12.8, -12.8], device=dev), 256, 256, 0.1, beam.hole_width / 2.0,
                  beam.max_range)
    want = kernels.polar_free_plane_ref(*polar_args)
    got = kernels.polar_free_plane(*polar_args)
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
        print(f"mc_match [{name}] K={mc[name][5].shape[1]} rounds={mc[name][5].shape[0]} "
              f"R'={mc[name][1].shape[0]}: bitwise equal to mc_match_rounds "
              f"{same_bits(got, rounds)}; vs twin: max |trace diff| "
              f"{float((got[2] - twin[2]).abs().max()):.3e}, |pose diff| "
              f"{float((got[0] - twin[0]).abs().max()):.3e}; prob {float(got[1]):.6f}", flush=True)

    cand = pose + 0.05 * torch.randn((64, 3), device=dev)
    sargs = (prep.plane, cand, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    batched = {(m, k, s): submaps(prep, pose, dev, m, k, s)
               for m, k, s in ((32, 343, 120), (32, 7, 120), (4, 343, 120), (1, 343, 120),
                               (30, 16, 160), (30, 1, 160))}
    for (m, k, s), bargs in batched.items():
        got = kernels.overlap_score_batched(*bargs)
        want = kernels.overlap_score_ref(*bargs)
        singles = torch.stack([kernels.overlap_score(*(t[i] for t in bargs[:5]), *bargs[5:])
                               for i in range(m)])
        torch.cuda.synchronize()
        print(f"overlap_score_batched M={m} K={k} R'=180 {s}^2 vs twin: max |diff| "
              f"{float((got - want).abs().max()):.3e}, bitwise equal to {m} single-plane launches "
              f"{same_bits([got], [singles])}, scores {float(got.min()):.4f}.."
              f"{float(got.max()):.4f}", flush=True)

    # the RBPF's particle match: 30 windows, each its own origin, prior and
    # noise, the scan on every second beam; cut out and in place, and on
    # whole maps
    cases = {}
    for size in (160, 256):
        cut, in_place = particle_cases(prep, pose, dev, size)
        cases[size] = (cut, in_place)
        got = kernels.mc_match_batched(*cut)
        windows = kernels.mc_match_windows(*in_place)
        singles = [kernels.mc_match(*(t[m] for t in cut[:6]), *cut[6:]) for m in range(P)]
        twin = kernels.mc_match_ref(*cut)
        torch.cuda.synchronize()
        single = [torch.stack([s[i] for s in singles]) for i in range(3)]
        print(f"particle match P={P} K={K} rounds={ROUNDS} R'=180 {size}^2: mc_match_batched "
              f"bitwise equal to {P} single mc_match launches {same_bits(got, single)}, to "
              f"mc_match_windows (in place) {same_bits(got, windows)}; vs twin: max |trace diff| "
              f"{float((got[2] - twin[2]).abs().max()):.3e}, |pose diff| "
              f"{float((got[0] - twin[0]).abs().max()):.3e}", flush=True)

    m3 = m3rsm_cases(pose, scan, dev)
    for name, (fn, twin, a) in m3.items():
        got, want = fn(*a), twin(*a)
        torch.cuda.synchronize()
        if name.startswith("m3rsm_pyramid"):
            print(f"{name} vs twin: bitwise equal {same_bits(got, want)}", flush=True)
        elif name.startswith("m3rsm_search"):
            levels = kernels.m3rsm_search_levels(*a)
            print(f"{name}: bitwise equal to the level launches {same_bits(got, levels)}; vs twin: "
                  f"max |prob diff| {float((got[1] - want[1]).abs().max()):.3e}, max |pose diff| "
                  f"{float((got[0] - want[0]).abs().max()):.3e}", flush=True)
        else:
            print(f"{name} vs twin: max |diff| {float((got - want).abs().max()):.3e}", flush=True)

    cut, in_place = cases[160]
    for name, fn in (
        *((f"overlap_score_batched M={m} K={k} {s}^2", lambda a=a: kernels.overlap_score_batched(*a))
          for (m, k, s), a in batched.items()),
        ("mc_match_batched P=30 K=20 rounds=5 160^2", lambda: kernels.mc_match_batched(*cut)),
        ("mc_match_windows P=30 K=20 rounds=5 160^2", lambda: kernels.mc_match_windows(*in_place)),
        ("mc_match_windows whole 256^2 maps",
         lambda: kernels.mc_match_windows(*cases[256][1])),
        ("mc_match_batched whole 256^2 planes", lambda: kernels.mc_match_batched(*cases[256][0])),
        ("polar_free_plane 256^2 R=360", lambda: kernels.polar_free_plane(*polar_args)),
        ("overlap_score K=64 R=360", lambda: kernels.overlap_score(*sargs)),
        ("mc_match tiny", lambda: kernels.mc_match(*mc["tiny"])),
        ("mc_match viny", lambda: kernels.mc_match(*mc["viny"])),
        *keyed_match_calls(kernels, mc, dev),
        *((name, lambda f=f, a=a: f(*a)) for name, (f, _, a) in m3.items()),
        ("m3rsm_match viny_m3rsm (the whole call)", m3rsm_match_call(pose, scan, dev)),
    ):
        report(name, fn)
    for name, fn in (
        ("torch.empty((256, 256)) alone", lambda: torch.empty((256, 256), device=dev)),
        ("mc_match_rounds tiny", lambda: kernels.mc_match_rounds(*mc["tiny"])),
        ("mc_match_rounds viny", lambda: kernels.mc_match_rounds(*mc["viny"])),
        ("polar_free_plane_ref", lambda: kernels.polar_free_plane_ref(*polar_args)),
        ("30 single mc_match launches at the RBPF's shape",
         lambda: [kernels.mc_match(*(t[m] for t in cut[:6]), *cut[6:]) for m in range(P)]),
    ):
        print(f"chained [{name}]: {chained_ms(fn, 50) * 1e3:.2f} us a call (50 back to back)",
              flush=True)


if __name__ == "__main__":
    main()
