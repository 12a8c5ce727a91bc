"""K3 (``kernels.scan_insert``, ``kernels.scan_planes``) on a card at the
shapes of the bench paths and the loop closer, against its yardsticks, and
timed at each band height.

    python3 scripts/torch_port/k3_probe.py [--rows 0 1 2 4 8] [--quick] [--variants]

Each shape is a map made from the bench sequence (the first 8 scans
inserted by the plain twin at their true poses) and the call of the 9th
scan: tiny, viny (TBM, the polar fill), viny_m3rsm (TBM, DDA), gmapping (30
maps of 256^2, 160^2 windows), the gmapping preset (30 whole 256^2 maps),
mit_csail (1024^2 at 0.05 m) and tum_2d (30 maps of 1024^2, 384^2 windows)
for ``scan_insert``; for ``scan_planes`` the full path's submaps (32 of
120^2, 3 scans each), a regeneration group (32 keyframes into one 256^2
plane) and a joint-refine round (32 planes of 256^2, a scan each). For each
shape and each band height (``--rows``; 0: the kernel's own choice, printed)
the kernel is held to ``scan_insert_ordered`` / ``scan_planes_ordered`` bit
for bit, then timed: 50 calls replayed from a CUDA graph (the device's time
a call) and 200 calls chained. ``--quick`` takes tiny and the regeneration
group only; ``--variants`` adds tiny's call without a valid beam, without
the blur and with the polar fill. ``--stamps`` builds the kernels with
``-DSLAM_KERNEL_PROBE`` and prints, for every shape (with ``--quick``:
tiny's calls, its variants, and the regeneration group) at each band
height, each band block's clock64 cycles by phase (set-up, staging the
beams, the free trace's searches and the cull, the block prefix, the free
items, the occupied samples by part, the wait for the staged cells, the
fold) and the occupied items and samples kept.
Prints the card's name and power limit first. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def graph_ms(fn, n: int = 50, replays: int = 5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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
    return sorted(times)[len(times) // 2]


def chained_ms(fn, n: int = 200) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def insert_shapes(dev, quick: bool, variants: bool = False):
    """name -> the arguments of one ``scan_insert`` call; with ``variants``
    tiny's call also without a valid beam, without the blur and with the
    polar fill (its K2 launch included), to split its time."""
    from chip_smoke import bench_sequence
    from slam_constructor_tpu_torch.models import gmapping, tiny, viny
    from slam_constructor_tpu_torch.models.engine import init_state
    from slam_constructor_tpu_torch.ops import kernels
    from slam_constructor_tpu_torch.ops.scan import LaserScan
    from slam_constructor_tpu_torch.utils import config as cfglib

    scans, _, gt = bench_sequence(dev)
    one = {"tiny": tiny.tiny_config(map_size=256)}
    if not quick:
        one.update(viny=viny.viny_config(map_size=256),
                   viny_m3rsm=viny.viny_m3rsm_config(map_size=256),
                   mit_csail=cfglib.engine_config_from(cfglib.load_properties(
                       str(ROOT / "configs" / "mit_csail.properties"))))
    out = {}
    for name, cfg in one.items():
        gm = init_state(cfg, dev).gm
        for i in range(8):
            gm = type(gm)(cells=kernels.scan_insert_ref(gm, cfg.cell_model, gt[i], scans[i],
                                                        cfg.beam), origin=gm.origin,
                          scale=gm.scale)
        out[name] = (gm, cfg.cell_model, gt[8], scans[8], cfg.beam, torch.ones((), device=dev), 0)
    if variants:
        gm, model, pose, scan, beam, q, _ = out["tiny"]
        out["tiny, no valid beam"] = (gm, model, pose, LaserScan(
            scan.ranges, scan.bearings, torch.zeros_like(scan.valid)), beam, q, 0)
        out["tiny, no blur"] = (gm, model, pose, scan, dataclasses.replace(beam, wall_blur=False),
                                q, 0)
        out["tiny, the polar fill"] = (gm, model, pose, scan,
                                       dataclasses.replace(beam, free_impl="polar"), q, 0)
    if quick:
        return out
    many = {"gmapping": gmapping.fast_config(n_particles=30, map_size=256),
            "gmapping preset": gmapping.GMappingConfig(),
            "tum_2d": cfglib.gmapping_config_from(cfglib.load_properties(
                str(ROOT / "configs" / "tum_2d.properties")))}
    g = torch.Generator(device=dev).manual_seed(0)
    for name, cfg in many.items():
        gm = gmapping.init_state(cfg, dev).gm
        n_p = gm.cells.shape[0]
        for i in range(9):
            poses = gt[i] + 0.02 * torch.randn((n_p, 3), generator=g, device=dev)
            scan = LaserScan(*(t[i].expand(n_p, -1) for t in (
                scans.ranges, scans.bearings, scans.valid)))
            args = (gm, cfg.cell_model, poses, scan, cfg.beam, None, cfg.insert_window)
            if i < 8:
                gm = type(gm)(cells=kernels.scan_insert_ref(*args), origin=gm.origin,
                              scale=gm.scale)
        out[name] = args
    return out


def planes_shapes(dev, quick: bool):
    """name -> the arguments of one ``scan_planes`` call."""
    from chip_smoke import bench_sequence
    from slam_constructor_tpu_torch.ops import raycast

    scans, _, gt = bench_sequence(dev)
    idx = torch.arange(32, device=dev) * 15  # keyframes ~0.56 m apart
    kf, kscans = gt[idx], scans[idx]
    beam = raycast.BeamConfig(wall_blur=True)
    origin = torch.tensor([-12.8, -12.8], device=dev)
    out = {"regeneration, 32 scans into one 256^2 plane": (
        origin, 256, 256, 0.1, kf, kscans, beam, torch.zeros(32, dtype=torch.int64, device=dev),
        1)}
    if quick:
        return out
    span = torch.arange(3, device=dev)
    nb = (torch.arange(32, device=dev)[:, None] + span - 1).clamp(0, 31).reshape(-1)
    sub_origin = kf[:, :2] - 120 * 0.1 / 2.0
    out["submaps, 32 of 120^2, 3 scans each"] = (
        sub_origin.repeat_interleave(3, 0), 120, 120, 0.1, kf[nb], kscans[nb], beam,
        torch.arange(32, device=dev).repeat_interleave(3), 32)
    out["joint refine, 32 planes of 256^2"] = (origin, 256, 256, 0.1, kf, kscans, beam, None,
                                               None)
    return out


PHASES = ("set-up", "stage", "search", "scan", "free items", "occupied: evaluation",
          "occupied: counts", "occupied: list", "occupied: walk", "fold wait",
          "fold", "items (a count)", "samples kept (a count)", "free items (a count)")


def stamps(lib, inserts, planes, rows_list) -> None:
    """The stamp build: each band block's cycles by phase (summed over its
    scans), their largest and mean over the blocks, for one call at each
    band height."""
    from slam_constructor_tpu_torch.ops import kernels

    blocks, slots = 1024, 16
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(f"stamps: cycles a phase of a band block (SM clock at most {clock})", flush=True)
    calls = [(n, kernels.scan_insert, a) for n, a in inserts.items()]
    calls += [(n, kernels.scan_planes, a) for n, a in planes.items()]
    for (name, call, a), rows in ((c, r) for c in calls for r in rows_list):
        kernels._BAND_ROWS = rows
        name = f"{name}, rows {rows or 'chosen'}"
        buf = (ctypes.c_ulonglong * (blocks * slots))()
        for _ in range(3):
            call(*a)
        torch.cuda.synchronize()
        lib.scan_insert_probe_stamps(ctypes.byref(buf))
        call(*a)
        torch.cuda.synchronize()
        err = lib.scan_insert_probe_stamps(ctypes.byref(buf))
        if err:
            raise RuntimeError(f"scan_insert_probe_stamps: cudaError_t {err}")
        cyc = torch.tensor(list(buf), dtype=torch.float64).reshape(blocks, slots)
        used = cyc[cyc.sum(1) > 0]
        total = used.sum(1)
        worst = int(total.argmax())
        print(f"stamps [{name}]: {used.shape[0]} blocks; total cycles max {int(total.max())} "
              f"mean {float(total.mean()):.0f}; the slowest block's phases "
              + ", ".join(f"{p} {int(used[worst, i])}" for i, p in enumerate(PHASES))
              + "; phase max / mean over blocks "
              + ", ".join(f"{p} {int(used[:, i].max())}/{float(used[:, i].mean()):.0f}"
                          for i, p in enumerate(PHASES)), flush=True)
    kernels._BAND_ROWS = 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--flags", nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from slam_constructor_tpu_torch.ops import _build, kernels

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    res = _build.build((("-DSLAM_KERNEL_PROBE",) if args.stamps else ()) + tuple(args.flags))
    print(f"build: {res.seconds:.2f} s; by source {res.source_seconds}", flush=True)
    if args.stamps or args.flags:  # every wrapper launches the kernels of this build
        lib = ctypes.CDLL(str(res.path))
        _build.load = lambda: lib
    ours = False
    for line in res.log.splitlines():  # ptxas' report of insert_kernel's instantiations
        if "Compiling entry" in line:
            ours = "insert_kernel" in line
        if ours:
            print(f"  ptxas: {line.strip()}", flush=True)
    _build.load()

    def bits(t):
        return t.contiguous().view(torch.int32)

    if args.stamps:
        stamps(lib, insert_shapes(dev, args.quick, args.quick), planes_shapes(dev, args.quick),
               args.rows)
        return
    for kind, shapes, call, want_fn in (
            ("scan_insert", insert_shapes(dev, args.quick, args.variants), kernels.scan_insert,
             kernels.scan_insert_ordered),
            ("scan_planes", planes_shapes(dev, args.quick), kernels.scan_planes,
             kernels.scan_planes_ordered)):
        for name, a in shapes.items():
            want = want_fn(*a)
            for rows in args.rows:
                kernels._BAND_ROWS = rows
                got = call(*a)
                torch.cuda.synchronize()
                same = (all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))
                        if kind == "scan_planes" else torch.equal(bits(got), bits(want)))
                device = graph_ms(lambda: call(*a))
                chained = chained_ms(lambda: call(*a))
                if kind == "scan_insert":
                    gm = a[0]
                    p = 1 if gm.cells.dim() == 3 else gm.cells.shape[0]
                    h = gm.height
                    sh = min(a[6], h) if a[6] else h
                    c = gm.cells.shape[-1]
                    used = kernels.band_rows(p, sh, sh, c)
                else:
                    p, sh, c = (a[8] or a[4].shape[0]), a[1], 0
                    used = kernels.band_rows(p, sh, a[2], c)
                print(f"{kind} [{name}] rows {used}{' (chosen)' if rows == 0 else ''}: equal to "
                      f"the ordered sums {same}; device {device * 1e3:.2f} us (graph of 50), "
                      f"chained {chained * 1e3:.2f} us", flush=True)
            kernels._BAND_ROWS = 0


if __name__ == "__main__":
    main()
