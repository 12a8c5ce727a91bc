"""scans/s of the bench paths of one checkout of the port, on the card.

    python3 scripts/torch_port/path_rates.py [--root DIR] [--out F.json]
        [--paths tiny,viny,...] [--repeat N] [--host N]

Imports ``slam_constructor_tpu_torch`` from ``--root`` (this checkout by
default; a parent unpacked with ``git archive`` under ``build/`` to compare
two trees) and runs, over ``chip_smoke.py``'s bench sequence (512 scans,
360 beams, the cecum world): tiny, viny and viny_m3rsm through
``Engine.run``, bench.py's gmapping preset and ``preset('gmapping')``
through ``GMappingEngine.run``; each once to warm up, then timed from a
fresh state (host clock ending in a synchronise) with the sync check on,
``--repeat`` times (the median is the path's figure, every run is kept).
``--host N`` then times N single steps of each single-hypothesis path
(``Engine.handle_scan``, a synchronise before and after each): the host's
time to issue a step and the step's time to its end, and the step's draws
issued alone (``engine.draw_step`` where the tree has it, nothing where
the match draws inside its launch (``engine.keyed_match``), else the
``torch.randn`` of the generator that the step drew from).
Prints one line a run and, with ``--out``, writes them as JSON. Run it in
turns (parent, change, change, parent) in one chip call: the host's speed
drifts between calls. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out")
    ap.add_argument("--paths", help="comma-separated paths (default: all)")
    ap.add_argument("--repeat", type=int, default=1, help="timed runs a path")
    ap.add_argument("--host", type=int, default=0, help="single steps timed a path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from slam_constructor_tpu_torch.models import engine, gmapping, tiny, viny
    from slam_constructor_tpu_torch.utils import config as cfglib
    from slam_constructor_tpu_torch.utils import datagen

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    occ, origin, scale = datagen.cecum_world(device=dev)
    poses = datagen.rectangle_trajectory(step=9.6 / 512 * 2, device=dev)
    poses = poses.repeat((512 + poses.shape[0] - 1) // poses.shape[0], 1)[:512]
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(360, device=dev),
        rng=np.random.default_rng(0), odom_noise_xy=0.01, odom_noise_theta=0.005)

    def single(cfg):
        e = engine.Engine(cfg, seed=0)
        e.state.pose = gt[0].clone()
        return e

    def particles(make):
        e = make()
        e.state.poses = gt[0].expand(e.cfg.n_particles, 3).clone()
        return e

    single_paths = ("tiny", "viny", "viny_m3rsm")
    paths = {
        "tiny": lambda: single(tiny.tiny_config(map_size=256)),
        "viny": lambda: single(viny.viny_config(map_size=256)),
        "viny_m3rsm": lambda: single(viny.viny_m3rsm_config(map_size=256)),
        "gmapping": lambda: particles(lambda: gmapping.GMappingEngine(
            gmapping.fast_config(n_particles=30, map_size=256), seed=0)),
        "gmapping preset": lambda: particles(lambda: cfglib.preset("gmapping")(seed=0)),
    }
    if args.paths:
        unknown = set(args.paths.split(",")) - set(paths)
        if unknown:
            sys.exit(f"unknown paths {sorted(unknown)}; known: {sorted(paths)}")
        paths = {k: v for k, v in paths.items() if k in args.paths.split(",")}
    out = {"root": str(Path(args.root).resolve()), "card": smi, "runs": {}}
    for name, make in paths.items():
        make().run(scans, odom)  # warm-up
        rates = []
        for _ in range(args.repeat):
            e = make()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            e.run(scans, odom)
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rates.append(512 / secs)
            print(f"{name}: 512 scans in {secs:.3f} s = {512 / secs:.1f} scans/s on {smi} "
                  f"({args.root})", flush=True)
        out[name] = float(np.median(rates))
        out["runs"][name] = rates
        if args.host and name in single_paths:
            out.setdefault("host_us", {})[name] = host_times(engine, make(), scans, odom,
                                                             args.host)
            print(f"{name}: {args.host} single steps, median us (host to issue, to the end; "
                  f"the draws issued alone): {out['host_us'][name]} on {smi}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out))


def host_times(engine, e, scans, odom, n: int) -> dict:
    """Median microseconds of ``n`` single steps of engine ``e`` (a
    synchronise before and after each): the host's time to issue the step,
    the step's time to its end, and the host's time to issue its draws
    alone."""
    issue, whole, draws = [], [], []
    cfg = e.cfg
    mc = cfg.matcher_cfg
    gen = torch.Generator(device=e.device).manual_seed(1)
    for i in range(n):
        j = i % scans.ranges.shape[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.handle_scan(scans[j], odom[j])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if getattr(engine, "keyed_match", lambda c: False)(cfg):
            pass  # the match draws inside its own launch: nothing issued apart
        elif hasattr(engine, "draw_step"):
            engine.draw_step(cfg, e.state.key)
        elif cfg.matcher == "monte_carlo":
            torch.randn((mc.rounds, mc.batch, 3), generator=gen, device=e.device)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append(t1 - t0)
        whole.append(t2 - t0)
        draws.append(t3 - t2)
    return {k: float(np.median(v)) * 1e6 for k, v in
            (("issue", issue), ("step", whole), ("draws", draws))}


if __name__ == "__main__":
    main()
