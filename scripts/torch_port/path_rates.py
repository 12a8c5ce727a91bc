"""scans/s of the bench paths of one checkout of the port, on the card.

    python3 scripts/torch_port/path_rates.py [--root DIR] [--out F.json]

Imports ``slam_constructor_tpu_torch`` from ``--root`` (this checkout by
default; a parent unpacked with ``git archive`` under ``build/`` to compare
two trees) and runs, over ``chip_smoke.py``'s bench sequence (512 scans,
360 beams, the cecum world): tiny, viny and viny_m3rsm through
``Engine.run``, bench.py's gmapping preset and ``preset('gmapping')``
through ``GMappingEngine.run``; each once to warm up, then timed from a
fresh state (host clock ending in a synchronise) with the sync check on.
Prints one line a path and, with ``--out``, writes them as JSON. Run it in
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

    paths = {
        "tiny": lambda: single(tiny.tiny_config(map_size=256)),
        "viny": lambda: single(viny.viny_config(map_size=256)),
        "viny_m3rsm": lambda: single(viny.viny_m3rsm_config(map_size=256)),
        "gmapping": lambda: particles(lambda: gmapping.GMappingEngine(
            gmapping.fast_config(n_particles=30, map_size=256), seed=0)),
        "gmapping preset": lambda: particles(lambda: cfglib.preset("gmapping")(seed=0)),
    }
    out = {"root": str(Path(args.root).resolve()), "card": smi}
    for name, make in paths.items():
        make().run(scans, odom)  # warm-up
        e = make()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        e.run(scans, odom)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[name] = 512 / secs
        print(f"{name}: 512 scans in {secs:.3f} s = {512 / secs:.1f} scans/s on {smi} "
              f"({args.root})", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out))


if __name__ == "__main__":
    main()
