"""The same scans on the card and on the CPU: how far the poses part.

    python3 scripts/torch_port/card_vs_cpu.py [--root DIR] [--paths tiny,viny] [--scans 8]

Imports ``slam_constructor_tpu_torch`` from ``--root`` (this checkout by
default; a parent unpacked with ``git archive`` under ``build/`` to compare
two trees) and runs the first ``--scans`` scans of ``chip_smoke.py``'s bench
sequence through ``Engine.run`` on the card and on the CPU, from the
reference's ``PRNGKey(0)`` (each device draws its own numbers) and with
seeded standard normals handed in. Prints, per path and route, the largest
|pose difference| (heading wrapped) and the scan where it first exceeds
1e-6. Needs the card; imports no JAX.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--paths", default="tiny,viny")
    ap.add_argument("--scans", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke
    from slam_constructor_tpu_torch.models import engine, tiny, viny

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    scans, odom, gt = chip_smoke.bench_sequence(dev)
    n = args.scans
    configs = {"tiny": tiny.tiny_config(map_size=chip_smoke.MAP),
               "viny": viny.viny_config(map_size=chip_smoke.MAP)}
    for name in args.paths.split(","):
        cfg = configs[name]
        mc = cfg.matcher_cfg
        normals = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (n, mc.rounds, mc.batch, 3)).astype(np.float32))
        for route, noise in (("from PRNGKey(0)", None), ("normals handed in", normals)):
            trajs = []
            for d in (dev, torch.device("cpu")):
                e = engine.Engine(cfg, device=d, seed=0)
                e.state.pose = gt[0].to(d).clone()
                traj, _ = e.run(scans[:n].to(d), odom[:n].to(d),
                                noise=None if noise is None else noise.to(d))
                trajs.append(traj.cpu().double())
            diff = trajs[0] - trajs[1]
            diff[:, 2] = torch.remainder(diff[:, 2] + math.pi, 2 * math.pi) - math.pi
            by_scan = diff.abs().amax(-1)
            part = (by_scan > 1e-6).nonzero()
            print(f"{name}, {route}, {n} scans: card vs CPU max|pose diff| "
                  f"{float(by_scan.max()):.3e} m/rad; by scan "
                  f"{[float(f'{v:.3e}') for v in by_scan.tolist()]}; first above 1e-6: "
                  f"{int(part[0]) if len(part) else None} ({args.root}; {smi})", flush=True)


if __name__ == "__main__":
    main()
