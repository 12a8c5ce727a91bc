"""The M3RSM paths of one checkout of the port, saved so that another
checkout's runs can be held to them bit for bit.

    python3 scripts/torch_port/m3rsm_trajectories.py --root DIR --out A.npz
    python3 scripts/torch_port/m3rsm_trajectories.py --compare A.npz B.npz

The first form imports the port and ``chip_smoke.py`` from the checkout
``DIR`` (this one by default; another, e.g. a parent unpacked with ``git
archive`` under ``build/``, builds its own kernels there), runs that
``chip_smoke.py``'s viny_m3rsm path (``viny_m3rsm_config(map_size=256)``,
512 scans of the bench sequence) and its loop-closing pipeline with the
M3RSM loop matcher (``full_m3rsm_config``, 512 scans over two laps), and
saves the trajectories, the match scores, the loop count, the final maps
and the live pyramid. The second form prints, array by array, whether two
such files are equal bit for bit, and the largest difference where they
are not; it exits 1 where any differs. The first form needs one card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def run(root: Path, out: Path) -> None:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from slam_constructor_tpu_torch.models import viny
    from slam_constructor_tpu_torch.utils import evaluate

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    scans, odom, gt = cs.bench_sequence(dev)
    cfg = viny.viny_m3rsm_config(map_size=cs.MAP)
    traj, probs, secs, e = cs.run_main_path(cfg, scans, odom, gt, 0)
    saved = {"viny_m3rsm_traj": traj, "viny_m3rsm_probs": probs,
             "viny_m3rsm_cells": e.state.gm.cells}
    saved.update({f"viny_m3rsm_pyramid_{i}": p for i, p in enumerate(e.state.pyramid)})
    print(f"{root}: viny_m3rsm {len(scans)} scans in {secs:.3f} s, ATE "
          f"{float(evaluate.ate(traj, gt, align=False)):.6f} m", flush=True)
    fscans, fodom, fgt = cs.full_sequence(dev)
    fe, ftraj, fsecs, _ = cs.run_full_path(cs.full_m3rsm_config(), fscans, fodom, fgt, 0)
    saved.update({"full_m3rsm_traj": ftraj,
                  "full_m3rsm_tracked": torch.from_numpy(np.stack(fe.trajectory)),
                  "full_m3rsm_loops": torch.tensor(fe.total_loops),
                  "full_m3rsm_cells": fe.state.gm.cells})
    saved.update({f"full_m3rsm_graph_{i}": t for i, t in enumerate(cs.graph_bits(fe))})
    print(f"{root}: full_m3rsm {len(fscans)} scans in {fsecs:.3f} s, {fe.total_loops} loops, "
          f"corrected ATE {float(evaluate.ate(ftraj, fgt, align=False)):.6f} m", flush=True)
    np.savez(out, **{k: v.detach().cpu().numpy() for k, v in saved.items()})


def compare(a: Path, b: Path) -> bool:
    x, y = np.load(a), np.load(b)
    same_all = sorted(x.files) == sorted(y.files)
    for k in sorted(set(x.files) & set(y.files)):
        u, v = x[k], y[k]
        same = u.shape == v.shape and u.dtype == v.dtype and u.tobytes() == v.tobytes()
        diff = ""
        if not same and u.shape == v.shape and u.dtype.kind in "fiu":
            d = np.abs(u.astype(np.float64) - v.astype(np.float64))
            diff = f", max |diff| {float(np.nanmax(d)):.3e} in {int((d != 0).sum())} of {d.size}"
        print(f"{k} {u.shape} {u.dtype}: equal bit for bit {same}{diff}", flush=True)
        same_all &= same
    print(f"{a.name} and {b.name}: {'equal' if same_all else 'DIFFERENT'} bit for bit", flush=True)
    return same_all


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose port runs")
    ap.add_argument("--out", help="the .npz to write")
    ap.add_argument("--compare", nargs=2, metavar="NPZ", help="two files to hold bit for bit")
    args = ap.parse_args()
    if args.compare:
        sys.exit(0 if compare(*map(Path, args.compare)) else 1)
    run(Path(args.root).resolve(), Path(args.out))


if __name__ == "__main__":
    main()
