"""Every dense-map path of one checkout of the port, saved so that another
checkout's runs can be held to them bit for bit.

    python3 scripts/torch_port/path_trajectories.py --root DIR --out A.npz
    python3 scripts/torch_port/path_trajectories.py --compare A.npz B.npz

The first form imports the port and ``chip_smoke.py`` from the checkout
``DIR`` (this one by default; another, e.g. a parent unpacked with ``git
archive`` under ``build/``, builds its own kernels there) and runs that
``chip_smoke.py``'s paths from a fresh state with the engines' own
generators (seed 0): tiny, viny and viny_m3rsm over the bench sequence
(512 scans), the loop-closing pipeline and full_m3rsm over theirs (512
scans, two laps), bench.py's gmapping preset and ``preset('gmapping')``
(512 scans), and the CLI on every dense-map config (``run.execute``: 128
scans, 64 for the RBPFs). It saves each trajectory (the RBPFs' winners
too) and final map. The second form prints, array by array, whether two
such files are equal bit for bit, and the largest difference where they
are not; it exits 1 where any differs. The first form needs one card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

#: the CLI configs on a dense map (mit_stata is the tiled one)
CLI_DENSE = ("tiny", "viny", "tiny_refined", "mit_csail", "viny_m3rsm", "gmapping", "tum_2d")


def run(root: Path, out: Path) -> None:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from slam_constructor_tpu_torch import run as cli
    from slam_constructor_tpu_torch.models import tiny, viny

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    scans, odom, gt = cs.bench_sequence(dev)
    saved = {}
    for name, cfg in (("tiny", tiny.tiny_config(map_size=cs.MAP)),
                      ("viny", viny.viny_config(map_size=cs.MAP)),
                      ("viny_m3rsm", viny.viny_m3rsm_config(map_size=cs.MAP))):
        traj, probs, _, e = cs.run_main_path(cfg, scans, odom, gt, 0)
        saved.update({f"{name}_traj": traj, f"{name}_probs": probs, f"{name}_cells": e.state.gm.cells})
    fscans, fodom, fgt = cs.full_sequence(dev)
    for name, cfg in (("full", cs.full_config()), ("full_m3rsm", cs.full_m3rsm_config())):
        fe, ftraj, _, _ = cs.run_full_path(cfg, fscans, fodom, fgt, 0)
        saved.update({f"{name}_traj": ftraj, f"{name}_cells": fe.state.gm.cells,
                      f"{name}_tracked": torch.from_numpy(np.stack(fe.trajectory))})
    for name, cfg, make in (("gmapping", cs.gmapping_config(), None),
                            ("gmapping_preset", None, cs.baseline_engine)):
        e, traj, _, _ = cs.run_gmapping_path(cfg, scans, odom, gt, 0, make=make)
        saved.update({f"{name}_traj": traj, f"{name}_winner": e.winner_trajectory(),
                      f"{name}_cells": e.state.gm.cells, f"{name}_logw": e.state.log_weights})
    for name in CLI_DENSE:
        res = cli.execute(cli.parse_args(cs.cli_argv(name, str(root / "build" / "traj_cli" / name))))
        saved[f"cli_{name}_traj"] = res.trajectory
    for k, v in saved.items():
        if k.endswith("_traj"):
            print(f"{root}: {k} {tuple(v.shape)}", flush=True)
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
