"""Where a gradient refine on the card parts from its plain twin: the calls
that ``chip_smoke.py``'s slot phase keeps from an RBPF slot path, saved with
the kernel's and the twin's outputs for a look on a CPU.

    python3 scripts/torch_port/refine_parts.py [--slot gradient] [--out DIR]

Runs ``chip_smoke.phase_gmapping_slots`` (every slot at bench.py's gmapping
width, 512 scans, keeping every 64th refine launch), then for each kept
``gradient_refine`` call of the slot's run: the kernel, its yardstick and
the twin, each on the arguments as kept and with the beams near a kink at
weight 0 (``chip_smoke.clear_of_refine_kinks``); writes ``DIR/<slot>_<i>.pt``
(the parting maps' arguments, outputs and the twin's decision margins)
where a map's trace parts from the twin's, and prints where each does. Needs the card; imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slot", default="gradient", help="the slot run's name in the slot phase")
    ap.add_argument("--out", default=str(ROOT / "build" / "refine_parts"))
    args = ap.parse_args()
    from slam_constructor_tpu_torch.ops import _build, kernels
    from slam_constructor_tpu_torch.utils import evaluate

    _build.load()
    dev = torch.device("cuda")
    scans, odom, gt = cs.bench_sequence(dev)
    odo_ate = float(evaluate.ate(cs.odometry_trajectory(gt[0], odom), gt, align=False))
    _, kept, _ = cs.phase_gmapping_slots(scans, odom, gt, odo_ate, "probe")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    yardstick, _, loop, twin_score, score = cs.refine_twin("gradient_refine")
    for label, calls in kept["gradient_refine"].items():
        if args.slot not in label:
            continue
        for i, a in enumerate(calls):
            masked = cs.clear_of_refine_kinks(a, loop, score)
            got, want = kernels.gradient_refine(*masked), yardstick(*masked)
            twin, margins = cs.twin_record(masked, loop, twin_score)
            torch.cuda.synchronize()
            diff = (got[2] - twin[2]).abs()
            first = [int(r[0]) if r.numel() else None for r in
                     ((d > cs.TOL).nonzero().flatten() for d in diff)]
            print(f"{label} call {i}: maps parting from the twin at rounds {first}; "
                  f"masked beams {int((a[2] != masked[2]).sum())}", flush=True)
            parted = [m for m, r in enumerate(first) if r is not None]
            if not parted:
                continue
            sel = torch.tensor(parted, device=dev)

            def pick(t):  # the parting maps only (a call holds 30 windows)
                return t.index_select(0, sel).cpu() if torch.is_tensor(t) and t.dim() else t

            torch.save({"maps": parted, "args": [pick(t) for t in a],
                        "masked_w": pick(masked[2]), "kernel": [pick(t) for t in got],
                        "yardstick": [pick(t) for t in want], "twin": [pick(t) for t in twin],
                        "margins": pick(margins)}, out / f"{label.replace(' ', '_')}_{i}.pt")


if __name__ == "__main__":
    main()
