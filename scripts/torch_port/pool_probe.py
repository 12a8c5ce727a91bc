"""K3 over a block pool and its marking mode, timed on the card at the
paths' shapes and taken apart.

    python3 scripts/torch_port/pool_probe.py [--stamps]

Runs ``chip_smoke.py``'s copy-on-write RBPF (``cow_config``: 30 particles,
1,024 blocks of 32^2) over 128 scans of the bench sequence and mit_stata's
tiled engine over 128 scans of the CLI's sequence, keeps each path's last
``pool_insert`` call, and times ``kernels.pool_insert`` (50 calls replayed
from a CUDA graph, on a copy of the pool) on it as kept; with no tile
touched (every live slot folded with no observation: the blocks' fixed
cost); with one particle's tiles touched; and ``kernels.pool_touched`` on
the same scans. Each call is first held to ``pool_insert_ordered`` bit for
bit on the live slots. ``--stamps`` builds the kernels with
``-DSLAM_KERNEL_PROBE`` and prints, for the kept calls, the clock64 cycles
of each phase of the slowest slot's block (the first 1,024 slots) and the
means over the blocks that rasterised. Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the checkout's root

import chip_smoke as cs  # noqa: E402  (the same paths and configurations)

PHASES = ("set-up", "stage", "search", "scan", "free items", "occupied: evaluation",
          "occupied: counts", "occupied: list", "occupied: walk", "fold wait", "fold",
          "items (a count)", "samples kept (a count)", "free items (a count)")


def last_pool_call(run) -> tuple:
    """The arguments of the last ``pool_insert`` call of ``run()``."""
    from slam_constructor_tpu_torch.ops import kernels

    kernel, last = kernels.pool_insert, [None]

    def keeping(pool, *args, **kwargs):
        last[0] = cs.pool_call((pool, *args), kwargs)
        return kernel(pool, *args, **kwargs)

    with cs.handed_in(keeping, "pool_insert"):
        run()
    return last[0]


def kept_calls(dev) -> dict:
    from slam_constructor_tpu_torch import run as cli
    from slam_constructor_tpu_torch.utils import config as cfglib

    scans, odom, gt = cs.bench_sequence(dev)
    n = 128
    calls = {"gmapping cow": last_pool_call(
        lambda: cs.run_gmapping_path(cs.cow_config(), scans[:n], odom[:n], gt, 0))}
    args = cli.parse_args(cs.cli_argv("mit_stata", "build/pool_probe_out"))
    tscans, todom, tgt = cli.load_data(args, dev)
    tcfg = cfglib.engine_config_from(cfglib.load_properties(args.config))
    calls["mit_stata"] = last_pool_call(lambda: cs.run_main_path(tcfg, tscans, todom, tgt, 0))
    variants = {}
    for name, (a, live) in calls.items():
        variants[name] = (a, live)
        none = torch.zeros_like(a[8])
        variants[f"{name}, no tile touched"] = ((*a[:8], none, a[9]), live)
        if a[8].shape[0] > 1:
            one = a[8].clone()
            one[1:] = False
            variants[f"{name}, one particle's tiles"] = ((*a[:8], one, a[9]), live)
    return variants


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from slam_constructor_tpu_torch.ops import _build, kernels

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    res = _build.build(("-DSLAM_KERNEL_PROBE",) if args.stamps else ())
    print(f"build: {res.seconds:.2f} s", flush=True)
    lib = ctypes.CDLL(str(res.path))
    _build.load = lambda: lib  # every wrapper launches the kernels of this build
    ours = False
    for line in res.log.splitlines():  # ptxas' report of the pool kernels
        if "Compiling entry" in line:
            ours = "pool_kernel" in line or "touch_kernel" in line
        if ours:
            print(f"  ptxas: {line.strip()}", flush=True)
    for name, (a, live) in kept_calls(dev).items():
        pool, tables, origin, scale, model, poses, scans, cfg, touched, q = a
        got, want = pool.clone(), pool.clone()
        kernels.pool_insert(got, *a[1:], **live)
        kernels.pool_insert_ordered(want, *a[1:], **live)
        alive = cs.live_slots(pool, live)
        same = torch.equal(cs.bits(got[alive]), cs.bits(want[alive]))
        work = pool.clone()
        device = cs.graph_ms(lambda: kernels.pool_insert(work, *a[1:], **live))
        touch = cs.graph_ms(lambda: kernels.pool_touched(tuple(tables.shape[1:]), pool.shape[1],
                                                         origin, scale, poses, scans, cfg, q))
        print(f"pool_insert [{name}]: {int(alive.sum())} live slots, {int(touched.sum())} touched "
              f"tiles; equal to the ordered sums on the live slots {same}; device "
              f"{device * 1e3:.2f} us (a graph of 50); pool_touched {touch * 1e3:.2f} us; {smi}",
              flush=True)
        if args.stamps and "," not in name:
            slots = 16
            buf = (ctypes.c_ulonglong * (1024 * slots))()
            lib.scan_insert_probe_stamps(ctypes.byref(buf))
            kernels.pool_insert(pool.clone(), *a[1:], **live)
            torch.cuda.synchronize()
            err = lib.scan_insert_probe_stamps(ctypes.byref(buf))
            if err:
                raise RuntimeError(f"scan_insert_probe_stamps: cudaError_t {err}")
            cyc = torch.tensor(list(buf), dtype=torch.float64).reshape(1024, slots)
            used = cyc[cyc[:, :11].sum(1) > 0]
            total = used[:, :11].sum(1)
            worst = int(total.argmax())
            print(f"stamps [{name}]: {used.shape[0]} rasterising blocks; cycles max "
                  f"{int(total.max())} mean {float(total.mean()):.0f}; the slowest block's phases "
                  + ", ".join(f"{p} {int(used[worst, i])}" for i, p in enumerate(PHASES))
                  + "; the mean block's " + ", ".join(
                      f"{p} {float(used[:, i].mean()):.0f}" for i, p in enumerate(PHASES)),
                  flush=True)


if __name__ == "__main__":
    main()
