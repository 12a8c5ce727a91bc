"""K3 over a block pool and its marking mode, timed on the card at the
paths' shapes and taken apart.

    python3 scripts/torch_port/pool_probe.py [--stamps] [--bands 1 2 4 8]

Runs ``chip_smoke.py``'s copy-on-write RBPF (``cow_config``: 30 particles,
1,024 blocks of 32^2) over 128 scans of the bench sequence and mit_stata's
tiled engine over 128 scans of the CLI's sequence, keeps each path's last
``pool_insert`` call, and times ``kernels.pool_insert`` from its work list
(``kernels.pool_work``; 50 calls replayed from a CUDA graph, on a copy of
the pool) on it as kept; with no tile touched (every live slot folded with
no observation: the blocks' fixed cost); with one particle's tiles
touched; and ``kernels.pool_touched`` on the same scans. Each call is
first held to ``pool_insert_ordered`` bit for bit on the live slots.
``--bands`` times the kept calls with the tile around each robot in each
of these numbers of row bands (``kernels.POOL_ROBOT_BANDS``). ``--stamps``
builds the kernels with ``-DSLAM_KERNEL_PROBE`` and prints, for the kept
calls, the clock64 cycles of each phase of the slowest block of the grid
(a block's phases summed over the items it took) and the means over the
blocks that rasterised. Needs one card.
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

PREP_PHASES = ("marks", "the slowest thread's marks", "first barrier", "OR", "compaction",
               "second barrier", "list or copies", "whole", "list: owners", "list: bands",
               "list: tiles", "list: folds")
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


def last_calls(run) -> tuple:
    """The arguments of the last ``pool_insert`` and ``pool_prepare`` calls
    of ``run()`` (the prepare's state before it)."""
    from slam_constructor_tpu_torch.ops import kernels

    prepare, last = kernels.pool_prepare, [None]

    def keeping(*args, **kwargs):
        last[0] = cs.prepare_call(args, kwargs)
        return prepare(*args, **kwargs)

    with cs.handed_in(keeping, "pool_prepare"):
        insert = last_pool_call(run)
    return insert, last[0]


def kept_calls(dev) -> tuple:
    from slam_constructor_tpu_torch import run as cli
    from slam_constructor_tpu_torch.utils import config as cfglib

    scans, odom, gt = cs.bench_sequence(dev)
    n = 128
    calls, prepares = {}, {}
    calls["gmapping cow"], prepares["gmapping cow"] = last_calls(
        lambda: cs.run_gmapping_path(cs.cow_config(), scans[:n], odom[:n], gt, 0))
    args = cli.parse_args(cs.cli_argv("mit_stata", "build/pool_probe_out"))
    tscans, todom, tgt = cli.load_data(args, dev)
    tcfg = cfglib.engine_config_from(cfglib.load_properties(args.config))
    calls["mit_stata"], prepares["mit_stata"] = last_calls(
        lambda: cs.run_main_path(tcfg, tscans, todom, tgt, 0))
    variants = {}
    for name, (a, live) in calls.items():
        variants[name] = (a, live)
        none = torch.zeros_like(a[8])
        variants[f"{name}, no tile touched"] = ((*a[:8], none, a[9]), live)
        if a[8].shape[0] > 1:
            one = a[8].clone()
            one[1:] = False
            variants[f"{name}, one particle's tiles"] = ((*a[:8], one, a[9]), live)
    return variants, prepares


KINDS = {14: "tile", 15: "fold"}


def item_report(name, items) -> None:
    """The insert's items by kind (cycles, free and occupied items) and the
    slowest ones, from the probe build's stamps."""
    it = torch.tensor(list(items), dtype=torch.int64).reshape(-1, 4)
    it = it[it[:, 0] > 0]
    code = it[:, 3] & 15
    for kind, sel in (("band", code < 8), ("tile", code == 14), ("fold", code == 15)):
        if bool(sel.any()):
            c = it[sel]
            print(f"items [{name}] {kind}: {int(sel.sum())}, cycles mean "
                  f"{float(c[:, 0].double().mean()):.0f} max {int(c[:, 0].max())}, free items "
                  f"mean {float(c[:, 1].double().mean()):.0f} max {int(c[:, 1].max())}, occupied "
                  f"items max {int(c[:, 2].max())}", flush=True)
    for row in it[torch.argsort(-it[:, 0])[:8]].tolist():
        kind = KINDS.get(row[3] & 15, f"band {row[3] & 15}")
        print(f"  slowest [{name}]: slot {row[3] >> 4} {kind}: {row[0]} cycles, {row[1]} free "
              f"items, {row[2]} occupied items", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--bands", type=int, nargs="*", default=[])
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
            ours = "pool_kernel" in line or "pool_prepare_kernel" in line
        if ours:
            print(f"  ptxas: {line.strip()}", flush=True)
    print(f"the prepare launch's cluster: {lib.pool_prepare_cluster_size()} blocks", flush=True)
    variants, prepares = kept_calls(dev)
    for name, c in prepares.items():
        c = cs.prepare_state(c)
        saved = {k: c[k].clone() for k in ("tables", "refcnt", "overflow", "n_alloc")
                 if c[k] is not None}

        def restore(c=c, saved=saved):
            for k, v in saved.items():
                c[k].copy_(v)

        def prep(c=c, restore=restore):
            restore()
            kernels.pool_prepare(**c)

        t_all, t_restore = cs.graph_ms(prep), cs.graph_ms(restore)
        restore()
        touched, work = kernels.pool_prepare(**c)
        print(f"pool_prepare [{name}]: {int(touched.sum())} tiles touched, {int(work.buf[4])} "
              f"new blocks, {int(work.buf[2])} items; device {1e3 * (t_all - t_restore):.2f} us "
              f"(a graph of 50 with the state's restore {1e3 * t_all:.2f}, the restore alone "
              f"{1e3 * t_restore:.2f}); {smi}", flush=True)
        if args.stamps:
            prep_buf = (ctypes.c_ulonglong * (16 * 12))()
            items_buf = (ctypes.c_ulonglong * (4096 * 4))()
            lib.pool_probe_stamps(ctypes.byref(prep_buf), ctypes.byref(items_buf))
            restore()
            kernels.pool_prepare(**c)
            torch.cuda.synchronize()
            err = lib.pool_probe_stamps(ctypes.byref(prep_buf), ctypes.byref(items_buf))
            if err:
                raise RuntimeError(f"pool_probe_stamps: cudaError_t {err}")
            cyc = torch.tensor(list(prep_buf), dtype=torch.int64).reshape(16, 12)
            for rank in range(16):
                if int(cyc[rank, 7]):
                    print(f"  prepare [{name}] block {rank}: " + ", ".join(
                        f"{p} {int(cyc[rank, i])}" for i, p in enumerate(PREP_PHASES)),
                          flush=True)
    for name, (a, live) in variants.items():
        pool, tables, origin, scale, model, poses, scans, cfg, touched, q = a
        got, want = pool.clone(), pool.clone()
        kernels.pool_insert(got, *a[1:], **live)
        kernels.pool_insert_ordered(want, *a[1:], **live)
        alive = cs.live_slots(pool, live)
        same = torch.equal(cs.bits(got[alive]), cs.bits(want[alive]))
        work = pool.clone()
        items = kernels.pool_work(pool, tables, origin, scale, poses, scans, cfg, touched, **live)
        device = cs.graph_ms(lambda: kernels.pool_insert(work, *a[1:], **live, work=items))
        touch = cs.graph_ms(lambda: kernels.pool_touched(tuple(tables.shape[1:]), pool.shape[1],
                                                         origin, scale, poses, scans, cfg, q))
        print(f"pool_insert [{name}]: {int(alive.sum())} live slots, {int(touched.sum())} touched "
              f"tiles; equal to the ordered sums on the live slots {same}; device "
              f"{device * 1e3:.2f} us (a graph of 50); pool_touched {touch * 1e3:.2f} us; {smi}",
              flush=True)
        kept_bands = kernels.POOL_ROBOT_BANDS
        try:
            for nb in args.bands:
                kernels.POOL_ROBOT_BANDS = nb
                by = kernels.pool_work(pool, tables, origin, scale, poses, scans, cfg, touched,
                                       **live)
                got = pool.clone()
                kernels.pool_insert(got, *a[1:], **live, work=by)
                same = torch.equal(cs.bits(got[alive]), cs.bits(want[alive]))
                t = cs.graph_ms(lambda: kernels.pool_insert(work, *a[1:], **live, work=by))
                print(f"pool_insert [{name}], the robot's tile in {nb} bands: {t * 1e3:.2f} us "
                      f"device; equal to the ordered sums {same}", flush=True)
        finally:
            kernels.POOL_ROBOT_BANDS = kept_bands
        if args.stamps and "," not in name:
            slots = 16
            buf = (ctypes.c_ulonglong * (1024 * slots))()
            prep_buf = (ctypes.c_ulonglong * (16 * 12))()
            items_buf = (ctypes.c_ulonglong * (4096 * 4))()
            lib.scan_insert_probe_stamps(ctypes.byref(buf))
            lib.pool_probe_stamps(ctypes.byref(prep_buf), ctypes.byref(items_buf))
            kernels.pool_insert(pool.clone(), *a[1:], **live, work=items)
            torch.cuda.synchronize()
            err = lib.scan_insert_probe_stamps(ctypes.byref(buf))
            err = err or lib.pool_probe_stamps(ctypes.byref(prep_buf), ctypes.byref(items_buf))
            if err:
                raise RuntimeError(f"probe stamps: cudaError_t {err}")
            item_report(name, items_buf)
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
