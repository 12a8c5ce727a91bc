"""Where an RBPF slot run parts on two devices: every step's stages of
``chip_smoke.py``'s slot run on the card and on the CPU with the same draws,
compared stage by stage in step order.

    python3 scripts/torch_port/slot_parts.py [--slot NAME] [--scans N]
        [--devices cuda,cpu] [--out DIR]

``--devices`` names the two runs: ``cuda``, ``cpu`` (the plain twins), or
``ordered``: the CPU with the match and the climb summing their scores in
the kernels' order (``kernels.mc_match_loop`` and ``hill_climb_loop`` over
``kernels.overlap_score_ordered``), which needs no card.

Runs the slot run ``NAME`` (a name of ``chip_smoke.slot_runs()``; the
copy-on-write Monte-Carlo match with the hill-climbing refine by default)
for its first ``N`` scans on each device with ``chip_smoke.py``'s draws
(``rbpf_draws`` of ``SLOT_VS_CPU_SCANS`` steps), keeping every call of the
proposal, the window gather, the particle match (``mc_match_batched``), the
refine (``hill_climb``, ``gradient_refine``) and the insert, with its
arguments and its result. Prints, call by call in step order, how far each
argument and result of the first device is from the second's (max |diff|
and the count that differ). It stops at the first call whose arguments
differ (the runs parted upstream) or whose arguments agree and whose
matches part: there it runs the first device's kernel on the second
device's arguments against the plain twin (``chip_smoke.twin_record``: the
decisions' margins) and against the twin summing in the kernels' order
(``kernels.overlap_score_ordered``), and writes that call's arguments and
results of both devices to ``DIR/<slot>_<wrapper>_<i>.pt``. Before that it
prints the two runs' trajectories compared as ``chip_smoke.py``'s slot
check compares them. Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: (module, function) of the stages kept, in the order a step runs them
STAGES = (("models.gmapping", "propose"), ("ops.cow", "extract_window"),
          ("ops.kernels", "mc_match_batched"), ("ops.kernels", "mc_match_windows"),
          ("ops.kernels", "hill_climb"), ("ops.kernels", "gradient_refine"),
          ("ops.cow", "insert_scans"))


def flat(x, prefix="") -> list:
    """(name, tensor) of every tensor in ``x`` (tuples, dataclasses, the
    draws' ``values``), moved to the CPU."""
    import dataclasses

    if isinstance(x, torch.Tensor):
        return [(prefix, x.detach().cpu().clone())]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                for t in flat(getattr(x, f.name), f"{prefix}.{f.name}")]
    if hasattr(x, "values") and isinstance(getattr(x, "values"), torch.Tensor):
        return flat(x.values, f"{prefix}.values")
    if isinstance(x, (tuple, list)):
        return [t for i, a in enumerate(x) for t in flat(a, f"{prefix}[{i}]")]
    return []


@contextlib.contextmanager
def tapped(log: list):
    """Every stage of STAGES records (name, raw args, flat args, flat
    result) into ``log`` while the block runs."""
    import importlib

    kept = []
    for mod_name, fn_name in STAGES:
        mod = importlib.import_module(f"slam_constructor_tpu_torch.{mod_name}")
        fn = getattr(mod, fn_name)

        def tap(*args, _fn=fn, _name=fn_name, **kwargs):
            raw = tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args)
            out = _fn(*args, **kwargs)
            log.append((_name, raw, flat(args, "arg"), flat(out, "out")))
            return out

        kept.append((mod, fn_name, fn))
        setattr(mod, fn_name, tap)
    try:
        yield
    finally:
        for mod, fn_name, fn in kept:
            setattr(mod, fn_name, fn)


def gaps(a: list, b: list) -> list:
    """(name, max |diff|, count differing, numel) of two flat lists."""
    out = []
    for (na, ta), (_, tb) in zip(a, b):
        if ta.shape != tb.shape or ta.dtype != tb.dtype:
            out.append((na, math.inf, -1, tb.numel()))
            continue
        if ta.is_floating_point():
            same = (ta == tb) | (ta.isnan() & tb.isnan())
            d = (ta.double() - tb.double()).nan_to_num().abs()
        else:
            same = ta == tb
            d = (ta.long() - tb.long()).abs().double()
        out.append((na, float(d.max()) if d.numel() else 0.0, int((~same).sum()), ta.numel()))
    return out


@contextlib.contextmanager
def kernels_order():
    """The match and the climb summing their scores in the kernels' order
    while the block runs (on any device: ``overlap_score_ordered``)."""
    from slam_constructor_tpu_torch.ops import kernels

    kept = kernels.mc_match_batched, kernels.hill_climb
    kernels.mc_match_batched = ORDERED["mc_match_batched"]
    kernels.hill_climb = ORDERED["hill_climb"]
    try:
        yield
    finally:
        kernels.mc_match_batched, kernels.hill_climb = kept


def _ordered(loop_name):
    def run(*a):
        from slam_constructor_tpu_torch.ops import kernels
        return getattr(kernels, loop_name)(kernels.overlap_score_ordered, *a)
    return run


#: the match's and the climb's loops over the score summed in the kernels' order
ORDERED = {"mc_match_batched": _ordered("mc_match_loop"), "hill_climb": _ordered("hill_climb_loop")}


def hexes(t) -> list:
    return [float.hex(float(x)) for x in t]


def explain(name, raw_a, raw_b, first) -> int:
    """The first run's kernel (``first``: a device, or ``ordered``) on the
    second run's arguments against the plain twin, with the twin's decision
    margins, and against the twin summing in the kernels' order, by
    particle. Returns how many matches part from the twin."""
    from slam_constructor_tpu_torch.ops import kernels

    loops = {"mc_match_batched": kernels.mc_match_loop, "hill_climb": kernels.hill_climb_loop}
    if name not in loops:
        print(f"  (no twin record for {name})", flush=True)
        return 0
    loop = loops[name]
    ordered = ORDERED[name](*raw_b)
    if first == "ordered":
        got = ordered
    else:
        moved = tuple(a.to(first) if isinstance(a, torch.Tensor) else a for a in raw_b)
        got = [t.cpu() for t in getattr(kernels, name)(*moved)]
    twin, margins = cs.twin_record(raw_b, loop, kernels.overlap_score_ref)
    dp = (got[0] - twin[0]).abs().amax(-1)
    trace = (got[2] - twin[2]).abs().nan_to_num()
    parted = (dp > 1e-6).nonzero().flatten().tolist()
    for p in parted:
        first_round = (trace[p] > cs.TOL).nonzero().flatten().tolist()
        upto = (first_round[0] + 1) if first_round else None
        print(f"  particle {p}: the kernel on the second run's arguments parts from the twin by "
              f"{float(dp[p]):.3e} m (prob {float((got[1][p] - twin[1][p]).abs()):.3e}); first "
              f"round past TOL {first_round[:1]}; the twin's margins up to there "
              f"{[float('%.3e' % float(x)) for x in margins[p][:upto]]}; the twin in the "
              f"kernels' order gives the kernel's pose: {torch.equal(ordered[0][p], got[0][p])}; "
              f"the best score by round, twin {hexes(twin[2][p])}, kernels' order "
              f"{hexes(ordered[2][p])}", flush=True)
    print(f"  {name}: kernel on the second run's arguments vs twin: {len(parted)} of "
          f"{dp.numel()} matches part, max|pose diff| {float(dp.max()):.3e}; the twin in the "
          f"kernels' order gives every pose of the kernel: {torch.equal(ordered[0], got[0])}",
          flush=True)
    return len(parted)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slot", default="gmapping cow monte_carlo+hill_climbing")
    ap.add_argument("--scans", type=int, default=2)
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--out", default=str(ROOT / "build" / "slot_parts"))
    args = ap.parse_args()
    runs = args.devices.split(",")
    if "cuda" in runs:
        from slam_constructor_tpu_torch.ops import _build
        _build.load()
    cfg = dict(cs.slot_runs())[args.slot]
    n = args.scans
    draws = cs.rbpf_draws(cfg, max(n, cs.SLOT_VS_CPU_SCANS))  # chip_smoke.py's
    logs, bits = [], []
    for run in runs:
        d = torch.device("cpu" if run == "ordered" else run)
        scans, odom, gt = cs.bench_sequence(d)
        log = []
        with (kernels_order() if run == "ordered" else contextlib.nullcontext()), tapped(log):
            e, _, _, _ = cs.run_gmapping_path(cfg, scans[:n], odom[:n], gt, 0, draws=draws,
                                              device=None if d.type == "cuda" else str(d))
        logs.append(log)
        bits.append([t.cpu() for t in (*e.genealogy, e.state.log_weights)])
        print(f"{run}: {len(log)} stage calls", flush=True)
    (pa, aa, la), (pb, ab, lb) = bits
    dpose = pa - pb
    dpose[..., 2] = torch.atan2(torch.sin(dpose[..., 2]), torch.cos(dpose[..., 2]))
    by_scan = dpose.abs().amax((1, 2))
    apart = ((by_scan > 1e-4) | (aa != ab).any(1)).nonzero().flatten().tolist()
    print(f"{runs[0]} vs {runs[1]}, {n} scans: max|pose diff| {float(by_scan.max()):.3e}, "
          f"ancestors equal: {torch.equal(aa, ab)}, max|log-weight diff| "
          f"{float((la - lb).abs().max()):.3e}; the runs part at scan {apart[:1]}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    counts, saved = {}, False
    for (name, raw_a, args_a, res_a), (name_b, raw_b, args_b, res_b) in zip(*logs):
        assert name == name_b, (name, name_b)
        i = counts[name] = counts.get(name, -1) + 1
        ga, gr = gaps(args_a, args_b), gaps(res_a, res_b)
        bad_a = [g for g in ga if g[2]]
        bad_r = [g for g in gr if g[2]]
        print(f"{name} #{i}: arguments differing {[(g[0], '%.3e' % g[1], g[2], g[3]) for g in bad_a]}"
              f"; results differing {[(g[0], '%.3e' % g[1], g[2], g[3]) for g in bad_r]}",
              flush=True)
        if bad_r and not saved:  # the first call whose results differ
            saved = True
            torch.save({"name": name, "first": raw_a, "second": raw_b,
                        "first_result": res_a, "second_result": res_b},
                       out / f"{args.slot.replace(' ', '_')}_{name}_{i}.pt")
        if bad_a:
            print(f"the arguments of {name} #{i} differ: the runs parted before it", flush=True)
            break
        if bad_r and explain(name, raw_a, raw_b, runs[0]):
            print(f"first call whose arguments agree and whose matches part: {name} #{i}",
                  flush=True)
            break

if __name__ == "__main__":
    main()
