"""The host's time to issue a step's draws on the card, part by part.

    python3 scripts/torch_port/draws_host.py [--calls N]

On tiny's step plan (``engine.step_plan``: the next key and 12 x 64 x 3
normals), times ``N`` calls of each part back to back on the host clock (a
synchronise every 50 calls, outside the timed spans) and prints the median
and the 10th-90th percentiles in microseconds: ``torch.randn`` of the same
normals from a ``torch.Generator`` (what the step drew before it drew from
keys), the plan's lookup (``engine._step_draws``), the layout's lookup
(``kernels._prng_layout``), the two outputs' ``torch.empty``, the output
pointers' ctypes array, the launch through ``kernels._launch`` on
preallocated outputs, the bare ctypes call, then the whole wrapper
(``kernels.prng_draws``) and ``engine.draw_step``. Needs a card; imports no
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def timed(fn, calls: int) -> tuple[float, float, float]:
    """(median, 10th, 90th percentile) microseconds of ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    spans = []
    for i in range(calls):
        if i % 50 == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        spans.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    q = np.percentile(np.array(spans) * 1e6, [50, 10, 90])
    return float(q[0]), float(q[1]), float(q[2])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from slam_constructor_tpu_torch.models import engine, tiny
    from slam_constructor_tpu_torch.ops import kernels, prng

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = tiny.tiny_config(map_size=256)
    mc = cfg.matcher_cfg
    key = prng.key(0, dev)
    plan = engine.step_plan(cfg)
    batch = tuple(key.shape[:-1])
    gen = torch.Generator(device=dev).manual_seed(1)
    lay = kernels._prng_layout(plan, batch, dev)
    outs = tuple(torch.empty(s, dtype=t, device=dev) for s, t in lay.outputs)
    ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    fn = kernels._prng_draws_fn()
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())

    def launch():
        kernels._launch("prng_draws", dev, lambda s: fn(
            lay.table.data_ptr(), len(plan), lay.max_elements, key.data_ptr(), ptrs, s))

    parts = {
        "torch.randn from a generator": lambda: torch.randn(
            (mc.rounds, mc.batch, 3), generator=gen, device=dev),
        "plan lookup (engine._step_draws)": lambda: engine._step_draws(cfg),
        "layout lookup (kernels._prng_layout)": lambda: kernels._prng_layout(plan, batch, dev),
        "outputs (torch.empty x 2)": lambda: tuple(
            torch.empty(s, dtype=t, device=dev) for s, t in lay.outputs),
        "pointer array (ctypes)": lambda: (ctypes.c_void_p * len(outs))(
            *(o.data_ptr() for o in outs)),
        "launch (kernels._launch)": launch,
        "bare ctypes call": lambda: fn(lay.table.data_ptr(), len(plan), lay.max_elements,
                                       key.data_ptr(), ptrs, stream),
        "kernels.prng_draws": lambda: kernels.prng_draws(key, plan),
        "engine.draw_step": lambda: engine.draw_step(cfg, key),
    }
    print(f"host time a call on {smi}, {args.calls} calls each (median, 10th-90th "
          f"percentile, us):", flush=True)
    for name, part in parts.items():
        med, lo, hi = timed(part, args.calls)
        print(f"  {name}: {med:.2f} ({lo:.2f}-{hi:.2f})", flush=True)


if __name__ == "__main__":
    main()
