"""Exhaustive digests of the reference's elementary functions and the
port's ``ops/libm`` against them.

    JAX_PLATFORMS=cpu python scripts/torch_port/libm_exhaustive.py --reference
        writes tests/data/libm_digests.json: the jitted reference's outputs
        (jnp.sin, jnp.cos, jnp.arctan, jnp.exp, jnp.log, jnp.sqrt and
        geometry.wrap_angle over all 2^32 float32 inputs; jnp.arctan2 over
        the seeded pairs and the grid), hashed as utils/libm_digest.py says
    python scripts/torch_port/libm_exhaustive.py --check [--ops sin cos ...]
        the port's plain versions on the CPU against the committed digests
        (a block at a time; prints each function's verdict and time)
    python scripts/torch_port/libm_exhaustive.py --check --device cuda
        the card's kernel (kernels.libm_*) against them

The reference's bits are those of the machine it runs on (glibc's ifunc
picks ``sinf``/``cosf``'s FMA build on a CPU with FMA): write the digests on
an x86-64 CPU with FMA and glibc 2.36.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slam_constructor_tpu_torch.utils import libm_digest as ld  # noqa: E402


def reference_fns():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from slam_constructor_tpu.ops import geometry

    def wrap(jf):
        f = jax.jit(jf)
        return lambda *ts: np.asarray(f(*(t.numpy() for t in ts)))

    unary = {"sin": jnp.sin, "cos": jnp.cos, "atan": jnp.arctan, "exp": jnp.exp,
             "log": jnp.log, "sqrt": jnp.sqrt, "wrap_angle": geometry.wrap_angle}
    return {k: wrap(f) for k, f in unary.items()}, wrap(jnp.arctan2)


def port_fns(device: str):
    from slam_constructor_tpu_torch.ops import libm
    if device == "cpu":
        return dict(libm._REFS), libm._atan2_ref
    return {op: getattr(libm, op) for op in ld.UNARY}, libm.atan2


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--reference", action="store_true")
    mode.add_argument("--check", action="store_true")
    ap.add_argument("--ops", nargs="*", default=[*ld.UNARY, "atan2"])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--threads", type=int, default=4, help="blocks hashed at once")
    ap.add_argument("--chunk", type=int, default=1 << 22)
    args = ap.parse_args()

    if args.reference:
        unary, atan2 = reference_fns()
        out = ld.load() if ld.DIGESTS.exists() else {"unary": {}}
        out["source"] = ("jitted JAX on an x86-64 CPU (glibc 2.36, FMA): scripts/torch_port/"
                         "libm_exhaustive.py --reference")
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 4) // args.threads))
        unary, atan2 = port_fns(args.device)
        want = ld.load()
    ok = True
    for op in args.ops:
        t0 = time.time()
        if op == "atan2":
            d = ld.atan2_digest(atan2, args.device, args.chunk, args.threads)
            if args.reference:
                out["atan2"] = d
        else:
            blocks = ld.unary_digests(unary[op], args.device, args.chunk, args.threads)
            d = ld.combine(blocks)
            if args.reference:
                out["unary"][op] = {"digest": d, "blocks": blocks}
        dt = time.time() - t0
        if args.reference:
            print(f"{op}: {d} ({dt:.1f} s)", flush=True)
            ld.DIGESTS.write_text(json.dumps(out, indent=1) + "\n")
        else:
            w = want["atan2"] if op == "atan2" else want["unary"][op]["digest"]
            same = d == w
            ok &= same
            print(f"{op} ({args.device}): {'equal' if same else 'DIFFERENT'} "
                  f"({d[:16]}... vs {w[:16]}..., {dt:.1f} s)", flush=True)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
