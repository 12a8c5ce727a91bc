"""Write ``tests/data/prng_reference.npz``: JAX's own random draws, for the
port's threefry (``slam_constructor_tpu_torch/ops/prng.py`` and its kernel
``csrc/threefry.cu``) to be held to where JAX does not run (the card).

    JAX_PLATFORMS=cpu python scripts/torch_port/prng_fixture.py [--out PATH]

Each case is a root key (or a batch of them) and a plan: outputs, each a
path of ``[n, i]`` steps (key ``i`` of ``jax.random.split(k, n)``; ``i``
null takes every one, an output dimension, by ``vmap``) and a leaf:
``key``, ``bits``, ``uniform`` (with its bounds) or ``normal`` of a shape.
The draws are made here with ``jax.random`` alone, along the reference's own
split trees: ``PRNGKey`` at edge seeds, ``split`` at several ``n``,
``bits`` / ``uniform`` / ``normal`` at the shapes the paths use, the comb's
``uniform(k, (), 0, 1/n)``, the engine's step (``engine.py:219``, the
match's ``matchers.py:75``, ``:92``), the RBPF's step with both proposals
(``gmapping.py:207-211``, ``:239``, ``:286``, ``:302-318``) and the
synthetic sequence (``datagen.py:156-166``). ``manifest`` (JSON) lists the
cases; ``case_<c>_<o>`` holds output ``o`` of case ``c``. ``transform_sha256``
is the SHA-256 of ``sqrt(2) * erf_inv(u)`` (jitted, float32) over the 2^23
values of ``u`` that ``normal`` can draw, in mantissa order, and
``transform_head`` its first 4,096 values.
"""

from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (0, 1, 42, -1, 2**31 + 5, 2**32 + 7)
SPLITS = (1, 2, 4, 5, 12, 30, 1000)
SHAPES = ((), (3,), (30, 3), (64, 3), (12, 64, 3))
COMBS = (16, 30, 32)


def leaf(k, kind, shape, lo, hi):
    if kind == "key":
        return k
    if kind == "bits":
        return jax.random.bits(k, shape, dtype=jnp.uint32)
    if kind == "uniform":
        return jax.random.uniform(k, shape, minval=lo, maxval=hi)
    return jax.random.normal(k, shape)


def walk(k, path, out):
    """The reference's draw at the end of ``path`` from key ``k``."""
    if not path:
        return leaf(k, *out)
    (n, i), rest = path[0], path[1:]
    ks = jax.random.split(k, n)
    if i is None:
        return jax.vmap(lambda kk: walk(kk, rest, out))(ks)
    return walk(ks[i], rest, out)


def evaluate(root, plan):
    root = jnp.asarray(np.asarray(root, np.uint32))
    outs = []
    for d in plan:
        out = (d["kind"], tuple(d["shape"]), d.get("minval", 0.0), d.get("maxval", 1.0))
        fn = lambda k, d=d, out=out: walk(k, d["path"], out)  # noqa: E731
        for _ in range(root.ndim - 1):
            fn = jax.vmap(fn)
        outs.append(np.asarray(fn(root)))
    return outs


def draw(path, kind, shape=(), minval=0.0, maxval=1.0):
    d = {"path": [list(s) for s in path], "kind": kind, "shape": list(shape)}
    if kind == "uniform":
        d.update(minval=minval, maxval=maxval)
    return d


def engine_plan(rounds, batch):
    """``key, sub = split(key)``; the Monte-Carlo match from ``sub``."""
    return [draw([(2, 0)], "key"), draw([(2, 1), (rounds, None)], "normal", (batch, 3))]


def rbpf_plan(p, rounds, batch, improved=False, samples=16):
    """``key, k_noise, k_match, k_res = split(key, 4)`` and what the step
    draws from each (``gmapping.py``)."""
    k_p = [(4, 2), (p, None)]
    k_m = [*k_p, (2, 0)] if improved else k_p
    plan = [draw([(4, 0)], "key"), draw([(4, 1)], "normal", (p, 3)),
            draw([(4, 3)], "uniform", (), 0.0, 1.0 / p),
            draw([*k_m, (rounds, None)], "normal", (batch, 3))]
    if improved:
        plan += [draw([*k_p, (2, 1), (2, 0)], "normal", (samples, 3)),
                 draw([*k_p, (2, 1), (2, 1)], "normal", (3,))]
    return plan


def cases():
    out = []

    def add(name, root, plan):
        out.append({"name": name, "root": np.asarray(root, np.uint32).tolist(), "plan": plan})

    for s in SEEDS:
        add(f"PRNGKey({s})", jax.random.PRNGKey(s), [draw([], "key")])
    roots = {"PRNGKey(0)": jax.random.PRNGKey(0), "PRNGKey(42)": jax.random.PRNGKey(42),
             "PRNGKey(2^32+7)": jax.random.PRNGKey(2**32 + 7),
             "split(PRNGKey(7), 3)[2]": jax.random.split(jax.random.PRNGKey(7), 3)[2]}
    for name in ("PRNGKey(0)", "PRNGKey(42)"):
        for n in SPLITS:
            add(f"split({name}, {n})", roots[name], [draw([(n, None)], "key")])
    for name, k in roots.items():
        for shape in SHAPES:
            add(f"draws {name} {shape}", k,
                [draw([], kind, shape) for kind in ("bits", "uniform", "normal")])
        add(f"combs {name}", k, [draw([], "uniform", (), 0.0, 1.0 / n) for n in COMBS])
    batch = jax.random.split(jax.random.PRNGKey(3), 6)
    add("normal over 6 keys (vmap)", batch, [draw([], "normal", (4, 3))])
    # the engine's step: tiny (12 x 64), viny (16 x 32), full's tracker (12 x 48)
    for rounds, b in ((12, 64), (16, 32), (12, 48)):
        add(f"engine step {rounds} x {b}", roots["PRNGKey(42)"], engine_plan(rounds, b))
    # the RBPF's step: bench gmapping (30 particles, 5 x 20), the preset
    # (16 x 6 at 30), the improved proposal (16 probes)
    for p, rounds, b, imp in ((30, 5, 20, False), (30, 6, 16, False), (6, 5, 20, True),
                              (30, 5, 20, True)):
        k = jax.random.split(jax.random.PRNGKey(5), 2)[1]
        add(f"rbpf step P={p} {rounds} x {b}{' improved' if imp else ''}", k,
            rbpf_plan(p, rounds, b, imp))
    # the synthetic sequence: split(key, T + 1), range noise a scan, odometry
    t, r = 24, 120
    add(f"synthetic sequence T={t} R={r}", jax.random.PRNGKey(42),
        [draw([(t + 1, None)], "normal", (r,)), draw([(t + 1, t)], "normal", (t, 3))])
    return out


def transform():
    j = np.arange(1 << 23, dtype=np.uint32)
    f = (j | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, f * np.float32(2.0) + lo).astype(np.float32)
    out = np.asarray(jax.jit(lambda x: np.float32(np.sqrt(2)) * jax.lax.erf_inv(x))(u))
    return hashlib.sha256(out.astype(np.float32).tobytes()).hexdigest(), out[:4096]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data" / "prng_reference.npz"))
    args = ap.parse_args()
    arrays, manifest = {}, []
    for c, case in enumerate(cases()):
        for o, val in enumerate(evaluate(case["root"], case["plan"])):
            arrays[f"case_{c}_{o}"] = val
        manifest.append(case)
    sha, head = transform()
    arrays["transform_head"] = head
    np.savez_compressed(args.out, manifest=np.frombuffer(json.dumps(manifest).encode(), np.uint8),
                        transform_sha256=np.frombuffer(sha.encode(), np.uint8), **arrays)
    print(f"{args.out}: {len(manifest)} cases, transform sha256 {sha}")


if __name__ == "__main__":
    main()
