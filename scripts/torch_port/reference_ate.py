"""ATE of the JAX reference on the CPU over the port's smoke sequence.

    JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --preset viny [--port] [--keys 5]
    JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --preset full [--port] [--keys 5]
    JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --preset gmapping [--port] [--keys 5]
    JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --preset gmapping_baseline [--port] [--keys 5]
    JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --preset gmapping_cow[_2lap] [--port] [--keys 5]
    JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --preset viny_m3rsm [--port]
    JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --preset full_m3rsm [--port] [--keys 5]
    JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --preset full_hill|full_gradient [--port] [--keys 5]
    JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --preset gmapping --slot MATCHER[+REFINE] [--port] [--keys 5]
    JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --config configs/X.properties [--port] [--keys 5]

Builds the sequence that ``chip_smoke.py`` drives (512 scans along the
cecum rectangle, 360 beams, odometry noise 0.01 m / 0.005 rad from
``np.random.default_rng(0)``) with the port's datagen on the CPU, hands it
to the reference's ``run_sequence`` as arrays, and prints the reference's
ATE without alignment. The free-space fill is pinned to the algorithm the
port's preset names (tiny: 'dda', viny: 'polar'). ``chip_smoke.py`` holds
the card's ATE against the figure printed here.

With ``--keys N`` the reference runs once for each of ``PRNGKey(0..N-1)``
(the matcher's noise; the sequence stays the same), and the port runs on
the CPU twice for each: with that key's noise chain injected, and with its
own generator seeded ``k``. The spread shows how far a single run's ATE
moves with the matcher's noise alone.

With ``--dissect K`` the first scan at which the port (key ``K``'s noise
injected) leaves the jitted reference by more than 1e-4 is taken apart:
the reference's state just before it crosses to the port through
``convert``; the port's step from that state and the reference's matcher
run eagerly (op by op) on the same state and noise are held against the
jitted run. Where the port and the eager reference agree and the jitted one
differs, the edge lies between the reference's own lowerings.

With ``--port`` the port also runs on the CPU (plain twins) with the
reference's matcher noise chain injected, and the largest pose difference
over the sequence is printed.

With ``--preset full`` the sequence and the configuration are those of
``chip_smoke.py``'s loop-closing path (bench.py's ``full`` preset: 512 scans
over two laps, the windowed tiny tracker, keyframes 0.7 m apart, a burst
every 8 loops, one segment) and the figure is the ATE of the reference
``FullSlamEngine``'s corrected trajectory, beside the same tracker's ATE
without the graph; ``--keys N`` runs it for each of ``PRNGKey(0..N-1)``, and
``--port`` runs the port's ``FullSlamEngine`` on the CPU with key 0's noise
injected and prints how far its trajectory, keyframes and loop count lie
from the reference's. ``--dissect`` is for tiny and viny only.

With ``--preset gmapping_2lap`` the same over the reference's own quality
sequence (two laps at 0.3 m a step, odometry noise 0.02 m / 0.012 rad,
``chip_smoke.gmapping_quality_sequence``); with ``--multiseed`` it runs
the reference's 5-seed protocol (``scripts/r3/gm_multiseed.py``: a
sequence and a filter key a seed) on both sides, the port on the CPU with
its own generator.

With ``--preset gmapping`` the reference's RBPF at bench.py's ``gmapping``
preset (``fast_config(n_particles=30, map_size=256)``: 160^2 windows,
20 x 5 Monte-Carlo rounds on every second beam, 6 m usable range, the DDA
free fill) runs over the tiny sequence; the figures are the winner's ATE
(the final best particle's genealogy) and the online ATE (the best
particle at each scan), a key at a time. ``--port`` runs the port's
``GMappingEngine`` on the CPU with key 0's draws injected (proposal and
matcher normals and resampling offsets rebuilt from the key chain) and
prints how far its poses, weights and genealogy lie from the reference's,
and how often an insert window was clamped at the map's edge.

With ``--preset gmapping_cow`` the same RBPF on the copy-on-write block
pool (``map_storage='cow'``, blocks of 32 cells, 5 x 5 tiles matched a
particle: 160^2 windows, as the dense path's; 1,024 blocks), over the tiny
sequence, and ``--preset gmapping_cow_2lap`` over the two-lap quality
sequence; each key's figure also says whether the pool's overflow latch
was set and how many distinct blocks the pool held at the end.

With ``--preset gmapping_baseline`` the same with the reference's
``GMappingConfig()`` at its defaults (``utils.config.preset('gmapping')``,
the BASELINE gmapping config: 30 whole 256^2 maps at 0.1 m, no match or
insert window, 360 beams scored with the obstacle reducer, 16 x 6
Monte-Carlo rounds at sigma 0.08 / 0.04, the DDA free fill to 15 m) and the
port's ``GMappingConfig()``.

With ``--preset viny_m3rsm`` the reference's ``viny_m3rsm_config(map_size=
256)`` (the M3RSM global matcher on every scan, the DDA free fill) runs
over the same 512 scans. M3RSM draws no noise, so one run is the figure;
``--port`` runs the port on the CPU and prints how far its poses lie from
the reference's. ``--preset full_m3rsm`` is ``--preset full`` with the
M3RSM loop matcher of the reference's own test (``tests/test_posegraph.py:
451-455``: 3 levels, +-0.6 m, +-0.3 rad in 7 steps, overlap scoring on
every second beam), ``chip_smoke.full_m3rsm_config``; ``--preset full_hill``
and ``full_gradient`` the same with the loop closer's hill climb or gradient
ascent (``chip_smoke.full_loop_config``); ``--slot MATCHER[+REFINE]`` puts
a slot of ``chip_smoke.GM_SLOTS`` into a gmapping preset
(``chip_smoke.gmapping_slot_config``: ``--preset gmapping --slot
monte_carlo+hill_climbing`` is the Monte-Carlo match with the
hill-climbing refine).

With ``--config FILE`` (a ``.properties`` file of ``configs/`` for the
single-hypothesis engine) the sequence is the one ``chip_smoke.py``'s CLI
phase runs (``python -m slam_constructor_tpu_torch.run --config FILE
--synthetic cecum --trajectory rectangle --steps 128``: 360 beams, the
rectangle at 0.25 m a step, odometry noise 0.01 m / 0.005 rad from
``np.random.default_rng(0)``), built by the port's CLI on the CPU, and the
reference's engine from the same file (``utils.config.engine_config_from``)
runs it once for each key ``PRNGKey(0..N-1)`` (``--keys N``); the figure
is the ATE without alignment that the CLI prints. ``--port`` also runs the
port on the CPU with key 0's matcher noise injected and prints how far its
poses lie from the reference's. ``--steps`` sets the sequence's length.

This is a parity tool, like the tests: it imports both packages. Nothing
it prints is a device metric.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the checkout's root

from chip_smoke import (  # noqa: E402  (the same sequences and configuration)
    M3RSM_LOOP_MATCHER, MAP, N_BEAMS, N_SCANS, bench_sequence, full_config, full_loop_config,
    full_m3rsm_config, full_sequence, gmapping_quality_sequence, gmapping_slot_config,
    odometry_trajectory,
)

FREE_IMPL = {"tiny": "dda", "viny": "polar"}
PRESETS = [*sorted(FREE_IMPL), "viny_m3rsm", "full", "full_m3rsm", "full_hill", "full_gradient",
           "gmapping", "gmapping_2lap", "gmapping_baseline", "gmapping_cow", "gmapping_cow_2lap"]
#: the loop matcher of ``--preset full_hill`` / ``full_gradient``
LOOP_KINDS = {"full_hill": "hill_climbing", "full_gradient": "gradient"}


def reference_modules():
    """The reference's (matchers, scoring, m3rsm), for ``chip_smoke``'s slot
    configs."""
    from slam_constructor_tpu.ops import m3rsm as jm3
    from slam_constructor_tpu.ops import matchers as jmatch
    from slam_constructor_tpu.ops import scoring as jscore

    return jmatch, jscore, jm3
#: the copy-on-write storage of ``--preset gmapping_cow``: 160^2 windows
#: (5 tiles of 32), the reference's default pool
COW_FIELDS = dict(map_storage="cow", tile_block=32, window_tiles=5, tile_capacity=1024)
#: the reference's RBPF quality protocol's seeds (scripts/r3/gm_multiseed.py)
MULTISEED = (42, 7, 19, 101, 202)


def noise_chain(key, n_steps, rounds, batch):
    """The reference's matcher normals: ``split(key)`` a step,
    ``split(sub, rounds)``, ``normal(keys[r], (batch, 3))``."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, rounds)
        out.append(np.stack([np.asarray(jax.random.normal(k, (batch, 3))) for k in keys]))
    return np.stack(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, default="viny")
    ap.add_argument("--port", action="store_true", help="also run the port on the CPU")
    ap.add_argument("--keys", type=int, default=1, help="matcher noise seeds to run")
    ap.add_argument("--multiseed", action="store_true",
                    help="gmapping_2lap: the reference's 5-seed protocol, reference and port")
    ap.add_argument("--stepwise", action="store_true",
                    help="gmapping: every step of the port from the reference's state")
    ap.add_argument("--dissect", type=int, default=None, metavar="K",
                    help="take apart the first diverging scan of key K")
    ap.add_argument("--config", default=None, metavar="FILE",
                    help="a .properties file: the reference engine on the CLI's sequence")
    ap.add_argument("--steps", type=int, default=128, help="--config: scans in the sequence")
    ap.add_argument("--slot", default=None, metavar="MATCHER[+REFINE]",
                    help="gmapping presets: chip_smoke.gmapping_slot_config's matcher slots")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    if args.config:
        print(json.dumps(config_preset(args)))
        return
    if args.preset in ("full", "full_m3rsm", *LOOP_KINDS):
        print(json.dumps(full_preset(args)))
        return
    if args.preset == "viny_m3rsm":
        print(json.dumps(viny_m3rsm_preset(args)))
        return
    if args.preset.startswith("gmapping"):
        print(json.dumps(gmapping_preset(args)))
        return

    from slam_constructor_tpu.models import engine as jeng
    from slam_constructor_tpu.models import tiny as jtiny
    from slam_constructor_tpu.models import viny as jviny
    from slam_constructor_tpu.ops.scan import LaserScan as JScan
    from slam_constructor_tpu_torch.models import engine as teng
    from slam_constructor_tpu_torch.models import tiny as ttiny
    from slam_constructor_tpu_torch.models import viny as tviny
    from slam_constructor_tpu_torch.utils import evaluate

    scans, odom, gt = bench_sequence("cpu")
    jmod, tmod = {"tiny": (jtiny, ttiny), "viny": (jviny, tviny)}[args.preset]
    jcfg = getattr(jmod, f"{args.preset}_config")(map_size=MAP)
    jcfg = dataclasses.replace(
        jcfg, beam=dataclasses.replace(jcfg.beam, free_impl=FREE_IMPL[args.preset]))
    jscans = JScan(
        ranges=jnp.asarray(scans.ranges.numpy()), bearings=jnp.asarray(scans.bearings.numpy()),
        valid=jnp.asarray(scans.valid.numpy()),
    )
    state = jeng.init_state(jcfg).replace(pose=jnp.asarray(gt[0].numpy()))
    t0 = time.perf_counter()
    _, jtraj, jprobs = jeng.run_sequence(jcfg, state, jscans, jnp.asarray(odom.numpy()))
    jtraj = torch.from_numpy(np.array(jtraj))
    out = {
        "preset": args.preset, "free_impl": FREE_IMPL[args.preset], "scans": N_SCANS,
        "beams": N_BEAMS, "map": MAP, "backend": jax.default_backend(),
        "reference_ate_m": float(evaluate.ate(jtraj, gt, align=False)),
        "reference_min_prob": float(np.asarray(jprobs)[1:].min()),
        "reference_seconds_cpu": time.perf_counter() - t0,
    }
    tcfg = getattr(tmod, f"{args.preset}_config")(map_size=MAP)
    mc = tcfg.matcher_cfg

    def port_run(noise=None, seed=0):
        e = teng.Engine(tcfg, device="cpu", seed=seed)
        e.state.pose = gt[0].clone()
        traj, _ = e.run(scans, odom, noise=noise)
        return traj

    def pose_diff(a, b):
        d = a - b
        d[:, 2] = torch.atan2(torch.sin(d[:, 2]), torch.cos(d[:, 2]))  # -pi == pi
        return d.abs().max(dim=1).values

    def first_over(d, tol=1e-4):
        """The first scan whose pose differs by more than ``tol``, or None."""
        idx = torch.nonzero(d > tol)
        return int(idx[0]) if idx.numel() else None

    if args.port:
        noise = noise_chain(jax.random.PRNGKey(0), N_SCANS, mc.rounds, mc.batch)
        ttraj = port_run(torch.from_numpy(noise))
        out["port_cpu_ate_m"] = float(evaluate.ate(ttraj, gt, align=False))
        out["max_abs_pose_diff"] = float(pose_diff(ttraj, jtraj).max())
    if args.keys > 1:
        rows = []
        for k in range(args.keys):
            key = jax.random.PRNGKey(k)
            chain = noise_chain(key, N_SCANS, mc.rounds, mc.batch)
            # run_sequence donates its state, the key with it: make it anew
            st = jeng.init_state(jcfg, jax.random.PRNGKey(k)).replace(
                pose=jnp.asarray(gt[0].numpy()))
            _, tr, _ = jeng.run_sequence(jcfg, st, jscans, jnp.asarray(odom.numpy()))
            tr = torch.from_numpy(np.array(tr))
            inj = port_run(torch.from_numpy(chain))
            rows.append({
                "key": k,
                "reference_ate_m": float(evaluate.ate(tr, gt, align=False)),
                "port_same_noise_ate_m": float(evaluate.ate(inj, gt, align=False)),
                "port_same_noise_max_pose_diff": float(pose_diff(inj, tr).max()),
                "port_same_noise_first_scan_over_1e-4": first_over(pose_diff(inj, tr)),
                "port_own_generator_ate_m": float(
                    evaluate.ate(port_run(seed=k), gt, align=False)),
            })
        out["by_key"] = rows
    if args.dissect is not None:
        out["dissect"] = dissect(args.dissect, jcfg, tcfg, scans, odom, gt, jscans,
                                 port_run, pose_diff, first_over)
    print(json.dumps(out))


def config_preset(args) -> dict:
    """The reference's engine built from ``args.config`` over the CLI's
    synthetic sequence, a run a key; with ``--port`` the port on the CPU
    with key 0's matcher noise."""
    from slam_constructor_tpu.models import engine as jeng
    from slam_constructor_tpu.ops.scan import LaserScan as JScan
    from slam_constructor_tpu.utils import config as jconfig
    from slam_constructor_tpu_torch import run as trun
    from slam_constructor_tpu_torch.models import engine as teng
    from slam_constructor_tpu_torch.utils import config as tconfig
    from slam_constructor_tpu_torch.utils import evaluate

    cli = trun.parse_args(["--config", args.config, "--synthetic", "cecum", "--trajectory",
                           "rectangle", "--steps", str(args.steps), "--cpu"])
    scans, odom, gt = trun.load_data(cli, torch.device("cpu"))
    props = jconfig.load_properties(args.config)
    jcfg = jconfig.engine_config_from(props)
    jscans = JScan(
        ranges=jnp.asarray(scans.ranges.numpy()), bearings=jnp.asarray(scans.bearings.numpy()),
        valid=jnp.asarray(scans.valid.numpy()),
    )
    out = {"config": args.config, "scans": int(scans.ranges.shape[0]),
           "beams": int(scans.ranges.shape[1]), "backend": jax.default_backend(),
           "odometry_ate_m": float(evaluate.ate(odometry_trajectory(gt[0], odom), gt,
                                                 align=False))}
    rows, jtraj0 = [], None
    for k in range(args.keys):
        # run_sequence donates its state, the key with it: make it anew
        st = jeng.init_state(jcfg, jax.random.PRNGKey(k)).replace(pose=jnp.asarray(gt[0].numpy()))
        t0 = time.perf_counter()
        _, tr, _ = jeng.run_sequence(jcfg, st, jscans, jnp.asarray(odom.numpy()))
        tr = torch.from_numpy(np.array(tr))
        rows.append({"key": k, "reference_ate_m": float(evaluate.ate(tr, gt, align=False)),
                     "seconds_cpu": time.perf_counter() - t0})
        jtraj0 = tr if jtraj0 is None else jtraj0
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    out["by_key"] = rows
    out["reference_worst_ate_m"] = max(r["reference_ate_m"] for r in rows)
    if args.port:
        tcfg = tconfig.engine_config_from(tconfig.load_properties(args.config))
        mc = tcfg.matcher_cfg
        noise = noise_chain(jax.random.PRNGKey(0), len(scans), mc.rounds, mc.batch)
        e = teng.Engine(tcfg, device="cpu")
        e.state.pose = gt[0].clone()
        t0 = time.perf_counter()
        ttraj, _ = e.run(scans, odom, noise=torch.from_numpy(noise))
        d = ttraj - jtraj0
        d[:, 2] = torch.atan2(torch.sin(d[:, 2]), torch.cos(d[:, 2]))
        over = torch.nonzero(d.abs().max(dim=1).values > 1e-4)
        out["port_cpu_ate_m"] = float(evaluate.ate(ttraj, gt, align=False))
        out["max_abs_pose_diff"] = float(d.abs().max())
        out["port_first_scan_over_1e-4"] = int(over[0]) if over.numel() else None
        out["port_seconds_cpu"] = time.perf_counter() - t0
    return out


def viny_m3rsm_preset(args) -> dict:
    """The reference's ``viny_m3rsm_config`` over the bench sequence, one
    run (nothing is drawn); with ``--port`` also the port on the CPU."""
    from slam_constructor_tpu.models import engine as jeng
    from slam_constructor_tpu.models import viny as jviny
    from slam_constructor_tpu.ops.scan import LaserScan as JScan
    from slam_constructor_tpu_torch.models import engine as teng
    from slam_constructor_tpu_torch.models import viny as tviny
    from slam_constructor_tpu_torch.utils import evaluate

    scans, odom, gt = bench_sequence("cpu")
    jcfg = jviny.viny_m3rsm_config(map_size=MAP)
    jscans = JScan(
        ranges=jnp.asarray(scans.ranges.numpy()), bearings=jnp.asarray(scans.bearings.numpy()),
        valid=jnp.asarray(scans.valid.numpy()),
    )
    state = jeng.init_state(jcfg).replace(pose=jnp.asarray(gt[0].numpy()))
    t0 = time.perf_counter()
    _, jtraj, jprobs = jeng.run_sequence(jcfg, state, jscans, jnp.asarray(odom.numpy()))
    jtraj = torch.from_numpy(np.array(jtraj))
    out = {
        "preset": "viny_m3rsm", "free_impl": jcfg.beam.free_impl, "scans": N_SCANS,
        "beams": N_BEAMS, "map": MAP, "backend": jax.default_backend(),
        "reference_ate_m": float(evaluate.ate(jtraj, gt, align=False)),
        "reference_min_prob": float(np.asarray(jprobs)[1:].min()),
        "reference_seconds_cpu": time.perf_counter() - t0,
    }
    if args.port:
        e = teng.Engine(tviny.viny_m3rsm_config(map_size=MAP), device="cpu")
        e.state.pose = gt[0].clone()
        t0 = time.perf_counter()
        ttraj, _ = e.run(scans, odom)
        d = ttraj - jtraj
        d[:, 2] = torch.atan2(torch.sin(d[:, 2]), torch.cos(d[:, 2]))
        over = torch.nonzero(d.abs().max(dim=1).values > 1e-4)
        out["port_cpu_ate_m"] = float(evaluate.ate(ttraj, gt, align=False))
        out["max_abs_pose_diff"] = float(d.abs().max())
        out["port_first_scan_over_1e-4"] = int(over[0]) if over.numel() else None
        out["port_seconds_cpu"] = time.perf_counter() - t0
    return out


def full_preset(args) -> dict:
    """The loop-closing pipeline of the reference over ``chip_smoke.py``'s
    full sequence, a key at a time; with ``--port`` also the port's, key 0's
    noise injected."""
    from slam_constructor_tpu.models import engine as jeng
    from slam_constructor_tpu.models import full as jfull
    from slam_constructor_tpu.models import posegraph as jpg
    from slam_constructor_tpu.models import tiny as jtiny
    from slam_constructor_tpu.ops.scan import LaserScan as JScan
    from slam_constructor_tpu_torch.models import full as tfull
    from slam_constructor_tpu_torch.utils import evaluate

    scans, odom, gt = full_sequence("cpu")
    m3 = args.preset == "full_m3rsm"
    kind = LOOP_KINDS.get(args.preset)
    tcfg = full_m3rsm_config() if m3 else full_loop_config(kind) if kind else full_config()
    g = tcfg.graph
    loop = {}
    if m3:
        from slam_constructor_tpu.ops import m3rsm as jm3
        from slam_constructor_tpu.ops import scoring as jscore

        lm = tcfg.graph.loop_matcher
        loop = dict(loop_matcher_kind="m3rsm", loop_matcher=jm3.M3RSMConfig(
            **M3RSM_LOOP_MATCHER, scoring=jscore.ScoringConfig(
                reducer=lm.scoring.reducer, stride=lm.scoring.stride)))
    jtrack = jtiny.fast_config(map_size=MAP, stride=2, mc_rounds=12)
    jtrack = dataclasses.replace(jtrack, beam=dataclasses.replace(jtrack.beam, free_impl="dda"))
    jcfg = jfull.FullConfig(
        tracking=jtrack,
        graph=jpg.PoseGraphConfig(
            keyframe_distance=g.keyframe_distance, min_index_gap=g.min_index_gap,
            max_candidates=g.max_candidates, local_map_size=g.local_map_size, **loop),
        optimize_every_loops=tcfg.optimize_every_loops,
    )
    if kind:
        jcfg = full_loop_config(kind, base=jcfg, modules=reference_modules())
    jscans = JScan(
        ranges=jnp.asarray(scans.ranges.numpy()), bearings=jnp.asarray(scans.bearings.numpy()),
        valid=jnp.asarray(scans.valid.numpy()),
    )
    jodom = jnp.asarray(odom.numpy())
    rows, first = [], None
    for k in range(max(args.keys, 1)):
        t0 = time.perf_counter()
        e = jfull.FullSlamEngine(jcfg, n_beams=N_BEAMS, key=jax.random.PRNGKey(k))
        e.state = e.state.replace(pose=jnp.asarray(gt[0].numpy()))
        traj = torch.from_numpy(np.array(e.run(jscans, jodom, segment=N_SCANS)))
        st = jeng.init_state(jtrack, jax.random.PRNGKey(k)).replace(pose=jnp.asarray(gt[0].numpy()))
        _, tracked, _ = jeng.run_sequence(jtrack, st, jscans, jodom)
        rows.append({
            "key": k,
            "reference_ate_m": float(evaluate.ate(traj, gt, align=False)),
            "reference_tracker_only_ate_m": float(
                evaluate.ate(torch.from_numpy(np.array(tracked)), gt, align=False)),
            "keyframes": int(e.graph.n_kf), "edges": int(e.graph.n_edges), "loops": e.total_loops,
            "seconds_cpu": time.perf_counter() - t0,
        })
        first = first or (e, traj)
    out = {"preset": args.preset, "scans": N_SCANS, "beams": N_BEAMS, "map": MAP,
           "backend": jax.default_backend(), "by_key": rows}
    if args.port:
        je, jtraj = first
        mc = tcfg.tracking.matcher_cfg
        noise = torch.from_numpy(noise_chain(jax.random.PRNGKey(0), N_SCANS, mc.rounds, mc.batch))
        te = tfull.FullSlamEngine(tcfg, n_beams=N_BEAMS, device="cpu")
        te.state.pose = gt[0].clone()
        t0 = time.perf_counter()
        ttraj = te.run(scans, odom, segment=N_SCANS, noise=noise)
        d = ttraj - jtraj
        d[:, 2] = torch.atan2(torch.sin(d[:, 2]), torch.cos(d[:, 2]))
        n_e = min(int(te.graph.n_edges), int(je.graph.n_edges))
        out["port_same_noise"] = {
            "ate_m": float(evaluate.ate(ttraj, gt, align=False)),
            "max_abs_pose_diff": float(d.abs().max()),
            "keyframes": int(te.graph.n_kf), "edges": int(te.graph.n_edges),
            "loops": te.total_loops, "bursts": te.n_bursts,
            "same_edges": bool(
                int(te.graph.n_edges) == int(je.graph.n_edges)
                and np.array_equal(te.graph.edge_i.numpy()[:n_e], np.asarray(je.graph.edge_i)[:n_e])
                and np.array_equal(te.graph.edge_j.numpy()[:n_e], np.asarray(je.graph.edge_j)[:n_e])),
            "seconds_cpu": time.perf_counter() - t0,
        }
    return out


def gmapping_draws(key, cfg):
    """The random numbers of one reference RBPF step from its key, as the
    port's ``Draws``, and the key after the step: ``split(key, 4)`` into
    the proposal normals, a match key a particle (split once more by the
    improved proposal into match and probe/sample keys), the resampling
    offset."""
    from slam_constructor_tpu_torch.models import gmapping as tgm

    key, k_noise, k_match, k_res = jax.random.split(key, 4)
    mc, p = cfg.matcher_cfg, cfg.n_particles
    keys = jax.random.split(k_match, p)
    improved = cfg.proposal == "improved"
    if improved:
        pairs = jax.vmap(jax.random.split)(keys)
        keys, kjs = pairs[:, 0], jax.vmap(jax.random.split)(pairs[:, 1])
    match = jax.vmap(lambda k: jax.vmap(lambda kr: jax.random.normal(kr, (mc.batch, 3)))(
        jax.random.split(k, mc.rounds)))(keys) if cfg.matcher == "monte_carlo" else None

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    return tgm.Draws(
        proposal=t(jax.random.normal(k_noise, (p, 3))),
        u0=t(jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / p)),
        match=None if match is None else t(match),
        probe=t(jax.vmap(lambda k: jax.random.normal(k, (cfg.proposal_samples, 3)))(kjs[:, 0]))
        if improved else None,
        sample=t(jax.vmap(lambda k: jax.random.normal(k, (3,)))(kjs[:, 1])) if improved else None,
    ), key


def stepwise(jcfg, tcfg, scans, odom, gt) -> dict:
    """Every step of the port from the reference's state before it (key 0's
    run), crossed through ``convert``, with the reference's draws: the
    largest difference of a step's poses, log-weights and cells, and the
    steps whose poses differ by more than 1e-5 or whose ancestors differ."""
    from slam_constructor_tpu.models import gmapping as jgm
    from slam_constructor_tpu.ops.scan import LaserScan as JScan
    from slam_constructor_tpu_torch.models import gmapping as tgm
    from slam_constructor_tpu_torch.utils import convert

    p = jcfg.n_particles
    step = jax.jit(lambda st, s, o: jgm.gmapping_step(jcfg, st, s, o))
    st = jgm.init_state(jcfg, jax.random.PRNGKey(0))
    st = st.replace(poses=jnp.broadcast_to(jnp.asarray(gt[0].numpy()), (p, 3)))
    key, worst, over = jax.random.PRNGKey(0), [0.0, 0.0, 0.0], []
    for i in range(len(gt)):
        draws, key = gmapping_draws(key, jcfg)
        before = convert.gmapping_state_from_numpy({
            "cells": np.asarray(st.gm.cells), "origin": np.asarray(st.gm.origin),
            "scale": st.gm.scale, "poses": np.asarray(st.poses),
            "log_weights": np.asarray(st.log_weights), "step": int(st.step)}, "cpu")
        js = JScan(ranges=jnp.asarray(scans.ranges[i].numpy()),
                   bearings=jnp.asarray(scans.bearings[i].numpy()),
                   valid=jnp.asarray(scans.valid[i].numpy()))
        st, idx = step(st, js, jnp.asarray(odom[i].numpy()))
        got, got_idx = tgm.gmapping_step(tcfg, before, scans[i], odom[i], draws)
        d = got.poses.numpy().astype(np.float64) - np.asarray(st.poses)
        d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
        diffs = (float(np.abs(d).max()),
                 float(np.abs(got.log_weights.numpy() - np.asarray(st.log_weights)).max()),
                 float(np.abs(got.gm.cells.numpy() - np.asarray(st.gm.cells)).max()))
        worst = [max(a, b) for a, b in zip(worst, diffs)]
        if diffs[0] > 1e-5 or not np.array_equal(got_idx.numpy(), np.asarray(idx)):
            over.append(i)
    return {"steps": len(gt), "max_pose_diff": worst[0], "max_log_weight_diff": worst[1],
            "max_cell_diff": worst[2], "steps_over_1e-5_or_other_ancestors": over}


def gmapping_preset(args) -> dict:
    """The reference's RBPF over the tiny sequence at bench.py's gmapping
    preset, a key at a time; with ``--port`` also the port's, key 0's draws
    injected."""
    from slam_constructor_tpu.models import gmapping as jgm
    from slam_constructor_tpu.ops.scan import LaserScan as JScan
    from slam_constructor_tpu_torch.models import gmapping as tgm
    from slam_constructor_tpu_torch.utils import evaluate

    two_laps = args.preset.endswith("_2lap")
    scans, odom, gt = gmapping_quality_sequence("cpu") if two_laps else bench_sequence("cpu")
    n_scans = len(gt)
    if args.preset == "gmapping_baseline":  # GMappingEngine()'s defaults
        jcfg, tcfg = jgm.GMappingConfig(), tgm.GMappingConfig()
    else:
        jcfg = jgm.fast_config(n_particles=30, map_size=MAP)
        tcfg = tgm.fast_config(n_particles=30, map_size=MAP)
    slot = (*args.slot.split("+"), None)[:2] if args.slot else None
    if slot:  # e.g. monte_carlo+hill_climbing: the Monte-Carlo match, then the hill climb
        jcfg = gmapping_slot_config(*slot, base=jcfg, modules=reference_modules())
        tcfg = gmapping_slot_config(*slot, base=tcfg)
    cow = args.preset.startswith("gmapping_cow")
    if cow:
        jcfg, tcfg = (dataclasses.replace(c, **COW_FIELDS) for c in (jcfg, tcfg))
    p = jcfg.n_particles

    def as_jax(scans):
        return JScan(ranges=jnp.asarray(scans.ranges.numpy()),
                     bearings=jnp.asarray(scans.bearings.numpy()), valid=jnp.asarray(scans.valid.numpy()))

    def reference_run(scans, odom, gt, key):
        st = jgm.init_state(jcfg, key)
        st = st.replace(poses=jnp.broadcast_to(jnp.asarray(gt[0].numpy()), (p, 3)))
        st, traj, neffs, all_poses, ancestors = jgm.run_sequence(
            jcfg, st, as_jax(scans), jnp.asarray(odom.numpy()))
        return st, traj, neffs, all_poses, ancestors, jgm.winner_trajectory(
            all_poses, ancestors, jgm.best_particle(st))

    def ate(traj, gt):
        return float(evaluate.ate(torch.as_tensor(np.array(traj)), gt, align=False))

    def odometry(odom, gt):
        from chip_smoke import odometry_trajectory

        return ate(odometry_trajectory(gt[0], odom), gt)

    if args.stepwise:
        return {"preset": args.preset, "stepwise": stepwise(jcfg, tcfg, scans, odom, gt)}
    if args.multiseed:
        # the protocol: a sequence and a filter key a seed; the port with its
        # own generator on the CPU
        rows = []
        for seed in MULTISEED:
            sc, od, g = gmapping_quality_sequence("cpu", seed)
            ref = reference_run(sc, od, g, jax.random.PRNGKey(seed + 1))
            e = tgm.GMappingEngine(tcfg, device="cpu", seed=seed + 1)
            e.state.poses = g[0].expand(p, 3).clone()
            e.run(sc, od)
            rows.append({"seed": seed, "odometry_ate_m": odometry(od, g),
                         "reference_winner_ate_m": ate(ref[5], g),
                         "port_winner_ate_m": ate(e.winner_trajectory(), g)})
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
        summary = {side: {"mean": float(np.mean([r[f"{side}_winner_ate_m"] for r in rows])),
                          "max": float(np.max([r[f"{side}_winner_ate_m"] for r in rows]))}
                   for side in ("reference", "port")}
        return {"preset": args.preset, "protocol": "scripts/r3/gm_multiseed.py seeds",
                "beams": N_BEAMS, "by_seed": rows, "winner_ate": summary}

    rows, first = [], None
    for k in range(max(args.keys, 1)):
        t0 = time.perf_counter()
        st, traj, neffs, all_poses, ancestors, winner = reference_run(
            scans, odom, gt, jax.random.PRNGKey(k))
        rows.append({
            "key": k,
            "reference_winner_ate_m": ate(winner, gt),
            "reference_online_ate_m": ate(traj, gt),
            "resamples": int((np.asarray(ancestors) != np.arange(p)).any(axis=1).sum()),
            "min_neff": float(np.asarray(neffs).min()),
            "seconds_cpu": time.perf_counter() - t0,
            **({"overflow": bool(st.gm.overflow),
                "distinct_blocks": int((np.asarray(st.gm.refcnt) > 0).sum())} if cow else {}),
        })
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
        first = first or (np.array(all_poses), np.array(ancestors), np.array(st.log_weights),
                          None if cow else np.array(st.gm.cells))
    out = {"preset": args.preset, "slot": slot, "scans": n_scans, "beams": N_BEAMS, "map": MAP,
           "particles": p,
           "window": jcfg.insert_window, "backend": jax.default_backend(),
           "odometry_ate_m": odometry(odom, gt), "by_key": rows}
    if args.port:
        j_poses, j_anc, j_logw, j_cells = first
        key, chain = jax.random.PRNGKey(0), []
        for _ in range(n_scans):
            d, key = gmapping_draws(key, jcfg)
            chain.append(d)
        draws = tgm.Draws(**{f: None if getattr(chain[0], f) is None else
                             torch.stack([getattr(d, f) for d in chain])
                             for f in ("proposal", "u0", "match", "probe", "sample")})
        e = tgm.GMappingEngine(tcfg, device="cpu")
        e.state.poses = gt[0].expand(p, 3).clone()
        t0 = time.perf_counter()
        e.run(scans, odom, draws=draws)
        all_poses, ancestors = e.genealogy
        d = all_poses.numpy().astype(np.float64) - j_poses
        d[..., 2] = np.arctan2(np.sin(d[..., 2]), np.cos(d[..., 2]))
        same_anc = (ancestors.numpy() == j_anc).all(axis=1)
        # insert windows that the map's edge pushed off their pose: the
        # corner before the clamp lies outside [0, MAP - window]
        if not cow:
            wi = tcfg.insert_window
            corner = torch.floor((all_poses[..., :2] - e.state.gm.origin[0]) / tcfg.map_scale) - wi // 2
            clamped = ((corner < 0) | (corner > MAP - wi)).any(-1)
        out["port_same_draws"] = {
            "winner_ate_m": ate(e.winner_trajectory(), gt),
            "max_abs_pose_diff": float(np.abs(d).max()),
            "first_scan_pose_diff_over_1e-4": next(
                (int(t) for t in range(n_scans) if np.abs(d[t]).max() > 1e-4), None),
            "ancestors_equal_scans": int(same_anc.sum()),
            "first_scan_ancestors_differ": next(
                (int(t) for t in range(n_scans) if not same_anc[t]), None),
            "max_abs_log_weight_diff": float(np.abs(e.state.log_weights.numpy() - j_logw).max()),
            **({} if cow else {
                "max_abs_cell_diff": float(np.abs(e.state.gm.cells.numpy() - j_cells).max()),
                "insert_windows_clamped": int(clamped.sum()),
                "insert_windows": int(clamped.numel())}),
            "seconds_cpu": time.perf_counter() - t0,
        }
    return out


def dissect(k, jcfg, tcfg, scans, odom, gt, jscans, port_run, pose_diff, first_over):
    from slam_constructor_tpu.models import engine as jeng
    from slam_constructor_tpu.ops import matchers as jmatch
    from slam_constructor_tpu.ops import scoring as jscore
    from slam_constructor_tpu.ops.geometry import compose as jcompose
    from slam_constructor_tpu_torch.models import engine as teng
    from slam_constructor_tpu_torch.utils import convert

    mc = tcfg.matcher_cfg
    jodom = jnp.asarray(odom.numpy())

    def fresh():
        return jeng.init_state(jcfg, jax.random.PRNGKey(k)).replace(
            pose=jnp.asarray(gt[0].numpy()))

    noise = torch.from_numpy(noise_chain(jax.random.PRNGKey(k), N_SCANS, mc.rounds, mc.batch))
    _, jtraj, jprobs = jeng.run_sequence(jcfg, fresh(), jscans, jodom)
    jtraj = torch.from_numpy(np.array(jtraj))
    s = first_over(pose_diff(port_run(noise), jtraj))
    if s is None:
        return {"key": k, "first_scan_over_1e-4": None}
    # the jitted reference's state just before scan s, carried to the port
    pre, _, _ = jeng.run_sequence(
        jcfg, fresh(), jax.tree.map(lambda a: a[:s], jscans), jodom[:s])
    state = convert.state_from_numpy({
        "cells": np.asarray(pre.gm.cells), "origin": np.asarray(pre.gm.origin),
        "scale": pre.gm.scale, "pose": np.asarray(pre.pose), "step": int(pre.step),
        "last_prob": float(pre.last_prob)}, "cpu")
    nxt = teng.slam_step(tcfg, state, scans[s], odom[s], noise=noise[s])
    # the reference's matcher, op by op, on the same state and key
    js = jax.tree.map(lambda a: a[s], jscans)
    _, sub = jax.random.split(pre.key)
    eager = jmatch.monte_carlo_match(
        jscore.MapView.of(pre.gm, jcfg.cell_model), js, jcompose(pre.pose, jodom[s]), sub,
        jcfg.matcher_cfg, jeng._point_weights(jcfg, js))
    return {
        "key": k, "first_scan_over_1e-4": s,
        "prob_reference_jitted": float(np.asarray(jprobs)[s]),
        "prob_reference_eager": float(eager.prob),
        "prob_port_from_reference_state": float(nxt.last_prob),
        "pose_diff_port_vs_jitted": float((nxt.pose - jtraj[s]).abs().max()),
        "pose_diff_port_vs_eager": float(
            (nxt.pose - torch.from_numpy(np.array(eager.pose))).abs().max()),
        "last_rounds_best_prob_eager": [float(x) for x in np.asarray(eager.trace)[-5:]],
    }


if __name__ == "__main__":
    main()
