"""Quality benchmark of the port: ATE of every preset on ``bench_ate.py``'s
sequence, one JSON line a preset, of ``bench_ate.py``'s shape.

    python scripts/torch_port/bench_ate_port.py [--keys N] [--cpu]

The sequence is ``bench_ate.py:77-100``'s, drawn as the reference draws it:
two laps of the cecum world's inner block (``SLAM_ATE_LAPS``), 120 beams
(``SLAM_ATE_BEAMS``), odometry noise 2 cm / 0.012 rad a step from
``PRNGKey(42)`` (``datagen.synth_sequence`` with the port's key). The
presets are the reference's (``bench_ate.py:120-190``): tiny and viny at
48 x 12 rounds, viny_m3rsm, the RBPF at 16 particles (online and winner)
and at the fast operating point with 30 (online and winner), and the
loop-closing pipeline with its keyframe count and loops. The engines draw
from key ``k`` (the reference's default is ``PRNGKey(0)``); ``--keys N``
runs keys 0..N-1 and adds ``"key"`` to each line. Runs on the card unless
``--cpu``; ``scans_per_sec`` is the run's wall clock ending in a
synchronize, on the device named in the first line. ``bench_ate_reference.jsonl``
beside this script holds the reference's lines from
``SLAM_ATE_CPU=1 python bench_ate.py`` on a CPU.

The reference's tiny and viny presets pick their free fill by backend
(ROADMAP trap a): on a CPU both run the DDA fill, so the port's viny line
here pins ``free_impl='dda'``, the lowering the reference's lines ran.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slam_constructor_tpu_torch.models import full, gmapping, posegraph as pg, tiny, viny  # noqa: E402
from slam_constructor_tpu_torch.models.engine import Engine  # noqa: E402
from slam_constructor_tpu_torch.ops import matchers as mlib  # noqa: E402
from slam_constructor_tpu_torch.ops import prng  # noqa: E402
from slam_constructor_tpu_torch.ops.geometry import compose  # noqa: E402
from slam_constructor_tpu_torch.utils import datagen, evaluate  # noqa: E402


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1, help="the engines' keys 0..N-1")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    n_beams = int(os.environ.get("SLAM_ATE_BEAMS", 120))
    laps = int(os.environ.get("SLAM_ATE_LAPS", 2))
    print(json.dumps({"device": torch.cuda.get_device_name(0) if device.type == "cuda"
                      else "cpu", "laps": laps, "beams": n_beams}), flush=True)

    occ, origin, scale = datagen.cecum_world(device=device)
    lap = datagen.rectangle_trajectory(step=0.3, device=device)
    poses = lap.repeat(laps, 1)
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(n_beams, device=device),
        prng.key(42, device), odom_noise_xy=0.02, odom_noise_theta=0.012)
    n = int(odom.shape[0])

    def report(name, traj, dt, key=None):
        traj = traj.to(device)
        rpe_t, rpe_r = evaluate.rpe(traj, gt[: traj.shape[0]])
        rec = {"preset": name, "scans": n,
               "ate_m": round(float(evaluate.ate(traj, gt[: traj.shape[0]], align=False)), 4),
               "rpe_t_m": round(float(rpe_t), 4), "rpe_r_rad": round(float(rpe_r), 4),
               "scans_per_sec": round(n / dt, 2)}
        if key is not None:
            rec["key"] = key
        print(json.dumps(rec), flush=True)

    t0 = time.perf_counter()
    p = gt[0]
    odo = [p]
    for d in odom[1:]:
        p = compose(p, d)
        odo.append(p)
    odo = torch.stack(odo)
    sync(device)
    report("odometry_only", odo, time.perf_counter() - t0)

    viny_cfg = viny.viny_config(mc_batch=48, mc_rounds=12)
    viny_cfg = dataclasses.replace(viny_cfg, beam=dataclasses.replace(viny_cfg.beam,
                                                                      free_impl="dda"))
    engines = [("tiny", lambda k: tiny.make_engine(device=device, seed=k, mc_batch=48,
                                                   mc_rounds=12)),
               ("viny", lambda k: Engine(viny_cfg, device=device, seed=k)),
               ("viny_m3rsm", lambda k: Engine(viny.viny_m3rsm_config(), device=device, seed=k))]
    gcfg = gmapping.GMappingConfig(
        n_particles=16, map_height=256, map_width=256,
        matcher_cfg=mlib.MonteCarloConfig(sigma_xy=0.08, sigma_theta=0.04, batch=24, rounds=8))
    graph = pg.PoseGraphConfig(
        max_keyframes=128, max_edges=512, keyframe_distance=0.7, loop_radius=2.0,
        min_index_gap=8, min_prob=0.65, max_candidates=4, local_map_size=120, gn_iterations=12)
    fcfg = full.FullConfig(tracking=tiny.tiny_config(mc_batch=48, mc_rounds=12), graph=graph)

    for k in range(args.keys):
        key = k if args.keys > 1 else None
        for name, make in engines:
            e = make(k)
            e.state.pose = gt[0].clone()
            sync(device)
            t0 = time.perf_counter()
            traj, _ = e.run(scans, odom)
            sync(device)
            report(name, traj, time.perf_counter() - t0, key)
        for name, cfg in (("gmapping", gcfg), ("gmapping_fast", gmapping.fast_config(n_particles=30))):
            e = gmapping.GMappingEngine(cfg, device=device, seed=k)
            e.state.poses = gt[0].expand(cfg.n_particles, 3).clone()
            sync(device)
            t0 = time.perf_counter()
            traj, _ = e.run(scans, odom)
            sync(device)
            dt = time.perf_counter() - t0  # throughput: the RBPF run
            report(f"{name}_online", traj, dt, key)
            report(name, e.winner_trajectory(), dt, key)
        e = full.FullSlamEngine(fcfg, n_beams=n_beams, device=device, seed=k)
        e.state.pose = gt[0].clone()
        sync(device)
        t0 = time.perf_counter()
        traj = e.run(scans, odom)
        sync(device)
        report("full_posegraph", traj, time.perf_counter() - t0, key)
        info = {"preset": "full_posegraph_info", "keyframes": int(e.graph.n_kf),
                "loops": e.total_loops}
        if key is not None:
            info["key"] = key
        print(json.dumps(info), flush=True)


if __name__ == "__main__":
    main()
