"""Command-line runner (port of ``slam_constructor_tpu.run``): one offline
runner for every engine and every shipped config.

    python -m slam_constructor_tpu_torch.run --config configs/tiny.properties \
        --dataset log.clf --out out/
    python -m slam_constructor_tpu_torch.run --config configs/viny.properties \
        --synthetic cecum --trajectory rectangle --steps 200 --out out/

Runs on the GPU; ``--cpu`` runs on the CPU instead (without a GPU and
without ``--cpu`` it raises). Writes a TUM trajectory, a PGM + YAML map, an
RGB render (PNG, or PPM without matplotlib), per-run metrics as JSONL, and
prints a JSON summary (ATE and RPE where ground truth is known).

The synthetic sequence draws its noise from the reference's key,
``PRNGKey(0)`` (``datagen.synth_sequence`` with a key), so the two
packages' CLIs see the same input on it as on a dataset file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch


def build_engine(args, n_beams: int, device):
    """(engine, kind): kind is 'engine', 'gmapping' or 'full'. A config
    with ``pf.particles`` builds the RBPF, any other an ``Engine``."""
    from .models import full, gmapping, tiny, viny
    from .models.engine import Engine
    from .utils import config as cfglib

    if args.config:
        props = cfglib.load_properties(args.config)
        if "pf.particles" in props:
            return gmapping.GMappingEngine(cfglib.gmapping_config_from(props), device), "gmapping"
        return Engine(cfglib.engine_config_from(props), device), "engine"
    if args.preset in ("tiny", "viny"):
        mk = tiny.tiny_config if args.preset == "tiny" else viny.viny_config
        cfg = mk(map_size=args.map_size)
        if args.map_storage == "tiled":
            cfg = dataclasses.replace(cfg, map_storage="tiled",
                                      tile_capacity=(args.map_size // 32) ** 2)
        return Engine(cfg, device), "engine"
    if args.preset == "gmapping":
        return gmapping.GMappingEngine(
            n_particles=args.particles, map_height=args.map_size, map_width=args.map_size,
            device=device,
        ), "gmapping"
    if args.preset == "full":
        return full.FullSlamEngine(n_beams=n_beams, device=device), "full"
    raise SystemExit(f"unknown preset {args.preset!r}")


def load_data(args, device):
    """(scans [T, R], odometry deltas f32[T, 3], ground truth f32[T, 3] or
    None) on ``device``: a CARMEN log, or a synthetic sequence."""
    from .ops import prng
    from .utils import datagen, dataset

    if args.dataset:
        log = dataset.read_carmen(args.dataset)
        scans, odom, _ = dataset.to_sequence(
            log, beam_stride=args.beam_stride, scan_stride=args.scan_stride, device=device)
        gt = log.gt_at_scans()  # TRUEPOS ground truth where the log has it
        if gt is not None:
            gt = torch.as_tensor(np.ascontiguousarray(gt[:: args.scan_stride]), device=device)
        return scans, odom, gt
    occ, origin, scale = (
        datagen.cecum_world(device=device) if args.synthetic == "cecum"
        else datagen.box_world(device=device)
    )
    if args.trajectory == "rectangle":
        poses = datagen.rectangle_trajectory(step=0.25, device=device)
    else:
        poses = datagen.corridor_trajectory(args.steps, device=device)
    reps = (args.steps + poses.shape[0] - 1) // poses.shape[0]
    poses = poses.repeat(reps, 1)[: args.steps]
    bearings = datagen.default_bearings(args.beams, device=device)
    return datagen.synth_sequence(
        occ, origin, scale, poses, bearings, rng=prng.key(0, device),
        odom_noise_xy=args.odom_noise, odom_noise_theta=args.odom_noise / 2,
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny", choices=["tiny", "viny", "gmapping", "full"])
    ap.add_argument("--config", help=".properties file (overrides --preset)")
    ap.add_argument("--dataset", help="CARMEN log file (MIT Stata/CSAIL format)")
    ap.add_argument("--synthetic", default="cecum", choices=["cecum", "box"])
    ap.add_argument("--trajectory", default="corridor", choices=["corridor", "rectangle"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--beams", type=int, default=360)
    ap.add_argument("--odom-noise", type=float, default=0.01)
    ap.add_argument("--map-size", type=int, default=256)
    ap.add_argument("--map-storage", default="dense", choices=["dense", "tiled"])
    ap.add_argument("--particles", type=int, default=30)
    ap.add_argument("--beam-stride", type=int, default=1)
    ap.add_argument("--scan-stride", type=int, default=1)
    ap.add_argument("--out", default="slam_out")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


@dataclasses.dataclass
class RunResult:
    summary: dict
    trajectory: torch.Tensor  # f32[T, 3] on the run's device
    engine: object


def execute(args) -> RunResult:
    """Everything ``main`` does but print: load, build, anchor the state at
    the first true pose, run, write the outputs."""
    from .device import resolve_device
    from .utils import evaluate, metrics as metricslib, trajectory as tio, viz

    device = resolve_device("cpu" if args.cpu else None)
    scans, odom, gt = load_data(args, device)
    n_scans, n_beams = scans.ranges.shape
    engine, kind = build_engine(args, n_beams, device)
    if gt is not None:
        # the map frame anchored at the true start pose
        if kind == "gmapping":
            p = engine.state.poses.shape[0]
            poses = gt[0].expand(p, 3).contiguous()
            engine.state = dataclasses.replace(engine.state, poses=poses)
        else:
            engine.state = dataclasses.replace(engine.state, pose=gt[0].clone())

    mlog = metricslib.MetricsLogger()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if kind == "full":
        traj = engine.run(scans, odom)
    else:
        traj, _ = engine.run(scans, odom)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    tio.save_tum(os.path.join(args.out, "trajectory.tum"), traj)
    occ = engine.occupancy
    tio.save_map_pgm(os.path.join(args.out, "map.pgm"), occ)
    gm = engine.state.gm
    origin = gm.origin if gm.origin.dim() == 1 else gm.origin[0]
    viz.save_map_yaml(os.path.join(args.out, "map.yaml"), "map.pgm", origin, gm.scale)
    rgb = viz.render_map_rgb(occ, traj, origin, gm.scale, gt=gt)
    viz.save_png(os.path.join(args.out, "map.png"), rgb)
    mlog.log(n_scans, wall_s=dt, scans_per_sec=n_scans / dt)
    mlog.save_jsonl(os.path.join(args.out, "metrics.jsonl"))

    summary = {
        "preset": args.config or args.preset,
        "scans": int(n_scans),
        "beams": int(n_beams),
        "wall_s": round(dt, 3),
        "scans_per_sec": round(n_scans / dt, 2),
        "out": args.out,
    }
    if gt is not None:
        summary["ate_m"] = round(float(evaluate.ate(traj, gt, align=False)), 4)
        t_err, r_err = evaluate.rpe(traj, gt)
        summary["rpe_t_m"] = round(float(t_err), 4)
        summary["rpe_r_rad"] = round(float(r_err), 4)
    return RunResult(summary=summary, trajectory=traj, engine=engine)


def main(argv=None) -> dict:
    summary = execute(parse_args(argv)).summary
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
