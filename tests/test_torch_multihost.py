"""Liveness and recovery across processes (``parallel/multihost.py``):
two gloo processes join a group through ``initialize``, a heartbeat
succeeds while both live and times out once one is dead; a
``RecoveryLoop`` resumes an RBPF run bit for bit from its snapshot."""

import multiprocessing
import queue

import numpy as np
import pytest
import torch

from slam_constructor_tpu_torch.models import gmapping as tgm
from slam_constructor_tpu_torch.ops import prng as tprng
from slam_constructor_tpu_torch.parallel import mesh as meshlib
from slam_constructor_tpu_torch.parallel import multihost
from slam_constructor_tpu_torch.utils import datagen

torch.set_num_threads(1)


def _rank(rank, port, out):
    import os

    torch.set_num_threads(1)
    info = multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
    mesh = meshlib.make_mesh(n_hosts=2, n_chips=1)
    alive = multihost.heartbeat(mesh, "hosts", timeout_s=20.0)
    if rank == 1:
        out.put((rank, info, alive, None))
        out.close()
        out.join_thread()  # the report is sent before the process dies
        os._exit(0)  # dies without leaving the group
    dead = multihost.heartbeat(mesh, "hosts", timeout_s=5.0)
    out.put((rank, info, alive, dead))
    out.close()
    out.join_thread()
    os._exit(0)  # the group is wedged: leave as the docstring says, without a collective


def test_heartbeat_times_out_on_a_dead_rank():
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = meshlib.free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, out), daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(2):
            rank, info, alive, dead = out.get(timeout=60)
            got[rank] = (info, alive, dead)
    except queue.Empty:
        pytest.fail(f"ranks {sorted({0, 1} - set(got))} did not report within 60 s")
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    for rank, (info, alive, _) in got.items():
        assert info["process_id"] == rank and info["num_processes"] == 2
        assert info["backend"] == "gloo" and alive
    assert got[0][2] is False


def test_initialize_without_a_coordinator_joins_nothing(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    info = multihost.initialize(device="cpu")
    assert info == {"process_id": 0, "num_processes": 1, "backend": None, "local_devices": 1}


def test_recovery_loop_resumes_bit_for_bit(tmp_path):
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.rectangle_trajectory(step=0.12)[:4]
    scans, odom, gt = datagen.synth_sequence(occ, origin, scale, poses,
                                             datagen.default_bearings(60), rng=3)
    cfg = tgm.fast_config(n_particles=4, map_size=96, map_scale=0.2, usable_range=2.5)

    def fresh():
        st = tgm.init_state(cfg, "cpu")
        st.poses = gt[0].expand(4, 3).clone()
        st.key = tprng.key(11)
        return {"state": st}

    def step(run, i):
        st, _ = tgm.gmapping_step(cfg, run["state"], scans[i], odom[i])
        return {"state": st}

    path = str(tmp_path / "rbpf")
    loop = multihost.RecoveryLoop(path, save_every=2)
    run, resumed = loop.restore_or(fresh(), fresh)
    assert not resumed
    for i in range(3):  # a snapshot after step 2; step 3 is lost with the process
        run = step(run, i)
        loop.tick(run)
    straight = fresh()
    for i in range(4):
        straight = step(straight, i)

    back, resumed = multihost.RecoveryLoop(path, save_every=2).restore_or(fresh(), fresh)
    assert resumed
    for i in range(2, 4):
        back = step(back, i)
    for name in ("poses", "log_weights", "key", "step"):
        assert torch.equal(getattr(back["state"], name), getattr(straight["state"], name))
    assert torch.equal(back["state"].gm.cells, straight["state"].gm.cells)
