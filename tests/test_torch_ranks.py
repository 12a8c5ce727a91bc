"""A pool of gloo ranks for the multi-device tests, and the tests of the
collectives of ``slam_constructor_tpu_torch.parallel.mesh``.

:class:`RankPool` spawns four CPU processes that join one gloo process
group and wait for tasks: ``pool.run("name", mesh_spec, *args)`` sends the
task to every rank, each builds the device mesh ``mesh_spec`` (shape and
dimension names, over the four ranks in rank order) and calls
``task_<name>(mesh, *args)`` from this module; the results come back by
rank. A task over D = 2 ranks runs on a ``(2, 2)`` mesh whose first
dimension (``"rep"``) repeats it, so the same four ranks serve D = 2 and
D = 4. Each task has a deadline: a rank that does not answer in time fails
the test (and the pool) instead of holding the worker.

This module imports no JAX, so that the ranks start quickly; the test
files that compare with the reference import both and keep the reference
in the test process. One pool a test file (a module-scoped fixture).
"""

from __future__ import annotations

import multiprocessing
import queue
import time
import traceback

import numpy as np
import pytest
import torch

from slam_constructor_tpu_torch.parallel import mesh as meshlib

WORLD = 4
#: the ``mesh_spec`` of a flat axis over D ranks (D = 2 repeated twice)
FLAT = {2: ((2, 2), ("rep", "particles")), 4: ((4,), ("particles",))}


def flat(d: int, axis: str = "particles"):
    shape, names = FLAT[d]
    return shape, names[:-1] + (axis,)


class RankPool:
    """``WORLD`` spawned gloo ranks that run this module's ``task_*``."""

    def __init__(self, world: int = WORLD):
        ctx = multiprocessing.get_context("spawn")
        port = meshlib.free_port()
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, args=(r, world, port, self.tasks[r],
                                                        self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, name: str, mesh_spec, *args, timeout: float = 90.0) -> list:
        """Every rank's result of ``task_<name>(mesh, *args)``, by rank."""
        for q in self.tasks:
            q.put((name, mesh_spec, args))
        out: dict = {}
        deadline = time.monotonic() + timeout
        while len(out) < self.world:
            try:
                rank, ok, value = self.results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                self.close()
                raise TimeoutError(f"task {name}: ranks {sorted(set(range(self.world)) - set(out))}"
                                   f" did not answer within {timeout} s") from None
            if not ok:
                self.close()
                raise AssertionError(f"task {name} failed on rank {rank}:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.world)]

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in self.procs)


def pool_fixture():
    """A module-scoped fixture of one :class:`RankPool`."""

    @pytest.fixture(scope="module")
    def pool():
        p = RankPool()
        yield p
        p.close()

    return pool


def _worker(rank, world, port, tasks, results):
    torch.set_num_threads(1)
    meshlib.init(rank, world, "cpu", f"tcp://127.0.0.1:{port}", timeout_s=60.0)
    meshes: dict = {}
    try:
        while (msg := tasks.get()) is not None:
            name, (shape, names), args = msg
            try:
                key = (tuple(shape), tuple(names))
                if key not in meshes:
                    meshes[key] = meshlib.grid_mesh(shape, names)
                results.put((rank, True, globals()[f"task_{name}"](meshes[key], *args)))
            except Exception:  # reported to the test process, which fails the test
                results.put((rank, False, traceback.format_exc()))
    finally:
        meshlib.shutdown()


def host(tree):
    """Tensors in a (nested) result as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host(v) for v in tree)
    return tree


# --- tasks: the collectives ---------------------------------------------------


def task_collectives(mesh, axis, x_all):
    i = meshlib.axis_index(mesh, axis)
    x = torch.from_numpy(x_all[i])
    return host({
        "psum": meshlib.psum(x, mesh, axis), "pmax": meshlib.pmax(x, mesh, axis),
        "gather": meshlib.all_gather(x, mesh, axis),
        "next": meshlib.ppermute(x, mesh, axis, 1), "prev": meshlib.ppermute(x, mesh, axis, -1),
        "shard": meshlib.shard(torch.arange(8), mesh, axis),
        "index": i, "size": meshlib.axis_size(mesh, axis),
    })


def task_ladder(mesh, axis, x_all):
    from slam_constructor_tpu_torch.utils import determinism

    x = torch.from_numpy(x_all[meshlib.axis_index(mesh, axis)])
    return host({"sum": determinism.ladder_psum(x, mesh, axis),
                 "max": determinism.ladder_pmax(x, mesh, axis)})


def task_normalize(mesh, axis, logw, deterministic):
    from slam_constructor_tpu_torch.parallel import particles

    lw = meshlib.shard(torch.from_numpy(logw), mesh, axis)
    got = particles.psum_normalize_log_weights(lw, mesh, axis, deterministic)
    return host({"logw": meshlib.all_gather(got, mesh, axis).flatten(),
                 "neff": particles.sharded_neff(lw, mesh, axis)})


# --- tasks: scoring, the pose graph, the sharded block map ---------------------


def task_halo(mesh, axis, view, scan, poses, cfg, halo):
    from slam_constructor_tpu_torch.parallel import halo as halolib

    return host({"rows": halolib.sharded_score_poses(view, scan, poses, cfg, mesh, axis, halo),
                 "beams": halolib.beam_sharded_score_poses(view, scan, poses, cfg, mesh, axis)})


def task_dist_ba(mesh, axis, cfg, st, schur_split):
    from slam_constructor_tpu_torch.parallel import dist_ba

    return host(dist_ba.distributed_optimize(cfg, st, mesh, axis, schur_split).kf_poses)


def task_blockshard(mesh, axis, model, tiles, capacity, block, scale, poses, scans, beam,
                    score_poses, score_cfgs):
    from slam_constructor_tpu_torch.parallel import blockshard

    sbm = blockshard.make_sharded_block_map(model, tiles, tiles, capacity, mesh, axis, block,
                                            scale, device="cpu")
    for i in range(poses.shape[0]):
        blockshard.insert_scan(sbm, model, poses[i], scans[i], beam)
    return host({
        "plane": blockshard.gather_value_plane(sbm, model, mesh, axis),
        "n_alloc": blockshard.allocated_per_shard(sbm, mesh, axis),
        "tables": meshlib.all_gather(sbm.band.table, mesh, axis).flatten(0, 1),
        "scores": [blockshard.score_poses(sbm, model, scans[-1], score_poses, c, mesh, axis)
                   for c in score_cfgs],
    })


# --- tasks: the sharded RBPF steps ----------------------------------------------


def _run_steps(step, state, scans, odom, draws, gather):
    out = []
    for i in range(len(draws)):
        state, idx = step(state, scans[i], odom[i], draws[i])
        out.append(host({"idx": idx, **gather(state)}))
    return out


def task_particles(mesh, axis, cfg, poses0, scans, odom, draws):
    from slam_constructor_tpu_torch.models import gmapping as tgm
    from slam_constructor_tpu_torch.parallel import particles

    st = tgm.init_state(cfg, "cpu")
    st.poses = poses0.expand(cfg.n_particles, 3).clone()
    st = particles.shard_state(st, mesh, axis)
    step = particles.make_sharded_step(cfg, mesh, axis)

    def gather(s):
        full = particles.gather_state(s, mesh, axis)
        return {"poses": full.poses, "logw": full.log_weights, "cells": full.gm.cells}

    return _run_steps(step, st, scans, odom, draws, gather)


def task_sharded_run(mesh, axis, cfg, poses0, scans, odom, draws):
    """``particles.make_sharded_run`` over the sequence (``draws`` with a
    leading T)."""
    from slam_constructor_tpu_torch.models import gmapping as tgm
    from slam_constructor_tpu_torch.parallel import particles

    st = tgm.init_state(cfg, "cpu")
    st.poses = poses0.expand(cfg.n_particles, 3).clone()
    st = particles.shard_state(st, mesh, axis)
    st, traj, neffs, all_poses, ancestors = particles.make_sharded_run(cfg, mesh, axis)(
        st, scans, odom, draws)
    return host({"traj": traj, "neffs": neffs, "all_poses": all_poses, "ancestors": ancestors})


def task_ep_cow(mesh, axis, cfg, poses0, scans, odom, draws):
    from slam_constructor_tpu_torch.parallel import ep_cow

    st = ep_cow.init_ep_state(cfg, mesh, axis, device="cpu")
    st.poses = poses0.expand(st.poses.shape[0], 3).clone()
    step = ep_cow.make_ep_step(cfg, mesh, axis)

    def gather(s):
        return {"poses": meshlib.all_gather(s.poses, mesh, axis).flatten(0, 1),
                "logw": meshlib.all_gather(s.log_weights, mesh, axis).flatten(),
                "planes": ep_cow.gather_planes(s.gm, cfg.cell_model, mesh, axis),
                "overflow": meshlib.all_gather(s.gm.overflow, mesh, axis)}

    return _run_steps(step, st, scans, odom, draws, gather)


def task_ep2d(mesh, cfg, poses0, scans, odom, draws):
    from slam_constructor_tpu_torch.parallel import ep2d

    st = ep2d.init_ep2d_state(cfg, mesh, device="cpu")
    st.poses = poses0.expand(st.poses.shape[0], 3).clone()
    step = ep2d.make_ep2d_step(cfg, mesh)

    def gather(s):
        return {"poses": meshlib.all_gather(s.poses, mesh, "pgroups").flatten(0, 1),
                "logw": meshlib.all_gather(s.log_weights, mesh, "pgroups").flatten(),
                "planes": ep2d.gather_planes(s.gm, cfg.cell_model, mesh),
                "overflow": s.gm.band.overflow}

    return _run_steps(step, st, scans, odom, draws, gather)


def task_preset(mesh, poses0, scans, odom, kw):
    """The ``distributed`` preset on the flat mesh of the whole group."""
    from slam_constructor_tpu_torch.parallel import particles
    from slam_constructor_tpu_torch.utils import config

    cfg, st, step = config.preset("distributed")(mesh=mesh, device="cpu", **kw)
    st.poses = poses0.expand(st.poses.shape[0], 3).clone()
    g = torch.Generator().manual_seed(7)
    out = []
    for i in range(len(scans)):
        st, idx = step(st, scans[i], odom[i], generator=g)
        full = particles.gather_state(st, mesh, "particles")
        out.append(host({"idx": idx, "poses": full.poses, "logw": full.log_weights}))
    return out


# --- the tests of the collectives ---------------------------------------------

pool = pool_fixture()


@pytest.mark.parametrize("d", [2, 4])
def test_collectives(pool, d):
    """psum, pmax, all_gather, the ring ppermute and the shard of a leading
    axis, against numpy, on every rank."""
    x = np.random.default_rng(d).normal(size=(d, 3, 2)).astype(np.float32)
    for rank, got in enumerate(pool.run("collectives", flat(d), "particles", x)):
        i = got["index"]
        assert got["size"] == d and i == rank % d
        np.testing.assert_allclose(got["psum"], x.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(got["pmax"], x.max(0))
        np.testing.assert_array_equal(got["gather"], x)
        np.testing.assert_array_equal(got["next"], x[(i - 1) % d])
        np.testing.assert_array_equal(got["prev"], x[(i + 1) % d])
        np.testing.assert_array_equal(got["shard"], np.arange(8).reshape(d, -1)[i])


def test_meshes_name_their_dimensions(pool):
    """The 2-D meshes: a collective over one dimension stays in its row
    or column."""
    x = np.arange(4 * 2, dtype=np.float32).reshape(4, 2)
    for axis, spec in (("bands", ((2, 2), ("pgroups", "bands"))),
                       ("chips", ((1, 4), ("hosts", "chips"))),
                       ("pgroups", ((4, 1), ("pgroups", "bands")))):
        got = pool.run("collectives", spec, axis, x)
        d = {"bands": 2, "chips": 4, "pgroups": 4}[axis]
        for g in got:
            assert g["size"] == d
            np.testing.assert_array_equal(g["psum"], x[:d].sum(0))


def test_backend_is_chosen_by_device():
    assert meshlib.backend_for("cpu") == "gloo"
    assert meshlib.backend_for("cuda") == "nccl"
    with pytest.raises(ValueError):
        meshlib.backend_for("meta")


def test_a_task_that_fails_fails_the_test():
    """A rank's exception comes back as the test's failure, and the pool
    shuts down: nothing is left running."""
    p = RankPool()
    try:
        with pytest.raises(AssertionError, match="KeyError"):
            p.run("nope", flat(2), timeout=60)
    finally:
        p.close()
    assert not any(proc.is_alive() for proc in p.procs)
