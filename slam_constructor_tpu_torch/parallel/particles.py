"""The particle axis of the RBPF over ranks (port of
``slam_constructor_tpu.parallel.particles``).

The reference shards every particle-major array of the state and jits the
unchanged ``gmapping_step``; GSPMD derives the collectives. The port has no
GSPMD, so :func:`make_sharded_step` writes them out. Rank i of D owns
particles [i P/D, (i + 1) P/D): their poses, log-weights and dense maps.
A step:

1. draws the whole step's ``Draws`` on every rank from the same key, the
   state's, which every rank holds alike (or takes them handed in), and
   keeps its particles' slice, so the sharded step proposes and matches
   what the unsharded one does;
2. matches its particles on their windows in one launch of
   ``kernels.mc_match_windows`` (K5) and inserts their scans with
   ``kernels.scan_insert`` (K3), as ``models.gmapping`` does for P;
3. normalises the log-weights across ranks
   (:func:`psum_normalize_log_weights`: a max and a sum over ranks; its
   ``deterministic=True`` takes them by the fixed-order ladder);
4. resamples: the ancestors are computed on every rank alike from the
   gathered log-weights and the shared comb offset, then each rank takes
   its new particles' maps from an all-gather of every rank's maps (the
   reference's all-to-all of map blocks). The gather runs every step, with
   the identity while Neff is healthy, as the unsharded step's
   ``index_select`` does: no host read.

The sharded log-sum-exp adds in another order than the local one, so the
log-weights agree with the unsharded step's to about 1e-6, not bit for bit
(ROADMAP Queue 3, trap k); the ancestors are the same.
"""

from __future__ import annotations

import functools

import torch

from ..models import gmapping as gm_lib
from ..ops import grid as gridlib
from ..ops import libm, resample
from ..ops.scan import LaserScan
from ..utils import determinism
from . import mesh as meshlib

Tensor = torch.Tensor


def psum_normalize_log_weights(logw: Tensor, mesh, axis: str = "particles",
                               deterministic: bool = False) -> Tensor:
    """This rank's log-weights f32[P/D] normalised over every rank's: a
    stable log-sum-exp from a max and a sum over ranks. ``deterministic``
    takes them by the ladder (``utils.determinism``): the same bits for any
    backend, at an all-gather of D floats."""
    if deterministic:
        return determinism.deterministic_normalize_log_weights(logw, mesh, axis)
    gmax = meshlib.pmax(logw.max(), mesh, axis)
    gsum = meshlib.psum(libm.sum_exp(logw, gmax), mesh, axis)
    return logw - (gmax + libm.log(gsum, inplace=True))


def sharded_neff(logw: Tensor, mesh, axis: str = "particles") -> Tensor:
    """Neff f32[] of the weights of every rank (the same on each)."""
    gmax = meshlib.pmax(logw.max(), mesh, axis)
    z = meshlib.psum(libm.exp(logw - gmax, inplace=True).sum(), mesh, axis)
    w2 = meshlib.psum(libm.exp(2.0 * (logw - gmax), inplace=True).sum(), mesh, axis)
    return z * z / w2


def shard_state(state: gm_lib.GMappingState, mesh, axis: str = "particles"):
    """This rank's particles of a whole dense state; the key and the step
    counter are shared."""
    take = lambda t: meshlib.shard(t, mesh, axis).clone()  # noqa: E731
    gm = gridlib.GridMap(cells=take(state.gm.cells), origin=take(state.gm.origin),
                         scale=state.gm.scale)
    return gm_lib.GMappingState(gm=gm, poses=take(state.poses),
                                log_weights=take(state.log_weights), key=state.key.clone(),
                                step=state.step.clone())


def gather_state(state: gm_lib.GMappingState, mesh, axis: str = "particles"):
    """The whole state from every rank's particles (on every rank)."""
    cat = lambda t: meshlib.all_gather(t, mesh, axis).flatten(0, 1)  # noqa: E731
    gm = gridlib.GridMap(cells=cat(state.gm.cells), origin=cat(state.gm.origin),
                         scale=state.gm.scale)
    return gm_lib.GMappingState(gm=gm, poses=cat(state.poses),
                                log_weights=cat(state.log_weights), key=state.key,
                                step=state.step)


def sharded_ops(cfg: gm_lib.GMappingConfig, match, insert, take, mesh,
                axis: str) -> gm_lib.StepOps:
    """The step's parts (``gmapping.StepOps``) for this rank's share of the
    particles over ``axis``: the weights normalised and the particles
    gathered over it."""
    return gm_lib.StepOps(
        match=match, insert=insert, take=take,
        span=meshlib.shard_bounds(cfg.n_particles, mesh, axis),
        normalize=lambda logw: psum_normalize_log_weights(logw, mesh, axis),
        gather=lambda x: meshlib.all_gather(x, mesh, axis).flatten(0, 1))


def make_sharded_step(cfg: gm_lib.GMappingConfig, mesh, axis: str = "particles"):
    """The RBPF step over this rank's particles: ``step(state, scan,
    odom_delta, draws=None) -> (state, ancestors i64[P])``. ``state``
    holds the rank's P/D particles (:func:`shard_state`) and the key every
    rank holds alike; ``draws`` the whole step's (every rank's the same),
    or the key draws them, the same split on every rank. Dense maps only: the
    copy-on-write pools over ranks are ``parallel.ep_cow``."""
    if cfg.map_storage != "dense":
        raise ValueError("make_sharded_step shards dense maps; copy-on-write pools over ranks "
                         "are parallel.ep_cow")
    lo, hi = meshlib.shard_bounds(cfg.n_particles, mesh, axis)

    def take(gm: gridlib.GridMap, idx: Tensor, did) -> gridlib.GridMap:
        anc = idx[lo:hi]
        cat = lambda t: meshlib.all_gather(t, mesh, axis).flatten(0, 1)  # noqa: E731
        return gridlib.GridMap(cells=cat(gm.cells).index_select(0, anc),
                               origin=cat(gm.origin).index_select(0, anc), scale=gm.scale)

    ops = sharded_ops(cfg, functools.partial(gm_lib.match_dense, cfg),
                      functools.partial(gm_lib.insert_dense, cfg), take, mesh, axis)
    return functools.partial(gm_lib.rbpf_step, cfg, ops)


def make_sharded_run(cfg: gm_lib.GMappingConfig, mesh, axis: str = "particles"):
    """A whole sequence over the sharded step: ``run(state, scans [T, R],
    odom f32[T, 3], draws=None)`` -> (state, best-particle
    pose f32[T, 3], Neff f32[T], every particle's pose f32[T, P, 3],
    ancestors i64[T, P]), the outputs of ``gmapping.run_sequence`` (the
    last four the same on every rank)."""
    step = make_sharded_step(cfg, mesh, axis)

    def run(state, scans: LaserScan, odom: Tensor, draws: gm_lib.Draws | None = None):
        traj, neffs, all_poses, ancestors = [], [], [], []
        for i in range(len(scans)):
            state, anc = step(state, scans[i], odom[i], None if draws is None else draws[i])
            poses = meshlib.all_gather(state.poses, mesh, axis).flatten(0, 1)
            logw = meshlib.all_gather(state.log_weights, mesh, axis).flatten()
            traj.append(poses[torch.argmax(logw)])
            neffs.append(resample.effective_sample_size(logw))
            all_poses.append(poses)
            ancestors.append(anc)
        return (state, torch.stack(traj), torch.stack(neffs), torch.stack(all_poses),
                torch.stack(ancestors))

    return run
