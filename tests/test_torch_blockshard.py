"""The block-pool map sharded by tile rows (``parallel/blockshard.py``)
over 2 and 4 gloo ranks: three scans inserted into the bands give the
unsharded port tiled map's value plane (1e-6) and the reference's band
tables and allocation counts exactly; the scores on the bands (every
reducer, halo rows swapped, ``kernels.overlap_score_partial``) give the
unsharded map's scores and the reference's sharded ones (1e-5)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscoring
from slam_constructor_tpu.parallel import blockshard as jbs
from slam_constructor_tpu.utils import datagen as jdatagen
from slam_constructor_tpu_torch.ops import blockmap, cells, raycast, scoring
from slam_constructor_tpu_torch.ops.scan import LaserScan
from test_torch_ranks import flat, pool_fixture

torch.set_num_threads(1)
pool = pool_fixture()

TILES, BLOCK, SCALE, ORIGIN = 8, 16, 0.1, (-6.4, -6.4)
REDUCERS = [("obstacle", 1, 1.0), ("max", 1, 1.0), ("mean", 2, 1.0), ("overlap", 1, 1.0),
            ("overlap", 2, 1.5)]


@functools.cache
def scans():
    """The reference's blockshard fixture: three scans of a box world."""
    occ, origin, scale = jdatagen.box_world(8.0, 0.1, obstacles=4, seed=7)
    bearings = jdatagen.default_bearings(90)
    cast = jax.jit(jray.cast_rays, static_argnums=(2,))
    poses = [jnp.array([0.3 * i - 0.3, 0.2 * i, 0.4 * i]) for i in range(3)]
    js = [cast(occ, origin, scale, p, bearings) for p in poses]
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tp = torch.stack([t(p) for p in poses]).to(torch.float32)
    ts = LaserScan(*(torch.stack([t(getattr(s, f)) for s in js])
                     for f in ("ranges", "bearings", "valid")))
    cand = (np.asarray(poses[-1])[None] + np.random.default_rng(9).normal(size=(16, 3))
            * [0.4, 2.0, 0.2]).astype(np.float32)
    return poses, js, tp, ts, cand


@functools.cache
def unsharded():
    """The port's tiled map with the three scans, its view."""
    _, _, tp, ts, _ = scans()
    model = cells.BayesAvgCell()
    bm = blockmap.make_block_map(model, TILES, TILES, 64, BLOCK, SCALE, ORIGIN, device="cpu")
    for i in range(3):
        blockmap.insert_scan(bm, model, tp[i], ts[i], raycast.BeamConfig())
    gm = blockmap.extract_window(bm, model, torch.zeros(2), TILES, TILES)
    return bm, scoring.MapView.of(gm, model)


@functools.cache
def reference(d):
    poses, js, *_ = scans()
    model = jcells.BayesAvgCell()
    m = Mesh(np.asarray(jax.devices()[:d]), ("chips",))
    sbm = jbs.make_sharded_block_map(model, TILES, TILES, 32, d, BLOCK, SCALE, ORIGIN)
    insert = jax.jit(lambda st, p, s: jbs.insert_scan(st, model, p, s, jray.BeamConfig(), m))
    for p, s in zip(poses, js):
        sbm = insert(sbm, p, s)
    return sbm, m, model


@pytest.mark.parametrize("d", [2, 4])
def test_blockshard_matches_unsharded_and_reference(pool, d):
    poses, js, tp, ts, cand = scans()
    score_cfgs = [scoring.ScoringConfig(reducer=r, window=w, overlap_extent=e)
                  for r, w, e in REDUCERS]
    got = pool.run("blockshard", flat(d, "chips"), "chips", cells.BayesAvgCell(), TILES, 32,
                   BLOCK, SCALE, tp, ts, raycast.BeamConfig(), torch.from_numpy(cand),
                   score_cfgs)
    bm, view = unsharded()
    want_plane = torch.where(view.known, view.occ, 0.5).numpy()
    jsbm, m, jmodel = reference(d)
    for g in got:
        np.testing.assert_allclose(g["plane"], want_plane, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(g["tables"], np.asarray(jsbm.table))
        np.testing.assert_array_equal(g["n_alloc"], np.asarray(jsbm.n_alloc))
        assert int(g["n_alloc"].sum()) == int(bm.n_alloc)
        for (r, w, e), cfg, score in zip(REDUCERS, score_cfgs, g["scores"]):
            local = scoring.score_poses(view, ts[-1], torch.from_numpy(cand), cfg).numpy()
            np.testing.assert_allclose(score, local, atol=1e-5, rtol=0)
            jcfg = jscoring.ScoringConfig(reducer=r, window=w, overlap_extent=e, impl="gather")
            want = jax.jit(lambda st, sc, c, jcfg=jcfg: jbs.score_poses(st, jmodel, sc, c, jcfg, m)
                           )(jsbm, js[-1], jnp.asarray(cand))
            np.testing.assert_allclose(score, np.asarray(want), atol=1e-5, rtol=0)
