"""Row- and beam-sharded scoring (``parallel/halo.py``) and its kernel's
new mode, ``kernels.overlap_score_partial``, on the CPU.

The partial twin: D ranks' sums over a partition of the rows, divided,
give ``overlap_score`` for every reducer within 2e-6 x max(1, |s|) (the
beams are summed in another order). The sharded scores: over 2 and 4 gloo
ranks against the reference's ``halo.sharded_score_poses`` and
``beam_sharded_score_poses`` on a 2- and 4-device mesh, every reducer,
1e-5 (the reference's own sharded tests' tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscoring
from slam_constructor_tpu.parallel import halo as jhalo
from slam_constructor_tpu.utils import datagen as jdatagen
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import scoring
from slam_constructor_tpu_torch.ops.scan import LaserScan
from test_torch_ranks import flat, pool_fixture

torch.set_num_threads(1)
pool = pool_fixture()

#: (reducer, window, extent): every kernel reducer (overlap at extent 1 and
#: window 1 is the bilinear one)
REDUCERS = [("obstacle", 1, 1.0), ("max", 1, 1.0), ("mean", 2, 1.0), ("overlap", 1, 1.0),
            ("overlap", 2, 1.5)]


@functools.cache
def fixture():
    """The reference's halo fixture: a box world scanned into an 80^2 map,
    16 candidates spread across every shard boundary."""
    occ, origin, scale = jdatagen.box_world(8.0, 0.1, obstacles=4, seed=6)
    bearings = jdatagen.default_bearings(120)
    true_pose = jnp.array([0.2, 0.1, 0.3])
    s = jax.jit(jray.cast_rays, static_argnums=(2,))(occ, origin, scale, true_pose, bearings)
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 80, 80, 0.1)
    gm = jax.jit(jray.insert_scan, static_argnums=(1, 4))(gm, model, true_pose, s,
                                                           jray.BeamConfig())
    view = jscoring.MapView.of(gm, model)
    rng = np.random.default_rng(3)
    cand = (np.asarray(true_pose)[None] + rng.normal(size=(16, 3)) * [0.5, 2.0, 0.2]
            ).astype(np.float32)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tview = scoring.MapView(occ=t(view.occ), known=t(view.known), origin=t(view.origin),
                            scale=view.scale)
    tscan = LaserScan(t(s.ranges), t(s.bearings), t(s.valid))
    return view, s, cand, tview, tscan


#: the reference's scorers, jitted once a (config, mesh): eager, each
#: shard_map call traces and compiles anew
_rows = jax.jit(jhalo.sharded_score_poses, static_argnums=(3, 4))
_beams = jax.jit(jhalo.beam_sharded_score_poses, static_argnums=(3, 4))
_local = jax.jit(jscoring.score_poses, static_argnums=(3,))


def cfgs(reducer, window, extent):
    return (jscoring.ScoringConfig(reducer=reducer, window=window, overlap_extent=extent),
            scoring.ScoringConfig(reducer=reducer, window=window, overlap_extent=extent))


@pytest.mark.parametrize("red", REDUCERS, ids=lambda r: f"{r[0]}{r[1]}")
def test_partial_sums_over_row_partitions_give_the_score(red):
    _, _, cand, tview, tscan = fixture()
    _, cfg = cfgs(*red)
    prep = scoring.prepare(tview, tscan, cfg)
    poses = torch.from_numpy(cand)
    want = scoring.score_prepared(prep, poses)
    h = prep.plane.shape[0]
    need = max(kernels._partial_need(prep.reducer), 1)
    for d in (1, 2, 4, 8):
        bounds = [h * i // d for i in range(d + 1)]
        sums = torch.zeros(len(cand), 2)
        for r0, r1 in zip(bounds[:-1], bounds[1:]):
            g0, g1 = max(r0 - need, 0), min(r1 + need, h)
            sums += kernels.overlap_score_partial(
                prep.plane[g0:g1].contiguous(), g0, h, poses, prep.pts, prep.beam_w, prep.origin,
                prep.scale, prep.unknown, r0, r1, prep.reducer)
        got = sums[:, 0] / sums[:, 1].clamp(min=1e-9)
        tol = 2e-6 * torch.clamp(want.abs(), min=1.0)
        assert bool(((got - want).abs() <= tol).all()), (d, (got - want).abs().max())
        assert torch.equal(sums[:, 1], prep.beam_w.sum().expand(len(cand)))


def test_partial_refuses_a_band_without_the_rows_it_reads():
    _, _, cand, tview, tscan = fixture()
    prep = scoring.prepare(tview, tscan, scoring.ScoringConfig(reducer="mean", window=2))
    poses = torch.from_numpy(cand)
    args = (poses, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    with pytest.raises(ValueError, match="do not hold"):
        kernels.overlap_score_partial(prep.plane[19:41].contiguous(), 19, 80, *args, 20, 40,
                                      prep.reducer)
    with pytest.raises(ValueError, match="owned rows"):
        kernels.overlap_score_partial(prep.plane, 0, 80, *args, 40, 90, prep.reducer)
    whole = kernels.overlap_score_partial(prep.plane, 0, 80, *args, 0, 80, prep.reducer)
    torch.testing.assert_close(whole[:, 0] / whole[:, 1], scoring.score_prepared(prep, poses),
                               atol=2e-6, rtol=0)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("red", REDUCERS, ids=lambda r: f"{r[0]}{r[1]}")
def test_sharded_scores_match_the_reference(pool, d, red):
    view, s, cand, tview, tscan = fixture()
    jcfg, tcfg = cfgs(*red)
    m = Mesh(np.asarray(jax.devices()[:d]), ("chips",))
    want_rows = np.asarray(_rows(view, s, jnp.asarray(cand), jcfg, m))
    want_beams = np.asarray(_beams(view, s, jnp.asarray(cand), jcfg, m))
    local = np.asarray(_local(view, s, jnp.asarray(cand), jcfg))
    for got in pool.run("halo", flat(d, "chips"), "chips", tview, tscan,
                        torch.from_numpy(cand), tcfg, None):
        np.testing.assert_allclose(got["rows"], want_rows, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["beams"], want_beams, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["rows"], local, atol=1e-5, rtol=0)
