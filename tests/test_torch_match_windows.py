"""The RBPF's match windows read in place (``scoring.WindowView``,
``kernels.mc_match_windows``) against the windows cut out and against the
JAX reference's ``window_view``.

Small shapes: 4 maps of 48^2 cells at 0.2 m with random beliefs and
counts (a third of the cells unknown), 24^2 windows (and one as large as
the map), a scan of 90 beams of the cecum world, 4 rounds of 12
candidates. The windows are placed inside the map, clamped at each of its
four edges, at its four corners, and over the whole map.

Tolerances: the window's placement, its cells and its origin are exact
(the reference's arithmetic); the match in place equals the match on the
cut-out windows bit for bit (on the CPU both are the same plain ops); the
match against a ``vmap`` of the reference's within 2e-6 in pose, prob and
trace (a score summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu_torch.models import gmapping as tgm
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import scoring as tscore
from slam_constructor_tpu_torch.ops.scan import LaserScan
from slam_constructor_tpu_torch.utils import datagen

torch.set_num_threads(1)

P, SIZE, SCALE, WIN, N_BEAMS, ROUNDS, BATCH = 4, 48, 0.2, 24, 90, 4, 12
TOL = 2e-6
#: where the priors lie: (dx, dy) in map widths from the map's centre for
#: each particle; 0.6 puts a window's centre off the map, so it clamps
PLACES = {
    "inside": [(-0.1, 0.05), (0.1, -0.1), (0.0, 0.12), (-0.12, -0.05)],
    "left edge": [(-0.6, -0.1), (-0.6, 0.0), (-0.6, 0.1), (-0.6, 0.2)],
    "right edge": [(0.6, -0.1), (0.6, 0.0), (0.6, 0.1), (0.6, 0.2)],
    "bottom edge": [(-0.1, -0.6), (0.0, -0.6), (0.1, -0.6), (0.2, -0.6)],
    "top edge": [(-0.1, 0.6), (0.0, 0.6), (0.1, 0.6), (0.2, 0.6)],
    "four corners": [(-0.6, -0.6), (0.6, -0.6), (-0.6, 0.6), (0.6, 0.6)],
}
CASES = [(place, WIN) for place in PLACES] + [("inside", SIZE)]
IDS = [f"{place}, {win}^2" for place, win in CASES]


@pytest.fixture(scope="module")
def maps():
    """P maps with random beliefs and observation counts, a cecum scan,
    the matcher's config and noise: (port grid map, reference grid map,
    port scan [P, R], reference scan, config, noise f32[P, rounds, K, 3])."""
    rng = np.random.default_rng(21)
    belief = rng.uniform(0.05, 0.95, (P, SIZE, SIZE, 1)).astype(np.float32)
    weight = (rng.integers(0, 3, (P, SIZE, SIZE, 1)) * (rng.uniform(size=(P, SIZE, SIZE, 1)) > 0.3))
    cells = np.concatenate([belief, weight.astype(np.float32)], -1)
    origin = np.full((P, 2), -SIZE * SCALE / 2, np.float32)
    tgm_ = tgrid.GridMap(cells=torch.from_numpy(cells), origin=torch.from_numpy(origin), scale=SCALE)
    jgm_ = jgrid.GridMap(cells=jnp.asarray(cells), origin=jnp.asarray(origin), scale=SCALE)
    occ, w_origin, w_scale = datagen.cecum_world()
    pose = torch.tensor([0.3, -1.45, 0.7])
    from slam_constructor_tpu_torch.ops import raycast

    scan = raycast.cast_rays(occ, w_origin, w_scale, pose, datagen.default_bearings(N_BEAMS))
    tscan = LaserScan(scan.ranges.expand(P, -1), scan.bearings.expand(P, -1),
                      scan.valid.expand(P, -1))
    jscan = JScan(ranges=jnp.asarray(scan.ranges.numpy()), bearings=jnp.asarray(scan.bearings.numpy()),
                  valid=jnp.asarray(scan.valid.numpy()))
    sc = dict(reducer="overlap", window=1, stride=2)
    cfgs = (jmatch.MonteCarloConfig(sigma_xy=0.06, sigma_theta=0.03, batch=BATCH, rounds=ROUNDS,
                                    scoring=jscore.ScoringConfig(**sc, impl="gather")),
            tmatch.MonteCarloConfig(sigma_xy=0.06, sigma_theta=0.03, batch=BATCH, rounds=ROUNDS,
                                    scoring=tscore.ScoringConfig(**sc)))
    keys = jax.random.split(jax.random.PRNGKey(4), P)
    noise = np.array(jax.vmap(lambda k: jax.vmap(lambda kr: jax.random.normal(kr, (BATCH, 3)))(
        jax.random.split(k, ROUNDS)))(keys))
    return tgm_, jgm_, tscan, jscan, cfgs, keys, noise


def priors_at(place):
    offs = np.array(PLACES[place], np.float32) * SIZE * SCALE
    return offs + np.array([0.0, 0.0], np.float32), np.array([0.3, -0.2, 0.1, 0.5], np.float32)[:P]


def prior_poses(place):
    xy, th = priors_at(place)
    return np.concatenate([xy, th[:, None]], -1).astype(np.float32)


@pytest.mark.parametrize("place,win", CASES, ids=IDS)
def test_window_of_places_windows_as_the_reference(maps, place, win):
    """The window's corner, cells and origin, not cut out and then cut,
    equal the reference's ``window_view`` of each map exactly, also where
    it clamps at an edge or corner and where it covers the whole map."""
    tgm_, jgm_ = maps[:2]
    priors = prior_poses(place)
    model = tcells.BayesAvgCell()
    view = tscore.window_of(tscore.MapView.of(tgm_, model), torch.from_numpy(priors[:, :2]), win)
    assert (view.sh, view.sw) == (win, win) and view.row.dtype == torch.int64
    assert bool((view.row >= 0).all() and (view.row <= SIZE - win).all())
    assert bool((view.col >= 0).all() and (view.col <= SIZE - win).all())
    if place != "inside" and win < SIZE:  # every window meets the map's border
        at_edge = (view.row == 0) | (view.row == SIZE - win) | (view.col == 0) | (view.col == SIZE - win)
        assert bool(at_edge.all())
    cut = view.cut()
    jv = jax.vmap(lambda g, c: jscore.window_view(jscore.MapView.of(g, jcells.BayesAvgCell()), c, win))(
        jgm_, jnp.asarray(priors[:, :2]))
    np.testing.assert_array_equal(cut.occ.numpy(), np.asarray(jv.occ))
    np.testing.assert_array_equal(cut.known.numpy(), np.asarray(jv.known))
    np.testing.assert_array_equal(cut.origin.numpy(), np.asarray(jv.origin))
    np.testing.assert_array_equal(view.origin.numpy(), np.asarray(jv.origin))


@pytest.mark.parametrize("place,win", CASES, ids=IDS)
def test_match_in_place_equals_cut_out_and_reference(maps, place, win):
    """``monte_carlo_match`` on a ``WindowView`` (``mc_match_windows``'s
    twin: the windows cut out inside it) equals the match on the cut-out
    windows bit for bit, and a ``vmap`` of the reference's match on its
    ``window_view`` within 2e-6."""
    tgm_, jgm_, tscan, jscan, (jcfg, tcfg), keys, noise = maps
    priors = prior_poses(place)
    model = tcells.BayesAvgCell()
    view = tscore.window_of(tscore.MapView.of(tgm_, model), torch.from_numpy(priors[:, :2]), win)
    tp, tn = torch.from_numpy(priors), torch.from_numpy(noise)
    got = tmatch.monte_carlo_match(view, tscan, tp, cfg=tcfg, noise=tn)
    want = tmatch.monte_carlo_match(view.cut(), tscan, tp, cfg=tcfg, noise=tn)
    for a, b in ((got.pose, want.pose), (got.prob, want.prob), (got.trace, want.trace)):
        assert torch.equal(a, b)

    def one(g, prior, key):
        v = jscore.window_view(jscore.MapView.of(g, jcells.BayesAvgCell()), prior[:2], win)
        return jmatch.monte_carlo_match(v, jscan, prior, key, jcfg)

    ref = jax.jit(jax.vmap(one))(jgm_, jnp.asarray(priors), keys)
    d = got.pose.numpy().astype(np.float64) - np.asarray(ref.pose, np.float64)
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    assert np.abs(d).max() <= TOL
    np.testing.assert_allclose(got.prob.numpy(), np.asarray(ref.prob), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(ref.trace), atol=TOL, rtol=0)


def test_mc_match_windows_twin_is_cut_where_and_match(maps):
    """On the CPU ``mc_match_windows`` is its twin: ``take_window`` of
    occupancy and mask, ``where(known, occ, unknown)``, ``mc_match_ref``;
    the occupancy may be a channel of the maps' cells."""
    tgm_, _, tscan, _, (_, tcfg), _, noise = maps
    view = tscore.window_of(tscore.MapView.of(tgm_, tcells.BayesAvgCell()),
                            torch.from_numpy(prior_poses("four corners")[:, :2]), WIN)
    assert view.maps.occ.stride(-1) == 2  # channel 0 of cells [P, H, W, 2]
    pts, beam_w = tscore.prepare_scan(tscan, tcfg.scoring)
    args = (view.row, view.col, WIN, WIN, pts, beam_w, view.origin,
            torch.from_numpy(prior_poses("four corners")), torch.from_numpy(noise), SCALE, 0.5,
            0.06, 0.03, 2)
    before = kernels.launch_counts()
    got = kernels.mc_match_windows(view.maps.occ, view.maps.known, *args)
    assert kernels.launch_counts() == before  # the CPU launches nothing
    plane = torch.where(tgrid.take_window(view.maps.known, view.row, view.col, WIN, WIN),
                        tgrid.take_window(view.maps.occ, view.row, view.col, WIN, WIN), 0.5)
    want = kernels.mc_match_ref(plane, *args[4:])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    dense = kernels.mc_match_windows(view.maps.occ.contiguous(), view.maps.known, *args)
    for a, b in zip(dense, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("match_window,proposal,gate,in_place", [
    (WIN, "odom", 0.0, True), (0, "odom", 0.0, False), (WIN, "improved", 0.0, False),
    (WIN, "odom", 0.7, False),
])
def test_match_view_reads_in_place_when_only_the_match_scores(maps, match_window, proposal, gate,
                                                                in_place):
    """``gmapping.match_view``: a window read in place when a Monte-Carlo
    match alone scores it; cut out once when the improved proposal or the
    gate scores it too. With ``match_window`` 0 the whole maps' view, as it
    is, with the maps' own origin."""
    import dataclasses
    import warnings

    tgm_ = maps[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = tgm.fast_config(n_particles=P, map_size=SIZE, map_scale=SCALE, proposal=proposal)
    cfg = dataclasses.replace(cfg, match_window=match_window, min_match_prob=gate)
    view = tgm.match_view(cfg, tgm_, torch.from_numpy(prior_poses("inside")))
    assert isinstance(view, tscore.WindowView) == in_place
    win = match_window or SIZE
    assert tuple(view.occ.shape if not in_place else (P, view.sh, view.sw)) == (P, win, win)
    if match_window == 0:
        whole = tscore.MapView.of(tgm_, cfg.cell_model)
        assert isinstance(view, tscore.MapView)
        assert torch.equal(view.occ, whole.occ) and torch.equal(view.known, whole.known)
        assert torch.equal(view.origin, tgm_.origin)
