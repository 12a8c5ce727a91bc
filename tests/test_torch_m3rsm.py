"""Port parity of M3RSM: the pyramid, the level score, the branch and bound.

The same numpy inputs go to the JAX reference (on the CPU, jitted: its
gather path) and to the port (on the CPU: the kernels' plain twins).

Tolerances:
- the pyramid, its regional refresh and the search's thetas: bit for bit (a
  max is exact; the thetas are the f32 values of the reference's jitted
  ``jnp.linspace``);
- a level's scores: 2e-6, the order of the beam sums (the bound the
  reference holds its Pallas path to);
- a match: the pose within 1e-5 and the probability within 2e-6 (the same
  winner at every level; the refine's scores differ in sum order only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import m3rsm as jm3
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import m3rsm as tm3
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.ops import scoring as tscore

torch.set_num_threads(1)

OVERLAP = dict(reducer="overlap", stride=2)

# the fixtures' maps and scans, made by the reference (jitted: eagerly its
# insert takes seconds)
_cast = jax.jit(jray.cast_rays, static_argnums=2)
_insert = jax.jit(jray.insert_scan, static_argnums=(1, 4))


def _tview(jview):
    return tscore.MapView(
        occ=torch.from_numpy(np.array(jview.occ)), known=torch.from_numpy(np.array(jview.known)),
        origin=torch.from_numpy(np.array(jview.origin)), scale=float(jview.scale))


def _tscan(js):
    return tscan.LaserScan(torch.from_numpy(np.array(js.ranges)),
                           torch.from_numpy(np.array(js.bearings)),
                           torch.from_numpy(np.array(js.valid)))


def _tcfg(jcfg):
    """The port's config with the reference's values."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    sc = jcfg.scoring
    fields["scoring"] = tscore.ScoringConfig(reducer=sc.reducer, window=sc.window,
                                             unknown_prob=sc.unknown_prob, stride=sc.stride,
                                             overlap_extent=sc.overlap_extent)
    return tm3.M3RSMConfig(**fields)


@pytest.fixture(scope="module")
def setup():
    """``tests/test_m3rsm.py``'s fixture: a box world, two scans inserted
    into an 80^2 map at 0.1 m, a third scan from the true pose."""
    occ, origin, scale = jdata.box_world(8.0, 0.1, obstacles=5, seed=4)
    bearings = jdata.default_bearings(180)
    true_pose = jnp.array([0.4, -0.3, 0.2])
    s = _cast(occ, origin, scale, true_pose, bearings)
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 80, 80, 0.1)
    for dp in [jnp.zeros(3), jnp.array([0.15, 0.1, 0.0])]:
        p = true_pose + dp
        sp = _cast(occ, origin, scale, p, bearings)
        gm = _insert(gm, model, p, sp, jray.BeamConfig(wall_blur=True))
    return jscore.MapView.of(gm, model), s, true_pose


@pytest.fixture(scope="module")
def wide():
    """``test_m3rsm_window_equals_full``'s scene: a 160^2 map, 120 beams."""
    occ, origin, scale = jdata.box_world(6.0, 0.1, obstacles=4, seed=7)
    true_pose = jnp.array([0.3, -0.2, 0.15])
    s = _cast(occ, origin, scale, true_pose, jdata.default_bearings(120))
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 160, 160, 0.1)
    gm = _insert(gm, model, true_pose, s, jray.BeamConfig(wall_blur=True))
    return jscore.MapView.of(gm, model), s, true_pose


# --- the thetas ---------------------------------------------------------------


@pytest.mark.parametrize("half,n", [(0.2, 9), (0.3, 7), (0.3, 17), (0.35, 15), (0.2, 5),
                                    (0.2, 7), (0.0, 1), (0.0, 3)])
def test_thetas_equal_reference_linspace_bit_for_bit(half, n):
    """The configs of the slice (viny_m3rsm 0.2 / 9, the loop matcher 0.3 /
    7, the default 0.3 / 17) and of the tests. Held to ``jnp.linspace`` as
    the reference's jitted step computes it; eagerly XLA's CPU backend
    contracts the sum into an FMA and rounds otherwise (trap m)."""
    want = np.asarray(jax.jit(lambda: jnp.linspace(-half, half, n))())
    got = np.array(tm3.thetas(half, n), np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# --- the pyramid --------------------------------------------------------------


def _random_view(rng, shape):
    occ = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    known = rng.uniform(0.0, 1.0, shape) < 0.7
    return occ, known


@pytest.mark.parametrize("shape,levels", [((100, 90), 5), ((80, 80), 3), ((31, 17), 4),
                                          ((64, 64), 0), ((3, 48, 40), 3)])
def test_pyramid_twin_equals_build_pyramid(shape, levels):
    """Odd and unaligned sides (100 x 90 at 5 levels pads at every level),
    and M maps at once, against the reference map by map."""
    occ, known = _random_view(np.random.default_rng(sum(shape) + levels), shape)
    got = kernels.m3rsm_pyramid(torch.from_numpy(occ), torch.from_numpy(known), levels, 0.5)
    assert len(got) == levels + 1
    for m in range(shape[0] if len(shape) == 3 else 1):
        o, k = (occ[m], known[m]) if len(shape) == 3 else (occ, known)
        view = jscore.MapView(occ=jnp.asarray(o), known=jnp.asarray(k), origin=jnp.zeros(2),
                              scale=0.1)
        want = jax.jit(lambda v: jm3.build_pyramid(v, levels, 0.5))(view)
        for lvl, (a, b) in enumerate(zip(got, want)):
            a = a[m] if len(shape) == 3 else a
            assert a.shape == b.shape, lvl
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pyramid_of_a_map_reads_its_occupancy_channel(setup):
    """The Bayes cell's occupancy is a channel of the map's cells (stride
    2): the twin and the reference agree on the fixture's map."""
    jview, _, _ = setup
    view = _tview(jview)
    cells = torch.stack([view.occ, torch.zeros_like(view.occ)], dim=-1)
    got = tm3.build_pyramid(dataclasses.replace(view, occ=cells[..., 0]), 3, 0.5)
    want = jm3.build_pyramid(jview, 3, 0.5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _update_case(h, levels, edit, center, size):
    base_occ = np.full((h, h), 0.2, np.float32)
    known = np.ones((h, h), bool)
    planes = jm3.build_pyramid(jscore.MapView(occ=jnp.asarray(base_occ), known=jnp.asarray(known),
                                              origin=jnp.zeros(2), scale=0.1), levels, 0.5)
    occ2 = base_occ.copy()
    occ2[edit] = 0.95
    jview2 = jscore.MapView(occ=jnp.asarray(occ2), known=jnp.asarray(known), origin=jnp.zeros(2),
                            scale=0.1)
    want = jax.jit(lambda pl, v, c: jm3.update_pyramid(pl, v, 0.5, c, size=size))(
        planes, jview2, jnp.asarray(center, jnp.int32))
    tplanes = tuple(torch.from_numpy(np.array(p)) for p in planes)
    view2 = tscore.MapView(occ=torch.from_numpy(occ2), known=torch.from_numpy(known),
                           origin=torch.zeros(2), scale=0.1)
    return tplanes, view2, want


@pytest.mark.parametrize("case", ["worst_alignment", "patch", "corner", "far_edge"])
def test_update_pyramid_equals_reference(case):
    """The worst-case alignment of ``tests/test_m3rsm.py:179`` (start = 7
    mod 8), the 20 x 20 patch of ``test_update_pyramid_matches_rebuild``,
    and regions clipped at the map's first and last corner; bit for bit,
    and equal to a rebuild."""
    levels = 3
    size = jm3.pyramid_refresh_size(16, levels, 64)
    h, edit, center = {
        "worst_alignment": (64, np.s_[27:43, 27:43], (35, 35)),
        "patch": (80, np.s_[40:60, 50:70], (50, 60)),
        "corner": (64, np.s_[0:10, 0:12], (3, 2)),
        "far_edge": (64, np.s_[55:64, 40:64], (62, 63)),
    }[case]
    if case == "patch":
        size = 48
    planes, view2, want = _update_case(h, levels, edit, center, size)
    before = [p.clone() for p in planes]
    got = tm3.update_pyramid(planes, view2, 0.5, torch.tensor(center), size)
    rebuilt = tm3.build_pyramid(view2, levels, 0.5)
    for a, b, c, p, q in zip(got, want, rebuilt, planes, before):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c.numpy())
        assert torch.equal(p, q)  # the planes handed in stay as they were


def test_update_pyramid_gate_and_misaligned():
    """A gate at 0 leaves the planes as they were (the reference's
    ``lax.cond(q > 0, ...)``); a misaligned size raises as the reference's."""
    planes, view2, _ = _update_case(64, 3, np.s_[27:43, 27:43], (35, 35), 32)
    got = tm3.update_pyramid(planes, view2, 0.5, torch.tensor([35, 35]), 32,
                             gate=torch.tensor(0.0))
    for a, b in zip(got, planes):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tm3.update_pyramid(planes, view2, 0.5, torch.tensor([35, 35]), 36)


# --- a level's scores ---------------------------------------------------------


@pytest.mark.parametrize("corner", [(0, 0), (0, 64), (64, 0), (64, 64), (32, 48)])
def test_score_level_twin_matches_reference(corner):
    """Levels 0-4 of a 128^2 map's pyramid, a 64^2 window clamped at each
    edge and corner of the map and one inside, endpoint cells and rects
    that reach off the window; the reference scores its window cut out."""
    rng = np.random.default_rng(corner[0] * 7 + corner[1])
    occ, known = _random_view(rng, (128, 128))
    jview = jscore.MapView(occ=jnp.asarray(occ), known=jnp.asarray(known), origin=jnp.zeros(2),
                           scale=0.1)
    jplanes = jm3.build_pyramid(jview, 4, 0.5)
    tplanes = kernels.m3rsm_pyramid(torch.from_numpy(occ), torch.from_numpy(known), 4, 0.5)
    n_t, r, k, s = 5, 90, 40, 64
    c0 = rng.integers(-8, s + 8, (n_t, r, 2)).astype(np.int32)
    cands = np.stack([rng.integers(0, n_t, k), rng.integers(-20, 20, k),
                      rng.integers(-20, 20, k)], -1).astype(np.int32)
    mask = (rng.uniform(0, 1, r) * (np.arange(r) % 2 == 0)).astype(np.float32)
    for level in range(5):
        sl = s >> level
        win = jax.lax.dynamic_slice(jplanes[level], (corner[0] >> level, corner[1] >> level),
                                    (sl, sl))
        want = np.asarray(jax.jit(lambda p, a, b, m: jm3._score_level(p, a, b, level, m, 0.5))(
            win, c0, cands, mask))
        got = kernels.m3rsm_score_level(
            tplanes[level][None].contiguous(), torch.tensor([corner], dtype=torch.int32), level,
            sl, sl, torch.from_numpy(c0)[None], torch.from_numpy(cands)[None],
            torch.from_numpy(mask)[None], 0.5)
        assert got.shape == (1, k)
        np.testing.assert_allclose(got[0].numpy(), want, atol=2e-6, rtol=0)
    zeros = kernels.m3rsm_score_level(
        tplanes[0][None].contiguous(), torch.tensor([corner], dtype=torch.int32), 0, s, s,
        torch.from_numpy(c0)[None], torch.from_numpy(cands)[None], torch.zeros(1, r), 0.5)
    assert not bool(zeros.any())  # a mask of zeros scores 0, as max(sum, 1e-9) gives


# --- the match ----------------------------------------------------------------


def _both(jview, js, init, jcfg, point_weights=None):
    want = jax.jit(lambda v, s, p, w: jm3.m3rsm_match(v, s, p, None, jcfg, w))(
        jview, js, init, point_weights)
    got = tm3.m3rsm_match(_tview(jview), _tscan(js), torch.from_numpy(np.array(init)), None,
                          _tcfg(jcfg),
                          None if point_weights is None else torch.from_numpy(
                              np.array(point_weights)))
    return got, want


def _assert_match(got, want):
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(got.prob), float(want.prob), atol=2e-6, rtol=0)


@pytest.mark.parametrize("case", ["large_displacement", "small", "no_refine", "weights"])
def test_m3rsm_match_matches_reference(setup, case):
    """``tests/test_m3rsm.py``'s matches with the overlap reducer (the
    port's scorer): a displacement far outside a local matcher's basin
    (4 levels, 15 thetas), a small search (3 levels, 5 thetas), the raw
    cell-resolution result, and beam weights."""
    jview, s, true_pose = setup
    init, weights = true_pose + jnp.array([0.2, -0.15, 0.05]), None
    if case == "large_displacement":
        init = true_pose + jnp.array([0.9, -0.8, 0.25])
        jcfg = jm3.M3RSMConfig(half_x=1.2, half_y=1.2, half_theta=0.35, n_theta=15,
                               beam_width=192, levels=4,
                               scoring=jscore.ScoringConfig(**OVERLAP))
    else:
        jcfg = jm3.M3RSMConfig(half_x=0.4, half_y=0.4, n_theta=5, levels=3, beam_width=64,
                               refine_iterations=0 if case == "no_refine" else 8,
                               scoring=jscore.ScoringConfig(**OVERLAP))
    if case == "weights":
        weights = jnp.asarray(np.random.default_rng(3).uniform(0.2, 1.0, 180).astype(np.float32))
    got, want = _both(jview, s, init, jcfg, weights)
    _assert_match(got, want)
    if case == "large_displacement":
        err = got.pose.numpy() - np.asarray(true_pose)
        assert abs(err[0]) <= 0.15 and abs(err[1]) <= 0.15 and abs(err[2]) <= 0.06


def test_m3rsm_window_matches_reference(wide):
    """A 128-cell window (4 levels) around a centred prior and one clamped
    at the map's edge, against the reference; and the pose of the match over
    the whole planes where the scan stays inside the window. The window's
    origin is one fused multiply-add in the jitted reference, so an
    endpoint's last bit, and the score's, may part from the whole planes'
    there too: each score is held to the reference's own."""
    jview, s, true_pose = wide
    base = jm3.M3RSMConfig(half_x=0.5, half_y=0.5, half_theta=0.2, n_theta=7, levels=4,
                           beam_width=64, scoring=jscore.ScoringConfig(**OVERLAP))
    for init in (true_pose + jnp.array([0.2, -0.15, 0.1]),
                 true_pose + jnp.array([-0.4, 0.3, -0.1])):
        got, want = _both(jview, s, init, dataclasses.replace(base, window=128))
        _assert_match(got, want)
        full, want_full = _both(jview, s, init, base)
        _assert_match(full, want_full)
        assert torch.equal(got.pose, full.pose)


def test_m3rsm_match_many_equals_single_calls():
    """``tests/test_m3rsm.py``'s many-to-many case: three requests against
    one 160^2 map, together equal to three single calls bit for bit, and
    to the reference's ``m3rsm_match_many``."""
    occ, origin, scale = jdata.cecum_world()
    bearings = jdata.default_bearings(90)
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 160, 160, 0.1)
    build_pose = jnp.array([0.0, -1.5, 0.0])
    gm = _insert(gm, model, build_pose, _cast(occ, origin, scale, build_pose, bearings),
                 jray.BeamConfig())
    jview = jscore.MapView.of(gm, model)
    jcfg = jm3.M3RSMConfig(half_x=0.5, half_y=0.5, half_theta=0.2, n_theta=9, levels=3,
                           beam_width=64, scoring=jscore.ScoringConfig(**OVERLAP))
    true = jnp.stack([build_pose, build_pose + jnp.array([0.3, 0.0, 0.1]),
                      build_pose + jnp.array([-0.2, 0.1, -0.05])])
    scans = jax.vmap(lambda p: _cast(occ, origin, scale, p, bearings))(true)
    inits = true + jnp.array([0.15, -0.1, 0.05])
    want = jax.jit(lambda sc, ip: jm3.m3rsm_match_many(jview, sc, ip, jcfg))(scans, inits)
    view, cfg = _tview(jview), _tcfg(jcfg)
    tscans, tinits = _tscan(scans), torch.from_numpy(np.array(inits))
    many = tm3.m3rsm_match_many(view, tscans, tinits, cfg)
    assert many.pose.shape == (3, 3) and many.prob.shape == (3,)
    for b in range(3):
        one = tm3.m3rsm_match(view, tscans[b], tinits[b], None, cfg)
        assert torch.equal(many.pose[b], one.pose) and torch.equal(many.prob[b], one.prob)
    np.testing.assert_allclose(many.pose.numpy(), np.asarray(want.pose), atol=1e-5, rtol=0)
    np.testing.assert_allclose(many.prob.numpy(), np.asarray(want.prob), atol=2e-6, rtol=0)


def test_m3rsm_match_over_m_maps_equals_single_calls(setup):
    """Three maps with a request each (the loop closer's form) equal three
    single calls, each against its own map, bit for bit."""
    jview, s, true_pose = setup
    view = _tview(jview)
    cfg = _tcfg(jm3.M3RSMConfig(half_x=0.4, half_y=0.4, n_theta=5, levels=3, beam_width=64,
                                scoring=jscore.ScoringConfig(**OVERLAP)))
    occs = torch.stack([view.occ, view.occ.flip(0), view.occ.flip(1)])
    known = torch.stack([view.known, view.known.flip(0), view.known.flip(1)])
    origins = view.origin + torch.tensor([[0.0, 0.0], [0.1, 0.0], [0.0, -0.2]])
    maps = tscore.MapView(occ=occs, known=known, origin=origins, scale=view.scale)
    scan = _tscan(s)
    scans = tscan.LaserScan(*(a.expand(3, -1) for a in (scan.ranges, scan.bearings, scan.valid)))
    inits = torch.from_numpy(np.array(true_pose)) + torch.tensor(
        [[0.2, -0.15, 0.05], [0.0, 0.1, 0.0], [-0.1, 0.0, 0.1]])
    res = tm3.m3rsm_match(maps, scans, inits, None, cfg)
    for m in range(3):
        one = tm3.m3rsm_match(tscore.MapView(occs[m], known[m], origins[m], view.scale), scan,
                              inits[m], None, cfg)
        np.testing.assert_array_equal(res.pose[m].numpy(), one.pose.numpy())
        np.testing.assert_array_equal(res.prob[m].numpy(), one.prob.numpy())


def test_m3rsm_unported_scoring_and_stale_pyramid_raise(setup):
    """The default scoring (the obstacle reducer, which the port once
    refused) refines as the reference does: the same pose within 1e-5 and
    probability within 2e-6; a pyramid of another shape is refused, as the
    reference refuses it."""
    jview, s, true_pose = setup
    view, scan, init = _tview(jview), _tscan(s), torch.from_numpy(np.array(true_pose))
    start = init + torch.tensor([0.12, -0.08, 0.05])
    jcfg = jm3.M3RSMConfig(n_theta=3, levels=3)
    want = jax.jit(lambda v, sc, p: jm3.m3rsm_match(v, sc, p, None, jcfg))(
        jview, s, jnp.asarray(start.numpy()))
    got = tm3.m3rsm_match(view, scan, start, None, _tcfg(jcfg))
    assert _tcfg(jcfg).scoring.reducer == "obstacle"
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5)
    np.testing.assert_allclose(float(got.prob), float(want.prob), atol=2e-6)
    cfg = tm3.M3RSMConfig(n_theta=3, levels=3, beam_width=32,
                          scoring=tscore.ScoringConfig(**OVERLAP))
    wrong = tm3.build_pyramid(tscore.MapView(occ=torch.zeros(64, 64),
                                             known=torch.zeros(64, 64, dtype=torch.bool),
                                             origin=view.origin, scale=view.scale), 3, 0.5)
    with pytest.raises(ValueError, match="shape"):
        tm3.m3rsm_match(view, scan, init, None, cfg, pyramid=wrong)
    assert tmatch.MATCHERS["m3rsm"] == (tm3.M3RSMConfig, tm3.m3rsm_match)
