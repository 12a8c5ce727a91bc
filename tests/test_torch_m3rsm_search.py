"""The whole M3RSM match in one call (``kernels.m3rsm_search``) on the CPU,
where it runs its plain twin ``kernels.m3rsm_search_ref``.

- The twin equals, bit for bit, the match composed as the port composed it
  before the match became one kernel: one level score a level, the stable
  sort, the gather and the children in PyTorch, then
  ``matchers.hill_climbing_match`` on the window cut out.
- It holds the JAX reference's ``m3rsm_match`` to the tolerances of
  ``tests/test_torch_m3rsm.py`` (the pose within 1e-5, the probability
  within 2e-6: the same winner at every level, the refine's scores differ in
  sum order only), with one request, B requests on one map and M maps,
  windows 0 and > 0, refine 0 and 8 rounds.
- The kernel's selection, a rank count over order keys, in its plain form
  (``kernels.m3rsm_ranks_ref``) equals ``torch.sort(descending=True,
  stable=True)``'s order on scores with ties, NaN, +-0 and infinities.
- The pyramid refresh's twin returns new planes equal to the reference's
  ``update_pyramid`` bit for bit and leaves its inputs as they were, a gate
  at 0 included.
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
from slam_constructor_tpu_torch.ops import grid as gridlib
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import m3rsm as tm3
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.ops import scoring as tscore
from slam_constructor_tpu_torch.ops.geometry import wrap_angle

torch.set_num_threads(1)

OVERLAP = dict(reducer="overlap", stride=2)
N_REQ = 3

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
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    sc = jcfg.scoring
    fields["scoring"] = tscore.ScoringConfig(reducer=sc.reducer, window=sc.window,
                                             unknown_prob=sc.unknown_prob, stride=sc.stride,
                                             overlap_extent=sc.overlap_extent)
    return tm3.M3RSMConfig(**fields)


@pytest.fixture(scope="module")
def scene():
    """An 80^2 map at 0.1 m of a box world with two scans inserted (the
    fixture of ``tests/test_m3rsm.py``), three more maps made from it
    (flipped, shifted origins), and three scans from poses near the truth,
    with beam weights."""
    occ, origin, scale = jdata.box_world(8.0, 0.1, obstacles=5, seed=4)
    bearings = jdata.default_bearings(180)
    true_pose = jnp.array([0.4, -0.3, 0.2])
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 80, 80, 0.1)
    for dp in [jnp.zeros(3), jnp.array([0.15, 0.1, 0.0])]:
        p = true_pose + dp
        gm = _insert(gm, model, p, _cast(occ, origin, scale, p, bearings),
                     jray.BeamConfig(wall_blur=True))
    jview = jscore.MapView.of(gm, model)
    true = jnp.stack([true_pose, true_pose + jnp.array([0.1, 0.05, -0.05]),
                      true_pose + jnp.array([-0.1, 0.1, 0.08])])
    scans = jax.vmap(lambda p: _cast(occ, origin, scale, p, bearings))(true)
    inits = true + jnp.array([[0.2, -0.15, 0.05], [-0.1, 0.2, 0.1], [0.15, 0.1, -0.08]])
    weights = jnp.asarray(np.random.default_rng(3).uniform(0.2, 1.0, (N_REQ, 180)),
                          jnp.float32)
    flips = [jview.occ, jview.occ[::-1], jview.occ[:, ::-1]]
    knowns = [jview.known, jview.known[::-1], jview.known[:, ::-1]]
    jmaps = jscore.MapView(occ=jnp.stack(flips), known=jnp.stack(knowns),
                           origin=jview.origin + jnp.array([[0.0, 0.0], [0.1, 0.0], [0.0, -0.2]]),
                           scale=jview.scale)
    return jview, jmaps, scans, inits, weights


def _jcfg(window, refine):
    return jm3.M3RSMConfig(half_x=0.4, half_y=0.4, half_theta=0.25, n_theta=7, levels=3,
                           beam_width=24, window=window, refine_iterations=refine,
                           scoring=jscore.ScoringConfig(**OVERLAP))


def _composition(view, scan, init_pose, cfg, point_weights=None):
    """``m3rsm_match`` as the port composed it before the whole match was
    one call: a level score a level, the stable sort, the gather and the
    children in PyTorch, then ``matchers.hill_climbing_match`` on the
    window cut out."""
    ucfg = cfg.scoring
    occ = view.occ
    single = init_pose.dim() == 1
    poses = init_pose.reshape(-1, 3)
    n_b = poses.shape[0]
    pyramid = tm3.build_pyramid(view, cfg.levels, ucfg.unknown_prob)
    consts = tm3.search_constants(cfg, view.scale, poses.device)
    h0, w0 = occ.shape[-2:]
    step_top = 1 << cfg.levels
    origin = view.origin.expand(n_b, 2)
    if cfg.window > 0:
        s = (min(cfg.window, h0, w0) // step_top) * step_top
        rel = (poses[:, :2] - origin) / torch.full_like(origin, view.scale)
        cell = torch.floor(rel).to(torch.int32)
        c0w = torch.clamp(cell[:, 0] - s // 2, 0, w0 - s) // step_top * step_top
        r0w = torch.clamp(cell[:, 1] - s // 2, 0, h0 - s) // step_top * step_top
        corner = torch.stack([r0w, c0w], dim=-1)
        origin = origin + torch.stack([c0w, r0w], dim=-1).to(torch.float32) * view.scale
        maps = view if occ.dim() == 3 else tscore.MapView(
            occ=occ.expand(n_b, h0, w0), known=view.known.expand(n_b, h0, w0),
            origin=origin, scale=view.scale)

        def take(p):
            return gridlib.take_window(p, r0w.long(), c0w.long(), s, s)

        refine_view = tscore.MapView(occ=take(maps.occ), known=take(maps.known), origin=origin,
                                     scale=view.scale)
        sides = [(s >> lvl, s >> lvl) for lvl in range(cfg.levels + 1)]
    else:
        corner = torch.zeros((n_b, 2), dtype=torch.int32)
        refine_view = view
        if occ.dim() == 2 and not single:
            refine_view = tscore.MapView(occ=occ.expand(n_b, h0, w0),
                                         known=view.known.expand(n_b, h0, w0),
                                         origin=origin, scale=view.scale)
        sides = [tuple(p.shape[-2:]) for p in pyramid]
    planes = [p if p.dim() == 3 else p[None] for p in pyramid]
    th = consts["thetas"]
    scans = scan if not single else tscan.LaserScan(
        scan.ranges[None], scan.bearings[None], scan.valid[None])
    pts = tscan.scan_points(scans)
    ang = poses[:, 2:3] + th
    c, s_ = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    px, py = pts[:, None, :, 0], pts[:, None, :, 1]
    ex = (poses[:, 0, None, None] + c * px) - s_ * py
    ey = (poses[:, 1, None, None] + s_ * px) + c * py
    scale_t = torch.full_like(ex, view.scale)
    rel_x = (ex - origin[:, 0, None, None]) / scale_t
    rel_y = (ey - origin[:, 1, None, None]) / scale_t
    c0 = torch.stack([torch.floor(rel_y).to(torch.int32), torch.floor(rel_x).to(torch.int32)],
                     dim=-1).contiguous()
    mask = tscan.subsample_mask(scans, ucfg.stride).to(torch.float32)
    if point_weights is not None:
        mask = mask * point_weights.reshape(n_b, -1)

    def score(level, cands):
        return kernels.m3rsm_score_level(
            planes[level], corner, level, *sides[level], c0, cands, mask.contiguous(),
            ucfg.unknown_prob) + kernels.m3rsm_tiebreak(cands, cfg.n_theta)

    cands = consts["top"].expand(n_b, -1, 3).contiguous()
    scores = score(cfg.levels, cands)
    for level in range(cfg.levels - 1, -1, -1):
        take_n = min(cfg.beam_width, cands.shape[1])
        order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :take_n]
        parents = torch.gather(cands, 1, order[..., None].expand(-1, -1, 3))
        child = torch.tensor([[0, 0, 0], [0, 1 << level, 0], [0, 0, 1 << level],
                              [0, 1 << level, 1 << level]], dtype=torch.int32)
        cands = (parents[:, :, None, :] + child).reshape(n_b, -1, 3)
        scores = score(level, cands)
    best = torch.argmax(scores, dim=-1, keepdim=True)
    win = torch.gather(cands, 1, best[..., None].expand(-1, -1, 3))[:, 0]
    pose = torch.stack([
        poses[:, 0] + win[:, 2].to(torch.float32) * view.scale,
        poses[:, 1] + win[:, 1].to(torch.float32) * view.scale,
        wrap_angle(poses[:, 2] + th[win[:, 0].long()]),
    ], dim=-1)
    prob = torch.gather(scores, 1, best)[:, 0]
    if single:
        pose, prob = pose[0], prob[0]
    if cfg.refine_iterations == 0:
        return pose, prob
    theta_step = 2 * cfg.half_theta / max(cfg.n_theta - 1, 1) if cfg.n_theta > 1 else 0.02
    hc = tmatch.HillClimbingConfig(step_xy=view.scale, step_theta=max(theta_step / 2, 1e-3),
                                   iterations=cfg.refine_iterations, scoring=cfg.scoring)
    if single and refine_view.occ.dim() == 3:
        refine_view = tscore.MapView(occ=refine_view.occ[0], known=refine_view.known[0],
                                     origin=refine_view.origin[0], scale=view.scale)
    res = tmatch.hill_climbing_match(refine_view, scan, pose, None, hc, point_weights)
    return res.pose, res.prob


def _requests(scene, layout):
    """(reference view, port view, scans, priors, weights) of a layout."""
    jview, jmaps, scans, inits, weights = scene
    if layout == "one":
        js = jax.tree_util.tree_map(lambda a: a[0], scans)
        return jview, _tview(jview), js, inits[0], weights[0]
    return (jmaps if layout == "maps" else jview), _tview(jmaps if layout == "maps" else jview), \
        scans, inits, weights


def _reference(layout, jv, js, ji, jw, jcfg):
    if layout == "one":
        return jax.jit(lambda v, s, p, w: jm3.m3rsm_match(v, s, p, None, jcfg, w))(jv, js, ji, jw)
    if layout == "many":
        return jax.jit(lambda v, s, p, w: jm3.m3rsm_match_many(v, s, p, jcfg, w))(jv, js, ji, jw)
    return jax.jit(jax.vmap(lambda v, s, p, w: jm3.m3rsm_match(v, s, p, None, jcfg, w)))(
        jv, js, ji, jw)


@pytest.mark.parametrize("refine", [0, 8])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("layout", ["one", "many", "maps"])
def test_search_twin_equals_composition_and_reference(scene, layout, window, refine):
    jv, tv, js, ji, jw = _requests(scene, layout)
    jcfg = _jcfg(window, refine)
    cfg = _tcfg(jcfg)
    init = torch.from_numpy(np.array(ji))
    weights = torch.from_numpy(np.array(jw))
    got = tm3.m3rsm_match(tv, _tscan(js), init, None, cfg, weights)
    pose, prob = _composition(tv, _tscan(js), init, cfg, weights)
    assert got.pose.shape == pose.shape and got.prob.shape == prob.shape
    assert torch.equal(got.pose, pose) and torch.equal(got.prob, prob)
    if refine:
        assert got.trace.shape == (*prob.shape, refine)
        assert torch.equal(got.trace[..., -1], prob)
    want = _reference(layout, jv, js, ji, jw, jcfg)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.prob.numpy(), np.asarray(want.prob), atol=2e-6, rtol=0)


def test_search_twin_on_an_unknown_map_keeps_the_prior(scene):
    """An all-unknown map scores every rect alike: the tie-break keeps the
    rect at the prior (the reference's design), so the pose is the prior."""
    jview, _, scans, inits, _ = scene
    view = _tview(jview)
    view = dataclasses.replace(view, known=torch.zeros_like(view.known))
    cfg = _tcfg(_jcfg(0, 0))
    init = torch.from_numpy(np.array(inits[0]))
    js = jax.tree_util.tree_map(lambda a: a[0], scans)
    got = tm3.m3rsm_match(view, _tscan(js), init, None, cfg)
    np.testing.assert_allclose(got.pose.numpy(), init.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got.prob), 0.5, atol=1e-6, rtol=0)


def _scores_with_ties(seed, n_b, k):
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([0.25, 0.5, 0.75, -0.0, 0.0, np.inf, -np.inf, np.nan, -1.5],
                            np.float32), (n_b, k))
    x = np.where(rng.uniform(size=(n_b, k)) < 0.4, rng.uniform(-1, 1, (n_b, k)), x)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("n_b,k", [(1, 9), (2, 36), (3, 144), (1, 192), (2, 1024)])
def test_rank_count_equals_stable_sort(n_b, k):
    scores = _scores_with_ties(k + n_b, n_b, k)
    ranks = kernels.m3rsm_ranks_ref(scores)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    assert torch.equal(torch.argsort(ranks, dim=-1), order)
    assert torch.equal(torch.sort(ranks, dim=-1).values,
                       torch.arange(k).expand(n_b, k))


def _refresh_case(m, gates):
    rng = np.random.default_rng(m)
    occ = rng.uniform(0, 1, (m, 64, 64)).astype(np.float32)
    known = rng.uniform(0, 1, (m, 64, 64)) < 0.7
    occ2 = np.where(rng.uniform(0, 1, occ.shape) < 0.3, np.float32(0.95), occ)
    centers = np.array([[35, 35], [3, 60], [62, 2]])[:m]
    return occ, known, occ2, centers, np.asarray(gates, np.float32)


@pytest.mark.parametrize("gates", [(1.0,), (0.0,), (1.0, 0.0, 1.0)])
def test_refresh_twin_returns_new_planes_equal_to_the_reference(gates):
    m = len(gates)
    occ, known, occ2, centers, gate = _refresh_case(m, gates)
    planes = kernels.m3rsm_pyramid(torch.from_numpy(occ), torch.from_numpy(known), 3, 0.5)
    before = [p.clone() for p in planes]
    got = kernels.m3rsm_pyramid_update(planes, torch.from_numpy(occ2), torch.from_numpy(known),
                                       torch.from_numpy(centers), 32, 0.5,
                                       torch.from_numpy(gate))
    for a, b in zip(planes, before):
        assert torch.equal(a, b)  # the planes handed in stay as they were
    for i in range(m):
        jplanes = jm3.build_pyramid(jscore.MapView(occ=jnp.asarray(occ[i]),
                                                   known=jnp.asarray(known[i]),
                                                   origin=jnp.zeros(2), scale=0.1), 3, 0.5)
        view2 = jscore.MapView(occ=jnp.asarray(occ2[i]), known=jnp.asarray(known[i]),
                               origin=jnp.zeros(2), scale=0.1)
        want = jax.jit(lambda pl, v, c: jm3.update_pyramid(pl, v, 0.5, c, size=32))(
            jplanes, view2, jnp.asarray(centers[i], jnp.int32)) if gate[i] > 0 else jplanes
        for a, b in zip(got, want):
            assert a[i].data_ptr() != 0
            np.testing.assert_array_equal(a[i].numpy(), np.asarray(b))
