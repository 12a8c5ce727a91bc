"""Every scoring site's endpoint arithmetic against the jitted reference.

The reference's ``scoring.score_poses`` computes ``rel = (apply_pose(pose,
pts) - origin) / view.scale`` with the cell size a static field, so under
``jit`` XLA fuses the rotation into two multiply-adds a coordinate and
multiplies by ``f32(1 / scale)`` (ROADMAP traps m and z); ``m3rsm_match``
does the same for its endpoint cells and its window, and ``window_view`` for
its corner. The port computes these in ``grid.endpoint_cells`` /
``grid.cell_coord`` and the kernels in ``csrc/overlap_sample.cuh``
``endpoint_cells``. Each site is recorded inside the function that owns it
(the reference's ``jnp.floor`` is swapped while it is traced, as
``test_torch_libm_sites.py`` records ``exp``) and held bit for bit; the
scores then agree to the weighted mean's sum order (trap k).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import m3rsm as jm3
from slam_constructor_tpu.ops import scan as jscan
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import kernels, libm
from slam_constructor_tpu_torch.ops import m3rsm as tm3
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.ops import scoring as tscore

torch.set_num_threads(1)

N_POSES, N_BEAMS, SIDE, SCALE = 1024, 128, 96, 0.1


class _RecordFloor:
    """``jax.numpy`` with ``floor`` recording its arguments, put in the place
    of a reference module's ``jnp`` while a function is traced."""

    def __init__(self, out: list):
        self.out = out

    def __getattr__(self, name):
        return getattr(jnp, name)

    def floor(self, x):
        self.out.append(x)
        return jnp.floor(x)


def _traced(module, fn):
    """``fn`` with ``module.jnp.floor``'s arguments returned beside its
    result (``fn(*args) -> (result, [floor arguments])``)."""

    def run(*args):
        out = []
        old = module.jnp
        module.jnp = _RecordFloor(out)
        try:
            res = fn(*args)
        finally:
            module.jnp = old
        return res, out

    return run


@functools.cache
def _fixture():
    rng = np.random.default_rng(23)
    occ = rng.uniform(0.0, 1.0, (SIDE, SIDE)).astype(np.float32)
    known = rng.uniform(0.0, 1.0, (SIDE, SIDE)) > 0.15
    origin = np.float32([-0.5 * SIDE * SCALE, -0.5 * SIDE * SCALE])
    ranges = rng.uniform(0.2, 4.0, N_BEAMS).astype(np.float32)
    bearings = np.asarray(jdata.default_bearings(N_BEAMS))
    valid = rng.uniform(0.0, 1.0, N_BEAMS) > 0.05
    poses = np.stack([rng.uniform(-2.5, 2.5, N_POSES), rng.uniform(-2.5, 2.5, N_POSES),
                      rng.uniform(-np.pi, np.pi, N_POSES)], -1).astype(np.float32)
    # a quarter of the poses on a multiple of the cell size: endpoints whose
    # products land next to a cell's edge
    poses[::4, :2] = (np.round(poses[::4, :2] / SCALE) * SCALE).astype(np.float32)
    return occ, known, origin, ranges, bearings, valid, poses


def _views():
    occ, known, origin, ranges, bearings, valid, poses = _fixture()
    jview = jscore.MapView(occ=jnp.asarray(occ), known=jnp.asarray(known),
                           origin=jnp.asarray(origin), scale=SCALE)
    tview = tscore.MapView(occ=torch.from_numpy(occ), known=torch.from_numpy(known),
                           origin=torch.from_numpy(origin), scale=SCALE)
    js = jscan.LaserScan(jnp.asarray(ranges), jnp.asarray(bearings), jnp.asarray(valid))
    ts = tscan.LaserScan(torch.from_numpy(ranges), torch.from_numpy(bearings),
                         torch.from_numpy(valid))
    return jview, tview, js, ts, poses


def _differ(got, want) -> int:
    """The count of float32 values whose bits differ (``got`` may hold a
    leading map dimension of 1, as the twins compute)."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.size == want.size, (got.shape, want.shape)
    got = got.reshape(want.shape)
    return int((got.view(np.uint32) != want.view(np.uint32)).sum())


def _record_endpoints(monkeypatch) -> list:
    """The port's ``grid.endpoint_cells`` outputs, as its callers (the twins
    in ``ops/kernels.py``) compute them."""
    got = []
    fn = tgrid.endpoint_cells
    def recording(*a):
        out = fn(*a)
        got.append(tuple(t.detach() for t in out))
        return out

    monkeypatch.setattr(tgrid, "endpoint_cells", recording)
    return got


def _parent_form(poses, pts, origin):
    """The form the port computed before: unfused, an IEEE division."""
    p = torch.from_numpy(poses)
    s, c = libm.sincos(p[:, None, 2])
    qx, qy = pts[None, :, 0], pts[None, :, 1]
    wx = (p[:, None, 0] + c * qx) - s * qy
    wy = (p[:, None, 1] + s * qx) + c * qy
    return (tgrid.div_scale(wx - float(origin[0]), SCALE),
            tgrid.div_scale(wy - float(origin[1]), SCALE))


@pytest.mark.parametrize("reducer", ["obstacle", "overlap", "overlap_e1.5"])
def test_score_endpoints_equal_the_jitted_score(monkeypatch, reducer):
    """The twin's endpoint cells (``kernels._beam_probs_ref``) against the
    ``rel`` that the jitted ``score_poses`` takes the floor of, bit for bit;
    the parent's form (unfused, divided) parts on thousands."""
    jview, tview, js, ts, poses = _views()
    extent = 1.5 if reducer == "overlap_e1.5" else 1.0
    kind = reducer.split("_")[0]
    jcfg = jscore.ScoringConfig(reducer=kind, overlap_extent=extent)
    tcfg = tscore.ScoringConfig(reducer=kind, overlap_extent=extent)
    (_, floors) = jax.jit(_traced(jscore, lambda v, s, p: jscore.score_poses(v, s, p, jcfg)))(
        jview, js, jnp.asarray(poses))
    want = np.asarray(floors[0])  # [K, R, 2] (x, y)
    got = _record_endpoints(monkeypatch)
    tscore.score_poses(tview, ts, torch.from_numpy(poses), tcfg)
    x, y = got[0]
    assert _differ(torch.stack([x, y], -1), want) == 0
    old = _parent_form(poses, tscan.scan_points(ts), _fixture()[2])
    assert _differ(torch.stack(old, -1), want) > 1000


@pytest.mark.parametrize("reducer", ["obstacle", "overlap"])
def test_scores_agree_with_the_jitted_score(reducer):
    """Whole scores: at the obstacle reducer (a flipped endpoint moves a
    beam's value by a whole cell's step) and the overlap reducer within
    3e-7 of the jitted ``score_poses``; what remains is the weighted mean's
    sum order (trap k)."""
    jview, tview, js, ts, poses = _views()
    jcfg = jscore.ScoringConfig(reducer=reducer)
    want = np.asarray(jax.jit(lambda v, s, p: jscore.score_poses(v, s, p, jcfg))(
        jview, js, jnp.asarray(poses)))
    got = tscore.score_poses(tview, ts, torch.from_numpy(poses),
                             tscore.ScoringConfig(reducer=reducer)).numpy()
    assert np.abs(got - want).max() <= 3e-7
    assert (got != want).sum() < N_POSES  # the residual count PERF.md records


def test_grad_twin_endpoints_and_gradient_equal_jax_grad(monkeypatch):
    """The gradient twin's endpoints (the balanced taps) bit for bit with
    the jitted ``score_poses``, and its pose gradient against
    ``jax.grad(score_single)``: the cell-unit derivative times the
    reciprocal, at fp32 scale (the sums over beams in another order)."""
    jview, tview, js, ts, poses = _views()
    cfg = jscore.ScoringConfig(reducer="overlap")
    prep = tscore.prepare(tview, ts, tscore.ScoringConfig(reducer="overlap"))
    k = 64
    got = _record_endpoints(monkeypatch)
    score, grad = kernels.overlap_score_grad_ref(
        prep.plane, torch.from_numpy(poses[:k]), prep.pts, prep.beam_w, prep.origin,
        prep.scale, prep.unknown)
    (_, floors) = jax.jit(_traced(jscore, lambda v, s, p: jscore.score_poses(v, s, p, cfg)))(
        jview, js, jnp.asarray(poses[:k]))
    x, y = got[0]
    assert _differ(torch.stack([x, y], -1), floors[0]) == 0
    vg = jax.jit(jax.vmap(jax.value_and_grad(lambda p: jscore.score_single(jview, js, p, cfg))))
    want_s, want_g = (np.asarray(a) for a in vg(jnp.asarray(poses[:k])))
    assert np.abs(score.numpy() - want_s).max() <= 3e-7
    tol = 2e-6 * np.maximum(1.0, np.linalg.norm(want_g, axis=-1, keepdims=True))
    assert (np.abs(grad.numpy() - want_g) <= tol).all()


def test_partial_ownership_rows_equal_the_jitted_score(monkeypatch):
    """The row-sharded partial's ownership row (``overlap_score_partial_ref``)
    is the floor of the jitted score's ``y``: both of its endpoint
    computations equal the reference's bit for bit."""
    jview, tview, js, ts, poses = _views()
    cfg = jscore.ScoringConfig(reducer="overlap")
    (_, floors) = jax.jit(_traced(jscore, lambda v, s, p: jscore.score_poses(v, s, p, cfg)))(
        jview, js, jnp.asarray(poses))
    prep = tscore.prepare(tview, ts, tscore.ScoringConfig(reducer="overlap"))
    got = _record_endpoints(monkeypatch)
    half = SIDE // 2
    kernels.overlap_score_partial_ref(prep.plane[:half + 2], 0, SIDE, torch.from_numpy(poses),
                                      prep.pts, prep.beam_w, prep.origin, SCALE, prep.unknown,
                                      0, half)
    assert len(got) == 2
    for x, y in got:
        assert _differ(torch.stack([x, y], -1), floors[0]) == 0


@pytest.mark.parametrize("window", [0, 64])
def test_m3rsm_endpoint_cells_and_window_equal_the_jitted_match(monkeypatch, window):
    """The M3RSM twin's endpoint cells at every theta (``kernels.
    m3rsm_window_cells``, which the kernel computes alike) and, with a
    window, the window's cell (the reciprocal product) against the floors
    inside the jitted ``m3rsm_match``; the window's origin is one fused
    multiply-add there (the cells are its relative coordinates)."""
    jview, tview, js, ts, poses = _views()
    jcfg = jm3.M3RSMConfig(levels=3, window=window, n_theta=9, half_x=0.3, half_y=0.3,
                           beam_width=32, scoring=jscore.ScoringConfig(reducer="overlap"))
    tcfg = tm3.M3RSMConfig(levels=3, window=window, n_theta=9, half_x=0.3, half_y=0.3,
                           beam_width=32, scoring=tscore.ScoringConfig(reducer="overlap"))
    # the view an argument, as the engine's state is (a constant origin
    # would be folded otherwise)
    run = jax.jit(jax.vmap(_traced(jm3, lambda view, p, r, b, v: jm3.m3rsm_match(
        view, jscan.LaserScan(r, b, v), p, None, jcfg)), (None, 0, None, None, None)))
    n = 8
    (_, floors) = run(jview, jnp.asarray(poses[:n]), js.ranges, js.bearings, js.valid)
    got = _record_endpoints(monkeypatch)
    tm3.m3rsm_match(tview, tscan.LaserScan(*(torch.stack([t] * n) for t in (
        ts.ranges, ts.bearings, ts.valid))), torch.from_numpy(poses[:n]), None, tcfg)
    x, y = got[0]  # [B, T, R]
    if window:
        wx, wy = (np.asarray(f) for f in floors[:2])
        rel = tgrid.cell_coord(torch.from_numpy(poses[:n, :2]) - tview.origin, SCALE)
        assert _differ(rel, np.stack([wx, wy], -1)) == 0
        floors = floors[2:]
    assert _differ(y, floors[0]) == 0 and _differ(x, floors[1]) == 0


def test_window_corner_equals_the_jitted_window_view():
    """``grid.window_corner`` (the RBPF's match and insert windows, K3's
    ``corner_of``) against the jitted ``window_view``: the corner's cell
    from the reciprocal product, the window's origin unfused, bit for bit."""
    rng = np.random.default_rng(5)
    origin = np.float32([-12.8, -12.8])
    ctr = rng.uniform(-12.0, 12.0, (2048, 2)).astype(np.float32)
    ctr[::2] = (np.round(ctr[::2] / SCALE) * SCALE).astype(np.float32)
    occ = jnp.zeros((256, 256))

    def view(c, o):  # the origin an argument, as the engine's state is
        return jscore.window_view(jscore.MapView(occ=occ, known=occ > 0, origin=o,
                                                 scale=SCALE), c, 160)

    (v, floors) = jax.jit(jax.vmap(_traced(jscore, view), (0, None)))(jnp.asarray(ctr),
                                                                      jnp.asarray(origin))
    row, col, o = tgrid.window_corner(torch.from_numpy(origin), torch.from_numpy(ctr), SCALE,
                                      160, 160, 256, 256)
    rel = tgrid.cell_coord(torch.from_numpy(ctr) - torch.from_numpy(origin), SCALE)
    assert _differ(rel, np.stack([np.asarray(f) for f in floors[:2]], -1)) == 0
    assert _differ(o, v.origin) == 0
    assert (tgrid.div_scale(torch.from_numpy(ctr) - torch.from_numpy(origin), SCALE)
            != rel).any()  # the division parts somewhere
