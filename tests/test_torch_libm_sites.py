"""The port's elementwise sites against the jitted reference on the bench
sequence, bit for bit: the reference's math library (``ops/libm.py``) and
the multiply-adds that XLA's CPU code fuses (``libm.fma32``).

The sequence is ``datagen.loop_trajectory(512)`` on ``cecum_world`` with
360 beams from ``PRNGKey(0)``, made by the reference. Each site has no
reduction, so the sum orders that XLA picks (ROADMAP trap k) play no part.
The reference's functions are jitted as the engine jits them; these tests
assume an x86-64 CPU with FMA (``tests/test_torch_libm.py`` says why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import engine as jeng
from slam_constructor_tpu.models import viny as jviny
from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import geometry as jgeo
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scan as jscan
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.models import viny as tviny
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import geometry as tgeo
from slam_constructor_tpu_torch.ops import kernels, libm, prng
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.ops import scoring as tscore

torch.set_num_threads(1)

N_SCANS, N_BEAMS = 512, 360


@functools.cache
def _sequence():
    occ, origin, scale = jdata.cecum_world()
    poses = jdata.loop_trajectory(N_SCANS)
    scans, odom, gt = jdata.synth_sequence(occ, origin, scale, poses,
                                           jdata.default_bearings(N_BEAMS),
                                           jax.random.PRNGKey(0))
    arrays = tuple(np.array(a) for a in (scans.ranges, scans.bearings, scans.valid, odom, gt))
    return arrays, np.asarray(origin), float(scale)


def _bits(got, want, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype == np.float32:
        bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
    else:
        bad = np.flatnonzero(got.reshape(-1) != want.reshape(-1))
    assert bad.size == 0, f"{what}: {bad.size} of {got.size} differ"


def _scans():
    (ranges, bearings, valid, _, _), _, _ = _sequence()
    js = jscan.LaserScan(ranges=jnp.asarray(ranges), bearings=jnp.asarray(bearings),
                         valid=jnp.asarray(valid))
    ts = [tscan.LaserScan(torch.from_numpy(ranges[i]), torch.from_numpy(bearings[i]),
                          torch.from_numpy(valid[i])) for i in range(N_SCANS)]
    return js, ts


def test_scan_points_on_every_scan():
    js, _ = _scans()
    (ranges, bearings, valid, _, _), _, _ = _sequence()
    want = jax.jit(jax.vmap(jscan.scan_points))(js)
    got = tscan.scan_points(tscan.LaserScan(*(torch.from_numpy(a) for a in (ranges, bearings,
                                                                            valid))))
    _bits(got, want, "scan_points")


def test_angle_histogram_and_point_weights_on_every_scan():
    """The histogram's tangent angles (glibc's atan2f of the endpoint steps,
    each step fused as XLA fuses it) and viny's point weights (``1 +
    hist[bins] * n_bins`` one fused multiply-add)."""
    js, ts = _scans()
    want_h = jax.jit(jax.vmap(jscan.angle_histogram))(js)
    _bits(torch.stack([tscan.angle_histogram(s) for s in ts]), want_h, "angle_histogram")
    jcfg, tcfg = jviny.viny_config(), tviny.viny_config()
    want_w = jax.jit(jax.vmap(lambda s: jeng._point_weights(jcfg, s)))(js)
    _bits(torch.stack([teng._point_weights(tcfg, s) for s in ts]), want_w, "_point_weights")


def test_beam_weights_on_every_scan_at_once():
    """``kernels.beam_weights`` (one launch for every scan on the card) over
    the whole [512, 360] sequence at once on the CPU, its plain version
    batched, against the jitted reference's ``_point_weights`` of each scan,
    bit for bit."""
    js, _ = _scans()
    (ranges, bearings, valid, _, _), _, _ = _sequence()
    want = jax.jit(jax.vmap(lambda s: jeng._point_weights(jviny.viny_config(), s)))(js)
    got = kernels.beam_weights(*(torch.from_numpy(a) for a in (ranges, bearings, valid)))
    _bits(got, want, "beam_weights")


def test_angle_bins_take_the_folded_constant(monkeypatch):
    """The bins of the histogram and of the weights: the jitted reference
    computes ``(ang + pi) / (2 pi) * n_bins`` as one product of ``ang + pi``
    with ``f32(f32(1 / 2 pi) * n_bins)`` (``scan.bin_factor``), held on the
    floor's argument against the angle recorded beside it, in both sites;
    the division and the reciprocal part on thousands (the bins themselves
    rarely)."""
    js, _ = _scans()
    rec = []

    class Record:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def arctan2(self, y, x):
            rec.append(jnp.arctan2(y, x))
            return rec[-1]

        def floor(self, x):
            rec.append(x)
            return jnp.floor(x)

    def weights(s):
        rec.clear()
        with monkeypatch.context() as m:
            m.setattr(jscan, "jnp", Record())
            m.setattr(jeng, "jnp", Record())
            jeng._point_weights(jviny.viny_config(), s)
        return tuple(rec)

    ang_h, arg_h, ang_w, arg_w = (np.asarray(a) for a in jax.jit(jax.vmap(weights))(js))
    factor = tscan.bin_factor(36)
    for ang, arg in ((ang_h, arg_h), (ang_w, np.asarray(arg_w)[:, :-1])):
        a = torch.from_numpy(ang)
        _bits((a + np.pi) * factor, arg, "the bins' product")
        divided = ((a + np.pi) / torch.full((), 2 * np.pi, dtype=torch.float32)) * 36.0
        assert (divided.numpy().view(np.uint32) != arg.view(np.uint32)).sum() > 1000


@pytest.mark.parametrize("fn", ["compose", "between", "inverse", "wrap_angle", "apply_pose"])
def test_pose_algebra_on_the_sequence(fn):
    (ranges, bearings, _, odom, gt), _, _ = _sequence()
    p, o = torch.from_numpy(gt), torch.from_numpy(odom)
    if fn == "compose":
        want, got = jax.jit(jgeo.compose)(gt, odom), tgeo.compose(p, o)
    elif fn == "between":
        want, got = jax.jit(jgeo.between)(gt[:-1], gt[1:]), tgeo.between(p[:-1], p[1:])
    elif fn == "inverse":
        want, got = jax.jit(jgeo.inverse)(gt), tgeo.inverse(p)
    elif fn == "wrap_angle":
        # headings of many turns: the large reduction's range too
        t = np.concatenate([gt[:, 2], gt[:, 2] * 37.0, gt[:, 2] * 4e5]).astype(np.float32)
        want, got = jax.jit(jgeo.wrap_angle)(t), tgeo.wrap_angle(torch.from_numpy(t))
    else:
        pts = np.array(jax.jit(jscan.scan_points)(jscan.LaserScan(
            jnp.asarray(ranges[0]), jnp.asarray(bearings[0]), jnp.ones(N_BEAMS, bool))))
        want = jax.jit(jgeo.apply_pose)(gt[:, None, :], pts[None])
        got = tgeo.apply_pose(p[:, None, :], torch.from_numpy(pts)[None])
    _bits(got, want, fn)


def test_beam_directions_and_sample_cells_on_every_scan():
    """raycast's beam directions (glibc's cosf, sinf of pose + bearing) and
    the scan's observation samples built on them, every scan from its true
    pose: the cells (the sample cells' reciprocal product, ROADMAP trap m)
    and weights of ``raycast.scan_sample_cells``."""
    (ranges, bearings, valid, _, gt), origin, scale = _sequence()
    dirs = jax.jit(lambda p, b: jnp.stack([jnp.cos(p[2] + b), jnp.sin(p[2] + b)], -1))
    want = jax.vmap(dirs)(gt, bearings)
    got = libm.cossin(torch.from_numpy(gt[:, 2:3]) + torch.from_numpy(bearings))
    _bits(got, want, "beam directions")
    jbeam = jray.BeamConfig(free_impl="dda")
    tbeam = tray.BeamConfig(free_impl="dda")
    samples = jax.jit(jax.vmap(lambda p, r, b, v: jray.scan_sample_cells(
        origin, scale, p, jscan.LaserScan(r, b, v), jbeam)))
    jr, jc, jw, js_ = (np.asarray(a) for a in samples(gt[::8], ranges[::8], bearings[::8],
                                                        valid[::8]))
    for k, i in enumerate(range(0, N_SCANS, 8)):
        tr_, tc_, tw_, ts_ = tray.scan_sample_cells(
            torch.from_numpy(origin), scale, torch.from_numpy(gt[i]),
            tscan.LaserScan(torch.from_numpy(ranges[i]), torch.from_numpy(bearings[i]),
                            torch.from_numpy(valid[i])), tbeam)
        _bits(tr_, jr[k], f"sample rows, scan {i}")
        _bits(tc_, jc[k], f"sample cols, scan {i}")
        _bits(tw_, jw[k], f"sample weights, scan {i}")


class _RecordExp:
    """``jax.numpy`` with ``exp`` recording its outputs, put in the place of
    the reference module's ``jnp`` while a function is traced."""

    def __init__(self, out: list):
        self.out = out

    def __getattr__(self, name):
        return getattr(jnp, name)

    def exp(self, x):
        y = jnp.exp(x)
        self.out.append(y)
        return y


def test_tbm_update_powers(monkeypatch):
    """TBMCell.update's closed form raises masses to the k = floor(w) rounds
    with XLA's exp and log, ``exp(k log(max(base, eps)))``, each base ``q o +
    (1 - q)`` one fused multiply-add: the three powers inside the jitted
    reference's ``update`` and inside the port's, on seeded cells and
    observations, bit for bit. (The update's later combinations and its
    sum over the masses are not held: ROADMAP Queue 3.)"""
    rng = np.random.default_rng(0)
    n = 1 << 16
    belief = rng.dirichlet(np.ones(4), n).astype(np.float32)
    w = (rng.integers(0, 40, n) * rng.uniform(0, 1.5, n)).astype(np.float32)
    w[::7] = 0.0
    s = (w * rng.uniform(0, 1, n)).astype(np.float32)
    n_prev = np.zeros(n, np.float32)

    def jupdate(*args):
        powers = []
        with monkeypatch.context() as m:
            m.setattr(jcells, "jnp", _RecordExp(powers))
            out = jcells.TBMCell().update(*args)
        return out, powers

    want_out, want = jax.jit(jupdate)(belief, n_prev, w, s)
    got = []
    exp = libm.exp
    monkeypatch.setattr(libm, "exp", lambda *a, **kw: got.append(exp(*a, **kw)) or got[-1])
    got_out = tcells.TBMCell().update(*(torch.from_numpy(a) for a in (belief, n_prev, w, s)))
    assert len(got) == len(want) == 3 and got_out.shape == want_out.shape
    for name, g, wv in zip(("uu^k", "(q o + uu)^k", "(q (1 - o) + uu)^k"), got, want):
        _bits(g, np.broadcast_to(np.asarray(wv), g.shape), f"TBM powk {name}")


def test_monte_carlo_candidates_equal_the_jitted_reference():
    """The match's candidates from its own draws: the reference's jitted
    ``matchers.monte_carlo_match`` computes ``best + normal(key_r) * sigma``
    as one fused multiply-add of ``erf_inv(u)`` and ``sqrt(2) * sigma`` (XLA
    folds the normal's constant into sigma); the port's match from the same
    key (``kernels.KeyNoise``, ``kernels.mc_match_ref`` on the CPU) draws
    those numbers and forms them so. Each round's winner is one of the
    candidates, so the matched pose is bit for bit; the scores are sums
    taken in another order (ROADMAP trap k) and agree to 1e-6."""
    occ, origin, scale = jdata.cecum_world()
    bearings = jdata.default_bearings(128)
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 160, 160, scale)
    beam = jray.BeamConfig(wall_blur=True, free_impl="dda")
    cast = jax.jit(lambda p: jray.cast_rays(occ, origin, scale, p, bearings))
    insert = jax.jit(jray.insert_scan, static_argnums=(1, 4))
    for p in ([-1.0, -1.5, 0.0], [0.0, -1.6, 0.1]):
        gm = insert(gm, model, jnp.asarray(p), cast(jnp.asarray(p)), beam)
    true = np.float32([0.5, -1.55, 0.05])
    js = cast(jnp.asarray(true))
    jview = jscore.MapView.of(gm, model)
    tview = tscore.MapView(occ=torch.from_numpy(np.array(jview.occ)),
                           known=torch.from_numpy(np.array(jview.known)),
                           origin=torch.from_numpy(np.array(jview.origin)), scale=jview.scale)
    ts = tscan.LaserScan(*(torch.from_numpy(np.array(a)) for a in (js.ranges, js.bearings,
                                                                   js.valid)))
    mc = dict(sigma_xy=0.08, sigma_theta=0.05, batch=64, rounds=12)
    jcfg = jmatch.MonteCarloConfig(**mc, scoring=jscore.ScoringConfig(reducer="overlap"))
    tcfg = tmatch.MonteCarloConfig(**mc, scoring=tscore.ScoringConfig(reducer="overlap"))
    match = jax.jit(lambda v, sc, p, k: jmatch.monte_carlo_match(v, sc, p, k, jcfg))
    for seed in range(3):
        off = np.random.default_rng(seed).uniform(-1, 1, 3) * np.float32([0.12, 0.08, 0.05])
        init = (true + off).astype(np.float32)
        want = match(jview, js, jnp.asarray(init), jax.random.PRNGKey(seed))
        got = tmatch.monte_carlo_match(tview, ts, torch.from_numpy(init), prng.key(seed), tcfg)
        _bits(got.pose, want.pose, f"matched pose, key {seed}")
        np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace), atol=1e-6)
