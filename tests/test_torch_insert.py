"""Port parity: K3, the scan insert with its cell fold (``kernels.scan_insert``).

On the CPU the wrapper runs its plain twin ``kernels.scan_insert_ref``
(``raycast.scan_observation_planes`` or its batched form, scaled by ``q``,
then ``grid.apply_observations``); these tests hold it to the JAX
reference, jitted: ``raycast.insert_scan`` with the engine's ``q`` for one
map, the RBPF's ``insert_one`` (``models/gmapping.py:389``, its slice
form, with ``q`` scaling the window's observation) for P windows and for P
whole maps. The maps start from random cells of the model, so the fold
meets cells with weight and without.

Tolerance, as ``test_torch_raycast.py`` and ``test_torch_polar.py`` hold
the twin: a cell agrees when every channel is within 1e-5 x max(1,
|reference|); at most 0.1% of the cells may differ (a DDA sample within an
ulp of a cell's edge, where the jitted reference multiplies by 1 / scale
and the port divides, trap m; a polar cell on its free test's knife edge).
The cell a map's (or window's) off-map samples wrap into on the reference
is left out (trap g): the port drops them.

The order test: the twin's planes equal ``np.add.at`` (unbuffered, in
order) over the same samples (``raycast.scan_sample_cells``) bit for bit;
that sample order is what the card's kernel sums in.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scan as jscan
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)

SIZE, SCALE, WINDOW, N_BEAMS = 80, 0.2, 40, 90  # 16 m at 0.2 m holds the 14.4 x 5.2 m world
TOL, MAX_BAD = 1e-5, 1e-3
#: the scans' poses: in the corridors, the last one's window clamped at the map's edge
POSES = [[0.3, -1.45, 0.7], [-4.03, 1.47, 2.0], [6.1, -1.7, -2.4]]
MODELS = {
    "bayes_avg": (jcells.BayesAvgCell, tcells.BayesAvgCell, {}),
    "bayes_base": (jcells.BayesBaseCell, tcells.BayesBaseCell, dict(quality=0.3)),
    "tbm": (jcells.TBMCell, tcells.TBMCell, dict(quality=0.5, conflict_decay=0.1)),
}
FORMS = ("one map", "windows", "whole maps")
QS = (0.0, 0.5, 1.0)

#: (estimator, blur, free fill, model, form, q): every value of each axis
#: meets every value of every other axis at least once (pairwise), 12 cases
#: of the 216
CASES = [
    ("const", True, "dda", "bayes_avg", "one map", 1.0),
    ("area", False, "polar", "bayes_avg", "windows", 0.5),
    ("const", False, "polar", "bayes_avg", "whole maps", 0.0),
    ("area", True, "dda", "bayes_avg", "windows", 0.0),
    ("area", False, "dda", "bayes_base", "one map", 0.5),
    ("const", True, "polar", "bayes_base", "windows", 1.0),
    ("area", True, "polar", "bayes_base", "whole maps", 0.5),
    ("const", False, "dda", "bayes_base", "one map", 0.0),
    ("const", True, "polar", "tbm", "one map", 0.5),
    ("const", False, "dda", "tbm", "windows", 1.0),
    ("area", True, "dda", "tbm", "whole maps", 1.0),
    ("area", False, "polar", "tbm", "one map", 0.0),
]
AXES = (("const", "area"), (False, True), ("dda", "polar"), tuple(MODELS), FORMS, QS)


def test_cases_cover_every_pair_of_values():
    for a, b in itertools.combinations(range(len(AXES)), 2):
        seen = {(c[a], c[b]) for c in CASES}
        assert seen == set(itertools.product(AXES[a], AXES[b])), (a, b)


@functools.cache
def _scans(n_maps: int, holes: bool):
    """Scans of the cecum world from the first ``n_maps`` poses, numpy
    (ranges, bearings, valid) [P, R]; with ``holes`` every 7th beam invalid."""
    occ, origin, scale = jdata.cecum_world()
    out = [jray.cast_rays(occ, origin, scale, jnp.asarray(p, jnp.float32),
                          jdata.default_bearings(N_BEAMS)) for p in POSES[:n_maps]]
    ranges = np.stack([np.asarray(s.ranges) for s in out])
    bearings = np.stack([np.asarray(s.bearings) for s in out])
    valid = np.stack([np.asarray(s.valid) for s in out])
    if holes:
        valid &= np.arange(N_BEAMS) % 7 != 3
    return ranges, bearings, valid


def _cells(model: str, n_maps: int, seed: int = 0) -> np.ndarray:
    """Random cells of the model f32[P, H, W, C]: beliefs of the model and
    weights, a third of them 0 (unknown cells)."""
    rng = np.random.default_rng(seed)
    shape = (n_maps, SIZE, SIZE)
    n = np.where(rng.random(shape) < 1 / 3, 0.0, rng.uniform(0.0, 6.0, shape))
    if model == "tbm":
        m = rng.dirichlet(np.ones(4), size=shape)
        belief = m
    else:
        belief = rng.uniform(0.05, 0.95, shape)[..., None]
    return np.concatenate([belief, n[..., None]], -1).astype(np.float32)


def _beam(j: bool, estimator, blur, free_impl, max_range=15.0):
    mod = jray if j else tray
    return mod.BeamConfig(occupancy_estimator=estimator, wall_blur=blur, free_impl=free_impl,
                          max_range=max_range)


def _origin(n_maps: int) -> np.ndarray:
    return np.tile(np.float32([-SIZE * SCALE / 2, -SIZE * SCALE / 2]), (n_maps, 1))


def _reference(model, cfg, form, cells, origins, poses, scans, q):
    """The jitted reference's new cells f32[P, H, W, C]."""
    ranges, bearings, valid = (jnp.asarray(a) for a in scans)
    window = WINDOW if form == "windows" else 0

    def one(cells_p, origin_p, pose_p, ranges_p, bearings_p, valid_p):
        scan = jscan.LaserScan(ranges=ranges_p, bearings=bearings_p, valid=valid_p)
        h, w, c = cells_p.shape
        if not window:
            sub, win_origin, row, col = cells_p, origin_p, 0, 0
        else:  # the RBPF's insert_one (slice form)
            wi = min(window, h, w)
            rel = (pose_p[:2] - origin_p) / SCALE
            col = jnp.clip(jnp.floor(rel[0]).astype(jnp.int32) - wi // 2, 0, w - wi)
            row = jnp.clip(jnp.floor(rel[1]).astype(jnp.int32) - wi // 2, 0, h - wi)
            win_origin = origin_p + jnp.stack([col, row]).astype(jnp.float32) * SCALE
            sub = jax.lax.dynamic_slice(cells_p, (row, col, 0), (wi, wi, c))
        gm = jgrid.GridMap(cells=sub, origin=win_origin, scale=SCALE)
        w_obs, s_obs = jray.scan_observation_planes(gm, pose_p, scan, cfg)
        new = jgrid.apply_observations(gm, model, q * w_obs, q * s_obs).cells
        return jax.lax.dynamic_update_slice(cells_p, new, (row, col, 0)) if window else new

    out = jax.jit(jax.vmap(one))(jnp.asarray(cells), jnp.asarray(origins), jnp.asarray(poses),
                                 ranges, bearings, valid)
    return np.asarray(out)


def _port(model, cfg, form, cells, origins, poses, scans, q):
    ranges, bearings, valid = (torch.from_numpy(np.ascontiguousarray(a)) for a in scans)
    qt = torch.tensor(q, dtype=torch.float32)
    if form == "one map":
        gm = tgrid.GridMap(cells=torch.from_numpy(cells[0]), origin=torch.from_numpy(origins[0]),
                           scale=SCALE)
        scan = tscan.LaserScan(ranges[0], bearings[0], valid[0])
        return kernels.scan_insert(gm, model, torch.from_numpy(poses[0]), scan, cfg, qt)[None]
    gm = tgrid.GridMap(cells=torch.from_numpy(cells), origin=torch.from_numpy(origins),
                       scale=SCALE)
    return kernels.scan_insert(gm, model, torch.from_numpy(poses), tscan.LaserScan(
        ranges, bearings, valid), cfg, qt, WINDOW if form == "windows" else 0)


def _wrapped(form, origins, poses):
    """(map, row, col) of the cells the reference wraps its off-map (or
    off-window) samples into (trap g)."""
    if form != "windows":
        return [(p, SIZE - 1, SIZE - 1) for p in range(len(poses))]
    row, col, _ = tgrid.window_corner(torch.from_numpy(origins), torch.from_numpy(poses[:, :2]),
                                      SCALE, WINDOW, WINDOW, SIZE, SIZE)
    return [(p, int(row[p]) + WINDOW - 1, int(col[p]) + WINDOW - 1) for p in range(len(poses))]


def _hold(got, want, skip):
    """Share of the cells (those in ``skip`` left out) where a channel
    differs by more than the tolerance."""
    close = np.all(np.abs(got - want) <= TOL * np.maximum(1.0, np.abs(want)), axis=-1)
    for p, r, c in skip:
        close[p, r, c] = True
    return 1.0 - close.mean()


@pytest.mark.parametrize("estimator,blur,free_impl,model,form,q", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_scan_insert_matches_reference(estimator, blur, free_impl, model, form, q):
    n_maps = 1 if form == "one map" else 3
    jm_cls, tm_cls, kw = MODELS[model]
    cells = _cells(model, n_maps)
    origins, poses = _origin(n_maps), np.float32(POSES[:n_maps])
    # every 7th beam invalid where the fill is polar (its neighbour test),
    # and DDA to 6 m on the windows (beams past the usable range)
    scans = _scans(n_maps, holes=free_impl == "polar")
    max_range = 6.0 if form == "windows" and free_impl == "dda" else 15.0
    want = _reference(jm_cls(**kw), _beam(True, estimator, blur, free_impl, max_range), form,
                      cells, origins, poses, scans, q)
    got = _port(tm_cls(**kw), _beam(False, estimator, blur, free_impl, max_range), form,
                cells, origins, poses, scans, q).numpy()
    assert got.shape == want.shape == cells.shape and got.dtype == np.float32
    bad = _hold(got, want, _wrapped(form, origins, poses))
    assert bad <= MAX_BAD, f"{bad * got[..., 0].size:.0f} cells differ"
    changed = np.any(got != cells, axis=-1)
    if q > 0:  # the scans really landed
        assert changed.sum() > 200 * n_maps
    if form == "windows":  # cells outside the windows are copied
        row, col, _ = tgrid.window_corner(torch.from_numpy(origins),
                                          torch.from_numpy(poses[:, :2]), SCALE, WINDOW,
                                          WINDOW, SIZE, SIZE)
        outside = np.ones(cells.shape[:3], bool)
        for p in range(n_maps):
            outside[p, int(row[p]):int(row[p]) + WINDOW, int(col[p]):int(col[p]) + WINDOW] = False
        assert np.array_equal(got[outside], cells[outside])


@pytest.mark.parametrize("form", FORMS)
def test_scan_insert_edge_cases_match_reference(form):
    """No valid beam in one scan, every beam past the usable range in
    another: only the fold of the map's own cells (BayesAvg refolds every
    known cell) and, in the second, the free trace."""
    n_maps = 1 if form == "one map" else 3
    ranges, bearings, valid = (a.copy() for a in _scans(n_maps, holes=False))
    valid[0] = False
    cells, origins, poses = _cells("bayes_avg", n_maps, 1), _origin(n_maps), np.float32(
        POSES[:n_maps])
    for max_range in (15.0, 0.5):
        want = _reference(jcells.BayesAvgCell(), _beam(True, "const", True, "dda", max_range),
                          form, cells, origins, poses, (ranges, bearings, valid), 1.0)
        got = _port(tcells.BayesAvgCell(), _beam(False, "const", True, "dda", max_range), form,
                    cells, origins, poses, (ranges, bearings, valid), 1.0).numpy()
        assert _hold(got, want, _wrapped(form, origins, poses)) <= MAX_BAD
        # map 0 saw nothing: its known cells refold, its unknown cells keep their bits
        unknown = cells[0, ..., -1] == 0
        assert np.array_equal(got[0][unknown], cells[0][unknown])
        np.testing.assert_allclose(got[0], cells[0], rtol=1e-6)


def _planes_by_add_at(origin, pose, scan, cfg, sh, sw):
    """(w, s) f32[sh, sw] of one scan: its samples (``scan_sample_cells``)
    summed with ``np.add.at`` in sample order, the free counts first, the
    free fill from the polar twin where it is polar."""
    rows, cols, w, s = (t.numpy() for t in tray.scan_sample_cells(origin, SCALE, pose, scan, cfg))
    n_free = scan.ranges.shape[0] * cfg.n_free_samples(SCALE)
    on = (rows >= 0) & (rows < sh) & (cols >= 0) & (cols < sw)
    free, occ = np.arange(rows.size) < n_free, np.arange(rows.size) >= n_free
    w_free = np.zeros((sh, sw), np.float32)
    if cfg.free_impl == "polar":
        w_free = kernels.polar_free_plane_ref(scan.ranges, scan.valid, scan.bearings, pose,
                                              origin, sh, sw, SCALE, cfg.hole_width / 2.0,
                                              cfg.max_range).numpy()
    else:
        np.add.at(w_free, (rows[free & on], cols[free & on]), w[free & on])
    w_occ, s_occ = np.zeros((sh, sw), np.float32), np.zeros((sh, sw), np.float32)
    np.add.at(w_occ, (rows[occ & on], cols[occ & on]), w[occ & on])
    np.add.at(s_occ, (rows[occ & on], cols[occ & on]), s[occ & on])
    return w_free + w_occ, s_occ


@pytest.mark.parametrize("estimator,blur,free_impl", [
    ("const", True, "dda"), ("area", True, "dda"), ("const", False, "polar"),
    ("area", False, "dda")])
def test_twin_planes_sum_in_sample_order(estimator, blur, free_impl):
    cfg = _beam(False, estimator, blur, free_impl)
    ranges, bearings, valid = (torch.from_numpy(a) for a in _scans(3, holes=True))
    poses, origins = torch.from_numpy(np.float32(POSES)), torch.from_numpy(_origin(3))
    # one map
    gm = tgrid.GridMap(cells=torch.from_numpy(_cells("bayes_avg", 1)[0]), origin=origins[0],
                       scale=SCALE)
    scan = tscan.LaserScan(ranges[0], bearings[0], valid[0])
    w, s = tray.scan_observation_planes(gm, poses[0], scan, cfg)
    w_np, s_np = _planes_by_add_at(origins[0], poses[0], scan, cfg, SIZE, SIZE)
    assert np.array_equal(w.numpy(), w_np) and np.array_equal(s.numpy(), s_np)
    assert (s_np > 0).sum() > 30 and (w_np > 0).sum() > 150
    # P windows, each with its window's origin
    _, _, win = tgrid.window_corner(origins, poses[:, :2], SCALE, WINDOW, WINDOW, SIZE, SIZE)
    scans = tscan.LaserScan(ranges, bearings, valid)
    w, s = tray.scan_observation_planes_batched(win, WINDOW, WINDOW, SCALE, poses, scans, cfg)
    for p in range(3):
        w_np, s_np = _planes_by_add_at(win[p], poses[p], scans[p], cfg, WINDOW, WINDOW)
        assert np.array_equal(w[p].numpy(), w_np) and np.array_equal(s[p].numpy(), s_np)


def test_callers_and_wrapper_run_the_twin_on_the_cpu():
    """``raycast.insert_scan`` and ``insert_scan_windows`` are one call of
    the wrapper; on CPU tensors it is the twin, and counts no launch."""
    model, cfg = tcells.TBMCell(quality=0.5), _beam(False, "const", True, "polar")
    ranges, bearings, valid = (torch.from_numpy(a) for a in _scans(3, holes=False))
    poses, origins = torch.from_numpy(np.float32(POSES)), torch.from_numpy(_origin(3))
    cells = torch.from_numpy(_cells("tbm", 3))
    before = kernels.launch_counts()["scan_insert"]
    gm = tgrid.GridMap(cells=cells[0], origin=origins[0], scale=SCALE)
    scan = tscan.LaserScan(ranges[0], bearings[0], valid[0])
    q = torch.tensor(0.5)
    got = tray.insert_scan(gm, model, poses[0], scan, cfg, q)
    assert torch.equal(got.cells, kernels.scan_insert_ref(gm, model, poses[0], scan, cfg, q))
    assert torch.equal(got.origin, gm.origin) and got.scale == SCALE
    stack = tgrid.GridMap(cells=cells, origin=origins, scale=SCALE)
    scans = tscan.LaserScan(ranges, bearings, valid)
    got = tray.insert_scan_windows(stack, model, poses, scans, cfg, WINDOW)
    assert torch.equal(got.cells, kernels.scan_insert_ref(stack, model, poses, scans, cfg,
                                                          window=WINDOW))
    assert kernels.launch_counts()["scan_insert"] == before


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("estimator,blur,free_impl,model", [
    ("const", True, "dda", "bayes_avg"), ("area", True, "polar", "tbm"),
    ("area", False, "dda", "bayes_base")])
def test_ordered_yardstick_equals_twin(form, estimator, blur, free_impl, model):
    """``kernels.scan_insert_ordered`` (the samples summed on the host with
    ``np.add.at``, then the same fold), the yardstick the card's kernel is
    held to bit for bit, gives the twin's cells bit for bit on the CPU."""
    n_maps = 1 if form == "one map" else 3
    _, tm_cls, kw = MODELS[model]
    cfg = _beam(False, estimator, blur, free_impl, 6.0)
    ranges, bearings, valid = (torch.from_numpy(a) for a in _scans(n_maps, holes=True))
    cells, origins = torch.from_numpy(_cells(model, n_maps)), torch.from_numpy(_origin(n_maps))
    poses, q = torch.from_numpy(np.float32(POSES[:n_maps])), torch.tensor(0.5)
    if form == "one map":
        gm = tgrid.GridMap(cells=cells[0], origin=origins[0], scale=SCALE)
        args = (gm, tm_cls(**kw), poses[0], tscan.LaserScan(ranges[0], bearings[0], valid[0]),
                cfg, q)
    else:
        gm = tgrid.GridMap(cells=cells, origin=origins, scale=SCALE)
        args = (gm, tm_cls(**kw), poses, tscan.LaserScan(ranges, bearings, valid), cfg, q,
                WINDOW if form == "windows" else 0)
    want = kernels.scan_insert_ref(*args)
    got = kernels.scan_insert_ordered(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(got, gm.cells)


@pytest.mark.parametrize("form", FORMS)
def test_runs_count_the_twins_occupied_samples(form):
    """``kernels.scan_insert_runs``: every occupied sample of the twin's
    ``index_put_`` list lands in one cell (the invalid and off-map ones in
    cell 0), and every cell with occupied evidence has a run."""
    n_maps = 1 if form == "one map" else 3
    cfg = _beam(False, "const", True, "dda", 6.0)
    ranges, bearings, valid = (torch.from_numpy(a) for a in _scans(n_maps, holes=True))
    poses, origins = torch.from_numpy(np.float32(POSES[:n_maps])), torch.from_numpy(
        _origin(n_maps))
    window = WINDOW if form == "windows" else 0
    if form == "one map":
        gm = tgrid.GridMap(cells=torch.from_numpy(_cells("bayes_avg", 1)[0]), origin=origins[0],
                           scale=SCALE)
        pose, scan = poses[0], tscan.LaserScan(ranges[0], bearings[0], valid[0])
        _, s_obs = tray.scan_observation_planes(gm, pose, scan, cfg)
        s_obs = s_obs[None]
    else:
        gm = tgrid.GridMap(cells=torch.from_numpy(_cells("bayes_avg", n_maps)), origin=origins,
                           scale=SCALE)
        pose, scan = poses, tscan.LaserScan(ranges, bearings, valid)
        side = WINDOW if window else SIZE
        _, _, win = tgrid.window_corner(origins, poses[:, :2], SCALE, side, side, SIZE, SIZE)
        _, s_obs = tray.scan_observation_planes_batched(win, side, side, SCALE, pose, scan, cfg)
    runs = kernels.scan_insert_runs(gm, pose, scan, cfg, window)
    assert runs.shape == s_obs.shape and runs.dtype == torch.int64
    assert torch.equal(runs.sum((1, 2)), torch.full((n_maps,), N_BEAMS * (1 + cfg.blur_samples)))
    assert bool((runs[s_obs > 0] > 0).all()) and int(runs.max()) >= 32
