"""Port parity of slice 4, the GMapping RBPF (``models/gmapping.py``).

Small shapes: 6 particles, 96^2 maps at 0.2 m (the cecum world fits, so no
sample falls off a map), 64^2 match and insert windows (``fast_config``
with a 2.5 m usable range), 120 beams, 8 scans. The reference's step is
jitted once a proposal in a module-scoped fixture; its random numbers are
rebuilt from its key chain (``split(key, 4)``: proposal normals, a match
key a particle, the resampling offset) and handed to the port as
:class:`Draws`.

Tolerances: poses 2e-6 (a score summed in another order moves a matched
pose by nothing unless a round is decided by ~1e-7; the improved proposal's
moments are J-term sums), log-weights 1e-5 (gamma x log of such a score),
ancestors exact, map cells 1e-5 (folds of the same counts). Each step is
compared from the reference's own state, crossed to the port through
``convert``, and the whole run from the port's own state (there the
log-weights, sums of 8 increments, within 3e-5). The reference
wraps a sample that falls off an insert window into the window's last
cell (trap g); the port drops it, so that cell of each window is left out
of the map comparison (the sequence here clamps windows at the map's edge
but puts no sample off a window).
"""

import dataclasses
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import gmapping as jgm
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu_torch.models import gmapping as tgm
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import kernels as tkernels
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scoring as tscore
from slam_constructor_tpu_torch.ops.scan import LaserScan
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen as tdata

torch.set_num_threads(1)

P, MAP, SCALE, N_BEAMS, N_SCANS = 6, 96, 0.2, 120, 8
FAST = dict(n_particles=P, map_size=MAP, map_scale=SCALE, usable_range=2.5)
POSE_TOL, LOGW_TOL, CELL_TOL = 2e-6, 1e-5, 1e-5
#: a log-weight is a sum over the steps of its increments: over the whole
#: run each step's difference (up to ~2e-6 with the improved proposal's
#: gamma = 8 on J probe scores) adds up, 8 steps to ~1e-5 (measured 1.04e-5)
LOGW_RUN_TOL = 3e-5

#: fields of the reference that choose a TPU lowering; the port leaves them out
TPU_ONLY = {
    "ScoringConfig": {"impl", "dtype"},
    "BeamConfig": {"scatter_impl"},
    "GMappingConfig": {"match_window_impl", "insert_impl"},
}


def _as_tree(obj):
    if dataclasses.is_dataclass(obj):
        left_out = TPU_ONLY.get(type(obj).__name__, set())
        return type(obj).__name__, {
            f.name: _as_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if f.name not in left_out}
    return obj


def configs(proposal):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the improved proposal's warning, on both sides
        j, t = jgm.fast_config(proposal=proposal, **FAST), tgm.fast_config(proposal=proposal, **FAST)
    if proposal == "improved":  # the minimumScore gate on: it turns back 1 to 4 of the 6 particles a scan
        j = dataclasses.replace(j, min_match_prob=0.7)
        t = dataclasses.replace(t, min_match_prob=0.7)
    return j, t


def reference_draws(key, cfg):
    """The reference step's random numbers from its key; returns the
    port's Draws and the key after the step."""
    key, k_noise, k_match, k_res = jax.random.split(key, 4)
    mc = cfg.matcher_cfg
    keys = jax.random.split(k_match, cfg.n_particles)
    improved = cfg.proposal == "improved"
    if improved:
        pairs = jax.vmap(jax.random.split)(keys)
        keys, k_prop = pairs[:, 0], pairs[:, 1]
        kjs = jax.vmap(jax.random.split)(k_prop)
    match = jax.vmap(lambda k: jax.vmap(lambda kr: jax.random.normal(kr, (mc.batch, 3)))(
        jax.random.split(k, mc.rounds)))(keys)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    draws = tgm.Draws(
        proposal=t(jax.random.normal(k_noise, (cfg.n_particles, 3))),
        u0=t(jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / cfg.n_particles)),
        match=t(match),
        probe=t(jax.vmap(lambda k: jax.random.normal(k, (cfg.proposal_samples, 3)))(kjs[:, 0]))
        if improved else None,
        sample=t(jax.vmap(lambda k: jax.random.normal(k, (3,)))(kjs[:, 1])) if improved else None,
    )
    return draws, key


def state_tree(st):
    return {"cells": np.asarray(st.gm.cells), "origin": np.asarray(st.gm.origin),
            "scale": st.gm.scale, "poses": np.asarray(st.poses),
            "log_weights": np.asarray(st.log_weights), "key": np.asarray(st.key),
            "step": int(st.step)}


@pytest.fixture(scope="module")
def seq():
    occ, origin, scale = tdata.cecum_world()
    poses = tdata.rectangle_trajectory(step=0.12)[:N_SCANS]
    scans, odom, gt = tdata.synth_sequence(
        occ, origin, scale, poses, tdata.default_bearings(N_BEAMS), rng=3,
        odom_noise_xy=0.02, odom_noise_theta=0.01)
    return scans, odom, gt


@pytest.fixture(scope="module", params=["odom", "improved"])
def run(request, seq):
    """The reference's 8 steps: states before and after each, its draws and
    ancestors."""
    scans, odom, gt = seq
    jcfg, tcfg = configs(request.param)
    step = jax.jit(partial(jgm.gmapping_step, jcfg))
    st = jgm.init_state(jcfg, jax.random.PRNGKey(0))
    st = st.replace(poses=jnp.broadcast_to(jnp.asarray(gt[0].numpy()), (P, 3)))
    trees, draws, ancestors = [state_tree(st)], [], []
    for i in range(N_SCANS):
        d, _ = reference_draws(st.key, jcfg)
        js = JScan(ranges=jnp.asarray(scans.ranges[i].numpy()),
                   bearings=jnp.asarray(scans.bearings[i].numpy()), valid=jnp.asarray(scans.valid[i].numpy()))
        st, idx = step(st, js, jnp.asarray(odom[i].numpy()))
        trees.append(state_tree(st))
        draws.append(d)
        ancestors.append(np.asarray(idx))
    return dict(proposal=request.param, jcfg=jcfg, tcfg=tcfg, trees=trees, draws=draws,
                ancestors=np.stack(ancestors), scans=scans, odom=odom, gt=gt)


def pose_diff(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[..., 2] = np.arctan2(np.sin(d[..., 2]), np.cos(d[..., 2]))
    return np.abs(d).max()


def wrap_cells(poses, wi, size, scale):
    """(slot, row, col) of the map cell that the last cell of each slot's
    insert window lands on, the window placed around the slot's pose: where
    the reference wraps the samples that fall off the window (trap g)."""
    poses = torch.as_tensor(poses)
    origin = torch.full((poses.shape[0], 2), -size * scale / 2)
    row, col, _ = tgrid.window_corner(origin, poses[:, :2], scale, wi, wi, size, size)
    return [(p, int(row[p]) + wi - 1, int(col[p]) + wi - 1) for p in range(poses.shape[0])]


def cells_diff(a, b, skip=()):
    d = np.abs(np.asarray(a) - np.asarray(b))
    for p, r, c in skip:
        d[p, r, c] = 0.0
    return d.max()


def test_gmapping_config_lockstep():
    jnames = {f.name for f in dataclasses.fields(jgm.GMappingConfig)}
    tnames = {f.name for f in dataclasses.fields(tgm.GMappingConfig)}
    assert jnames - tnames == TPU_ONLY["GMappingConfig"] and tnames <= jnames
    assert _as_tree(tgm.GMappingConfig()) == _as_tree(jgm.GMappingConfig())
    for kwargs in (dict(), dict(n_particles=8, map_size=128, usable_range=4.0, stride=1), FAST):
        j, t = jgm.fast_config(**kwargs), tgm.fast_config(**kwargs)
        assert j.beam.free_impl == t.beam.free_impl == "dda"  # pinned, as the CPU reference runs
        assert _as_tree(t) == _as_tree(j)
    assert tgm.fast_config().match_window == tgm.fast_config().insert_window == 160
    with pytest.warns(UserWarning), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        j = jgm.fast_config(proposal="improved")
    with pytest.warns(UserWarning):
        t = tgm.fast_config(proposal="improved")
    assert _as_tree(t) == _as_tree(j)


@pytest.mark.parametrize("make", [
    lambda: tgm.GMappingConfig(refine_matcher="gradient"),
    lambda: tgm.GMappingConfig(refine_matcher="hill_climbing"),
    lambda: tgm.GMappingConfig(matcher="m3rsm"),
])
def test_fields_of_later_slices_raise(make):
    """Every matcher of the registry now runs in both RBPF slots: these
    configs build, and only a name outside the registry raises."""
    cfg = make()
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, matcher="nope")
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, refine_matcher="nope")


def test_window_view_batched_is_bitwise(run):
    """P windows in one gather equal the reference's window of each map."""
    tree, cfg = run["trees"][4], run["jcfg"]
    centers = tree["poses"][:, :2] + np.array([[0.7, -0.3]] * P, np.float32) * (np.arange(P)[:, None] - 2)
    jgm_ = jgrid.GridMap(cells=jnp.asarray(tree["cells"]), origin=jnp.asarray(tree["origin"]),
                         scale=tree["scale"])
    jv = jax.vmap(lambda g, c: jscore.window_view(jscore.MapView.of(g, cfg.cell_model), c, 40))(
        jgm_, jnp.asarray(centers))
    st = convert.gmapping_state_from_numpy(tree, "cpu")
    tv = tscore.window_view(tscore.MapView.of(st.gm, cfg.cell_model), torch.from_numpy(centers), 40)
    assert tv.occ.shape == (P, 40, 40) and tv.origin.shape == (P, 2)
    np.testing.assert_array_equal(tv.occ.numpy(), np.asarray(jv.occ))
    np.testing.assert_array_equal(tv.known.numpy(), np.asarray(jv.known))
    np.testing.assert_array_equal(tv.origin.numpy(), np.asarray(jv.origin))


def test_batched_match_twin_matches_vmapped_reference(run):
    """The particle-axis match (the kernel's twin on the CPU) against a
    vmap of the reference's ``monte_carlo_match``, each particle with its
    own key's normals: poses within 2e-6 and the same best particle."""
    tree, cfg, scans = run["trees"][5], run["jcfg"], run["scans"]
    mc, win = cfg.matcher_cfg, cfg.match_window
    priors = tree["poses"] + np.random.default_rng(1).normal(0, [0.05, 0.05, 0.02], (P, 3)).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), P)
    js = JScan(ranges=jnp.asarray(scans.ranges[5].numpy()), bearings=jnp.asarray(scans.bearings[5].numpy()),
               valid=jnp.asarray(scans.valid[5].numpy()))
    jgm_ = jgrid.GridMap(cells=jnp.asarray(tree["cells"]), origin=jnp.asarray(tree["origin"]),
                         scale=tree["scale"])

    def one(g, prior, key):
        view = jscore.window_view(jscore.MapView.of(g, cfg.cell_model), prior[:2], win)
        return jmatch.monte_carlo_match(view, js, prior, key, mc)

    jres = jax.jit(jax.vmap(one))(jgm_, jnp.asarray(priors), keys)
    noise = np.array(jax.vmap(lambda k: jax.vmap(lambda kr: jax.random.normal(kr, (mc.batch, 3)))(
        jax.random.split(k, mc.rounds)))(keys))
    st = convert.gmapping_state_from_numpy(tree, "cpu")
    tp = torch.from_numpy(priors)
    view = tscore.window_view(tscore.MapView.of(st.gm, cfg.cell_model), tp[:, :2], win)
    s = scans[5]
    tscans = LaserScan(s.ranges.expand(P, -1), s.bearings.expand(P, -1), s.valid.expand(P, -1))
    tres = tmatch.monte_carlo_match(view, tscans, tp, cfg=run["tcfg"].matcher_cfg,
                                    noise=torch.from_numpy(noise))
    assert tres.pose.shape == (P, 3) and tres.prob.shape == (P,) and tres.trace.shape == (P, mc.rounds)
    assert pose_diff(tres.pose.numpy(), np.asarray(jres.pose)) <= POSE_TOL
    np.testing.assert_allclose(tres.prob.numpy(), np.asarray(jres.prob), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(tres.trace.numpy(), np.asarray(jres.trace), atol=POSE_TOL, rtol=0)
    assert int(tres.prob.argmax()) == int(np.argmax(np.asarray(jres.prob)))


def test_step_from_reference_state_matches(run):
    """Every step, from the reference's state before it, with its draws."""
    tcfg = run["tcfg"]
    for i in range(N_SCANS):
        before, after = run["trees"][i], run["trees"][i + 1]
        st = convert.gmapping_state_from_numpy(before, "cpu")
        st, idx = tgm.gmapping_step(tcfg, st, run["scans"][i], run["odom"][i], run["draws"][i])
        np.testing.assert_array_equal(idx.numpy(), run["ancestors"][i])
        assert pose_diff(st.poses.numpy(), after["poses"]) <= POSE_TOL, i
        np.testing.assert_allclose(st.log_weights.numpy(), after["log_weights"], atol=LOGW_TOL, rtol=0)
        # slot p now holds the map that the scan went into at pose p
        skip = wrap_cells(st.poses, tcfg.insert_window, MAP, SCALE)
        assert cells_diff(st.gm.cells.numpy(), after["cells"], skip) <= CELL_TOL
        assert int(st.step) == after["step"]
        # with the draws handed in the key still advances as the reference's
        np.testing.assert_array_equal(convert.key_to_numpy(st.key), after["key"])


def test_step_from_its_key_matches_bit_for_bit(run):
    """Every step from the reference's state with no draws handed in: the
    port draws the step from the state's key as the jitted reference does
    (the proposal's numbers and the particles' match keys in the step's one
    ``prng_draws`` launch, each match's numbers from its key in K5's
    prologue; each prior and candidate one fused multiply-add of
    ``erf_inv(u)`` and ``sqrt(2) sigma``). With the
    odometry proposal the matched poses equal the reference's bit for bit:
    a round's winner could part only where scores summed in another order
    (ROADMAP trap k) tie to within their rounding, which no step here
    meets. The improved proposal samples from moments over its probes
    (sums again): within ``POSE_TOL``."""
    tcfg = run["tcfg"]
    for i in range(N_SCANS):
        before, after = run["trees"][i], run["trees"][i + 1]
        st = convert.gmapping_state_from_numpy(before, "cpu")
        st, idx = tgm.gmapping_step(tcfg, st, run["scans"][i], run["odom"][i])
        np.testing.assert_array_equal(idx.numpy(), run["ancestors"][i])
        if run["proposal"] == "odom":
            np.testing.assert_array_equal(st.poses.numpy().view(np.uint32),
                                          after["poses"].view(np.uint32), err_msg=str(i))
        else:
            assert pose_diff(st.poses.numpy(), after["poses"]) <= POSE_TOL, i
        np.testing.assert_allclose(st.log_weights.numpy(), after["log_weights"], atol=LOGW_TOL,
                                   rtol=0)
        np.testing.assert_array_equal(convert.key_to_numpy(st.key), after["key"])


def test_step_matches_on_windows_in_place(run, monkeypatch):
    """The odometry proposal's step matches every particle on its window
    read in place (``kernels.mc_match_windows``; nothing cuts a window
    out); the improved proposal with the gate cuts them out once a step for
    all its scores. Either way the step from the reference's state holds
    the reference's tolerances."""
    tcfg = run["tcfg"]
    cuts, in_place = [], []
    cut, windows = tscore.WindowView.cut, tkernels.mc_match_windows
    monkeypatch.setattr(tscore.WindowView, "cut", lambda self: cuts.append(1) or cut(self))
    monkeypatch.setattr(tkernels, "mc_match_windows", lambda *a: in_place.append(1) or windows(*a))
    i = 5
    before, after = run["trees"][i], run["trees"][i + 1]
    st = convert.gmapping_state_from_numpy(before, "cpu")
    st, idx = tgm.gmapping_step(tcfg, st, run["scans"][i], run["odom"][i], run["draws"][i])
    assert (len(cuts), len(in_place)) == ((0, 1) if run["proposal"] == "odom" else (1, 0))
    np.testing.assert_array_equal(idx.numpy(), run["ancestors"][i])
    assert pose_diff(st.poses.numpy(), after["poses"]) <= POSE_TOL
    np.testing.assert_allclose(st.log_weights.numpy(), after["log_weights"], atol=LOGW_TOL, rtol=0)
    skip = wrap_cells(st.poses, tcfg.insert_window, MAP, SCALE)
    assert cells_diff(st.gm.cells.numpy(), after["cells"], skip) <= CELL_TOL


def test_whole_run_matches_reference(run):
    """8 scans from the port's own state, every step's draws injected."""
    tcfg, trees = run["tcfg"], run["trees"]
    e = tgm.GMappingEngine(tcfg, device="cpu")
    e.state.poses = run["gt"][0].expand(P, 3).clone()
    draws = tgm.Draws(**{f.name: None if getattr(run["draws"][0], f.name) is None else torch.stack(
        [getattr(d, f.name) for d in run["draws"]]) for f in dataclasses.fields(tgm.Draws)})
    traj, neffs = e.run(run["scans"], run["odom"], draws=draws)
    all_poses, ancestors = e.genealogy
    np.testing.assert_array_equal(ancestors.numpy(), run["ancestors"])
    want = np.stack([t["poses"] for t in trees[1:]])
    assert pose_diff(all_poses.numpy(), want) <= POSE_TOL
    np.testing.assert_allclose(e.state.log_weights.numpy(), trees[-1]["log_weights"],
                               atol=LOGW_RUN_TOL, rtol=0)
    assert cells_diff(e.state.gm.cells.numpy(), trees[-1]["cells"]) <= CELL_TOL
    best = np.argmax(np.stack([t["log_weights"] for t in trees[1:]]), axis=1)
    assert pose_diff(traj.numpy(), want[np.arange(N_SCANS), best]) <= POSE_TOL
    np.testing.assert_allclose(
        neffs.numpy(), [float(jgm.neff(jgm.GMappingState(
            gm=None, poses=None, log_weights=jnp.asarray(t["log_weights"]), key=None, step=None)))
            for t in trees[1:]], rtol=1e-5)
    if run["proposal"] == "odom":
        assert bool((neffs[1:] < P).all())  # the weights moved once the maps held something


@pytest.mark.parametrize("refine", ["brute_force", "monte_carlo"])
def test_refine_matches_reference(seq, refine):
    """The optional refine pass of every particle: a brute-force grid, or
    a second Monte-Carlo match that reuses the match's normals (the
    reference refines with the match's key)."""
    jcfg, tcfg = configs("odom")
    jsc, tsc = jscore.ScoringConfig(reducer="overlap", stride=2), tscore.ScoringConfig(
        reducer="overlap", stride=2)
    if refine == "brute_force":
        grid = dict(half_x=0.1, half_y=0.1, half_theta=0.05, n_x=3, n_y=3, n_theta=3)
        jr, tr = jmatch.BruteForceConfig(**grid, scoring=jsc), tmatch.BruteForceConfig(**grid, scoring=tsc)
    else:
        jr, tr = jcfg.matcher_cfg, tcfg.matcher_cfg
    jcfg = dataclasses.replace(jcfg, refine_matcher=refine, refine_cfg=jr)
    tcfg = dataclasses.replace(tcfg, refine_matcher=refine, refine_cfg=tr)
    steps_from_reference(jcfg, tcfg, seq)


def test_whole_map_match_and_insert_match_reference(seq):
    """Without windows (``match_window = insert_window = 0``, the config's
    defaults): the match on the whole map, the insert into the whole map."""
    jcfg, tcfg = configs("odom")
    jcfg = dataclasses.replace(jcfg, match_window=0, insert_window=0)
    tcfg = dataclasses.replace(tcfg, match_window=0, insert_window=0)
    steps_from_reference(jcfg, tcfg, seq, cells=True)


def steps_from_reference(jcfg, tcfg, seq, cells=False):
    """Steps 1 to 3 of the sequence, each from the reference's state before
    it with its draws (step 0 on empty maps scores every pose alike)."""
    scans, odom, gt = seq
    step = jax.jit(partial(jgm.gmapping_step, jcfg))
    st = jgm.init_state(jcfg, jax.random.PRNGKey(2))
    st = st.replace(poses=jnp.broadcast_to(jnp.asarray(gt[0].numpy()), (P, 3)))
    for i in range(4):
        d, _ = reference_draws(st.key, jcfg)
        before = convert.gmapping_state_from_numpy(state_tree(st), "cpu")
        js = JScan(ranges=jnp.asarray(scans.ranges[i].numpy()),
                   bearings=jnp.asarray(scans.bearings[i].numpy()), valid=jnp.asarray(scans.valid[i].numpy()))
        st, idx = step(st, js, jnp.asarray(odom[i].numpy()))
        if i == 0:
            continue
        got, got_idx = tgm.gmapping_step(tcfg, before, scans[i], odom[i], d)
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
        assert pose_diff(got.poses.numpy(), np.asarray(st.poses)) <= POSE_TOL
        np.testing.assert_allclose(got.log_weights.numpy(), np.asarray(st.log_weights), atol=LOGW_TOL,
                                   rtol=0)
        if cells:
            assert cells_diff(got.gm.cells.numpy(), np.asarray(st.gm.cells)) <= CELL_TOL


def test_winner_and_weighted_mean_trajectories_match_reference():
    """A seeded genealogy: the winner's path exactly, the weighted mean
    within 1e-6."""
    rng = np.random.default_rng(4)
    t, p = 40, 9
    all_poses = rng.normal(0, 1, (t, p, 3)).astype(np.float32)
    all_poses[..., 2] = rng.uniform(-3.1, 3.1, (t, p))
    ancestors = np.where(rng.random((t, p)) < 0.3, rng.integers(0, p, (t, p)), np.arange(p)).astype(np.int32)
    logw = rng.normal(0, 2, p).astype(np.float32)
    for winner in (0, 4, p - 1):
        j = np.asarray(jgm.winner_trajectory(jnp.asarray(all_poses), jnp.asarray(ancestors), winner))
        tt = tgm.winner_trajectory(torch.from_numpy(all_poses), torch.from_numpy(ancestors).long(),
                                   torch.tensor(winner))
        np.testing.assert_array_equal(tt.numpy(), j)
    j = np.asarray(jgm.weighted_mean_trajectory(jnp.asarray(all_poses), jnp.asarray(ancestors),
                                                jnp.asarray(logw)))
    tt = tgm.weighted_mean_trajectory(torch.from_numpy(all_poses), torch.from_numpy(ancestors).long(),
                                      torch.from_numpy(logw))
    assert pose_diff(tt.numpy(), j) <= 1e-6


def test_convert_round_trip(run):
    tree = run["trees"][3]
    st = convert.gmapping_state_from_numpy(tree, "cpu")
    back = convert.gmapping_state_to_numpy(st)
    assert set(back) == set(tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k], v)


def test_online_equals_offline_and_entry_points(run):
    """handle_scan draws from the state's key as run does;
    without a card the entry points raise and say how to ask for the CPU."""
    tcfg, scans, odom = run["tcfg"], run["scans"], run["odom"]
    a = tgm.GMappingEngine(tcfg, device="cpu", seed=5)
    traj, _ = a.run(scans[:3], odom[:3])
    b = tgm.GMappingEngine(tcfg, device="cpu", seed=5)
    for i in range(3):
        b.handle_scan(scans[i], odom[i])
    assert torch.equal(torch.stack(b.trajectory), traj)
    assert torch.equal(a.state.gm.cells, b.state.gm.cells)
    assert a.occupancy.shape == (MAP, MAP) and a.winner_trajectory().shape == (3, 3)
    with pytest.raises(RuntimeError, match="run"):
        b.winner_trajectory()
    if not torch.cuda.is_available():
        tree = convert.gmapping_state_to_numpy(a.state)
        for call in (lambda: tgm.GMappingEngine(tcfg), lambda: tgm.init_state(tcfg),
                     lambda: convert.gmapping_state_from_numpy(tree)):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()


def test_windowed_insert_drops_what_the_reference_wraps():
    """Trap g in the windowed insert: windows clamped at the edge of a
    4.8 m map, beams along the corridor reaching 6 m, off the map. The
    reference adds those samples to the window's last cell, an interior
    cell of the map; the port drops them. Everywhere else the maps agree
    within 1e-5."""
    size, wi, beam = 48, 32, dict(max_range=6.0)
    jcfg = jgm.GMappingConfig(n_particles=2, map_height=size, map_width=size, insert_window=wi,
                              beam=jray.BeamConfig(**beam))
    occ, origin, scale = tdata.cecum_world()
    poses = torch.tensor([[-1.5, -1.5, 0.0], [1.5, -1.2, 3.0]])
    cast = [tray.cast_rays(occ, origin, scale, p, tdata.default_bearings(N_BEAMS)) for p in poses]
    scans = LaserScan(*(torch.stack([getattr(c, f) for c in cast]) for f in ("ranges", "bearings", "valid")))
    st = tgm.init_state(tgm.GMappingConfig(n_particles=2, map_height=size, map_width=size), "cpu")
    got = tray.insert_scan_windows(st.gm, tgm.GMappingConfig().cell_model, poses, scans,
                                   tray.BeamConfig(**beam), wi)
    jst = jgm.init_state(jcfg)
    js = JScan(ranges=jnp.asarray(scans.ranges.numpy()), bearings=jnp.asarray(scans.bearings.numpy()),
               valid=jnp.asarray(scans.valid.numpy()))
    want = jax.vmap(lambda g, p, sc: _reference_window_insert(jcfg, g, p, sc))(
        jst.gm, jnp.asarray(poses.numpy()), js)
    skip = wrap_cells(poses, wi, size, 0.1)
    d = np.abs(got.cells.numpy() - np.asarray(want))
    assert min(float(d[p, r, c].max()) for p, r, c in skip) > 1.0  # the wrapped samples
    for p, r, c in skip:
        assert 0 < r < size - 1  # an interior row of the map
        d[p, r, c] = 0.0
    assert d.max() <= CELL_TOL


def _reference_window_insert(cfg, gm_p, pose_p, scan):
    """The windowed insert of the reference's ``gmapping_step`` for one
    particle (its ``insert_impl='slice'`` form, an inner function there)."""
    h, w, c = gm_p.cells.shape
    wi = min(cfg.insert_window, h, w)
    rel = (pose_p[:2] - gm_p.origin) / gm_p.scale
    col = jnp.clip(jnp.floor(rel[0]).astype(jnp.int32) - wi // 2, 0, w - wi)
    row = jnp.clip(jnp.floor(rel[1]).astype(jnp.int32) - wi // 2, 0, h - wi)
    win_origin = gm_p.origin + jnp.stack([col, row]).astype(jnp.float32) * gm_p.scale
    sub = jax.lax.dynamic_slice(gm_p.cells, (row, col, 0), (wi, wi, c))
    sub_gm = jgrid.GridMap(cells=sub, origin=win_origin, scale=gm_p.scale)
    sub_gm = jray.insert_scan(sub_gm, cfg.cell_model, pose_p, scan, cfg.beam)
    return jax.lax.dynamic_update_slice(gm_p.cells, sub_gm.cells, (row, col, 0))
