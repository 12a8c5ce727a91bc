"""Every stochastic entry point of the port drawing from the reference's
threefry key, on the CPU, against the reference run from the same key.

- ``datagen.synth_sequence`` with a key: the reference's sequence bit for
  bit (``split(key, T + 1)``, range noise a scan, odometry noise last).
- ``Engine`` (tiny, viny), dense ``GMappingEngine`` (odometry and improved
  proposal), the copy-on-write RBPF, the loop-closing pipeline: the port's
  run from ``seed=s`` (the reference's ``PRNGKey(s)``) against the
  reference's from ``key=PRNGKey(s)``: the key after the run bit for bit,
  the trajectories within 1e-4 m (the parity tests' bound); and against
  the port's own run with the reference's draws injected, bit for bit.
- Both CLIs on ``--synthetic`` (their data drawn from ``PRNGKey(0)``, and
  the engine's key) at 8 small steps agree within 1e-4 m.

Test sizes: 96 beams, maps of at most 160^2, 8 steps (6 for the RBPFs).
"""

import dataclasses
import json
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu import run as jrun
from slam_constructor_tpu.models import engine as jeng
from slam_constructor_tpu.models import full as jfull
from slam_constructor_tpu.models import gmapping as jgm
from slam_constructor_tpu.models import posegraph as jpg
from slam_constructor_tpu.models import tiny as jtiny
from slam_constructor_tpu.models import viny as jviny
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch import run as trun
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.models import full as tfull
from slam_constructor_tpu_torch.models import gmapping as tgm
from slam_constructor_tpu_torch.models import posegraph as tpg
from slam_constructor_tpu_torch.models import tiny as ttiny
from slam_constructor_tpu_torch.models import viny as tviny
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import prng
from slam_constructor_tpu_torch.ops import scoring as tscore
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen as tdata
from slam_constructor_tpu_torch.utils import trajectory as ttraj

torch.set_num_threads(1)

N, BEAMS, MAP, BATCH, ROUNDS = 8, 96, 160, 16, 4
POSE_TOL = 1e-4


def jscans(scans):
    return JScan(ranges=jnp.asarray(scans.ranges.numpy()),
                 bearings=jnp.asarray(scans.bearings.numpy()), valid=jnp.asarray(scans.valid.numpy()))


def pose_diff(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[..., 2] = np.arctan2(np.sin(d[..., 2]), np.cos(d[..., 2]))
    return float(np.abs(d).max())


@pytest.fixture(scope="module")
def seq():
    """The sequence both sides run: drawn from the reference's key by the
    port (the first test holds it to the reference's)."""
    occ, origin, scale = tdata.cecum_world()
    poses = tdata.rectangle_trajectory(step=0.1)[:N]
    return tdata.synth_sequence(occ, origin, scale, poses, tdata.default_bearings(BEAMS),
                                rng=prng.key(42), odom_noise_xy=0.02, odom_noise_theta=0.01)


@pytest.mark.parametrize("range_noise", (0.0, 0.01))
def test_synth_sequence_from_the_reference_key(range_noise):
    occ, origin, scale = tdata.cecum_world()
    jocc, jorigin, jscale = jdata.cecum_world()
    poses = tdata.rectangle_trajectory(step=0.1)[:N]
    kw = dict(odom_noise_xy=0.02, odom_noise_theta=0.01, range_noise=range_noise)
    scans, odom, gt = tdata.synth_sequence(occ, origin, scale, poses,
                                           tdata.default_bearings(BEAMS), rng=prng.key(42), **kw)
    js, jodom, jgt = jdata.synth_sequence(jocc, jorigin, jscale, jnp.asarray(poses.numpy()),
                                          jdata.default_bearings(BEAMS), jax.random.PRNGKey(42),
                                          **kw)
    np.testing.assert_array_equal(odom.numpy(), np.asarray(jodom))
    np.testing.assert_array_equal(scans.ranges.numpy(), np.asarray(js.ranges))
    np.testing.assert_array_equal(scans.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))
    # the numpy-seeded form stays: another sequence, the same poses
    _, odom_np, _ = tdata.synth_sequence(occ, origin, scale, poses,
                                         tdata.default_bearings(BEAMS), rng=42, **kw)
    assert not torch.equal(odom_np, odom)


def engine_noise(key, n, mc, erf_inv=False):
    """The reference's matcher normals of ``n`` engine steps from ``key``;
    with ``erf_inv``, the ``erf_inv(u)`` values its jitted match multiplies
    by ``sqrt(2) * sigma`` (the normals before their last multiply), as
    ``matchers.ErfInvDraws``."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    draw = jax.jit(jax.vmap(
        (lambda k: jax.lax.erf_inv(jax.random.uniform(k, (mc.batch, 3), minval=lo, maxval=1.0)))
        if erf_inv else (lambda k: jax.random.normal(k, (mc.batch, 3)))))
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(draw(jax.random.split(sub, mc.rounds))))
    out = torch.from_numpy(np.stack(out))
    return (tmatch.ErfInvDraws(out) if erf_inv else out), key


def engine_configs(name):
    if name == "tiny":
        return (jtiny.tiny_config(map_size=MAP, mc_batch=BATCH, mc_rounds=ROUNDS),
                ttiny.tiny_config(map_size=MAP, mc_batch=BATCH, mc_rounds=ROUNDS))
    j = jviny.viny_config(map_size=MAP, mc_batch=BATCH, mc_rounds=ROUNDS)
    return (dataclasses.replace(j, beam=dataclasses.replace(j.beam, free_impl="polar")),
            tviny.viny_config(map_size=MAP, mc_batch=BATCH, mc_rounds=ROUNDS))


@pytest.mark.parametrize("name,seed", [("tiny", 3), ("viny", 2**32 + 7)])
def test_engine_from_a_seed_is_the_reference_from_its_key(seq, name, seed):
    scans, odom, gt = seq
    jcfg, tcfg = engine_configs(name)
    if name == "tiny":  # the reference picks its free fill by backend (trap a)
        jcfg = dataclasses.replace(jcfg, beam=dataclasses.replace(jcfg.beam, free_impl="dda"))
    jst = jeng.init_state(jcfg, jax.random.PRNGKey(seed)).replace(pose=jnp.asarray(gt[0].numpy()))
    jfinal, jtraj, _ = jeng.run_sequence(jcfg, jst, jscans(scans), jnp.asarray(odom.numpy()))
    e = teng.Engine(tcfg, device="cpu", seed=seed)
    e.state.pose = gt[0].clone()
    traj, _ = e.run(scans, odom)
    np.testing.assert_array_equal(convert.key_to_numpy(e.state.key), np.asarray(jfinal.key))
    assert pose_diff(traj.numpy(), jtraj) <= POSE_TOL
    # the same run with the reference's draws injected (its normals before
    # their multiply by sqrt(2), as the keyed match draws them): the same bits
    noise, _ = engine_noise(jax.random.PRNGKey(seed), N, tcfg.matcher_cfg, erf_inv=True)
    f = teng.Engine(tcfg, device="cpu", seed=seed)
    f.state.pose = gt[0].clone()
    traj_f, _ = f.run(scans, odom, noise=noise)
    assert torch.equal(traj_f, traj) and torch.equal(f.state.key, e.state.key)
    assert torch.equal(f.state.gm.cells, e.state.gm.cells)


GP, GMAP, GSCALE, GN = 6, 96, 0.2, 6


def rbpf_configs(kind):
    fast = dict(n_particles=GP, map_size=GMAP, map_scale=GSCALE, usable_range=2.5)
    proposal = "improved" if kind == "improved" else "odom"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the improved proposal's note, on both sides
        j, t = jgm.fast_config(proposal=proposal, **fast), tgm.fast_config(proposal=proposal, **fast)
    if kind == "improved":
        j = dataclasses.replace(j, min_match_prob=0.7)
        t = dataclasses.replace(t, min_match_prob=0.7)
    if kind == "cow":
        cow = dict(map_storage="cow", tile_block=16, window_tiles=5, tile_capacity=256)
        j, t = dataclasses.replace(j, **cow), dataclasses.replace(t, **cow)
    return j, t


def rbpf_draws(key, cfg):
    """The reference step's draws from ``key`` as the port's Draws, and the
    key after the step; the proposal's and the match's as the ``erf_inv(u)``
    values its jitted step multiplies by ``sqrt(2) * sigma``
    (``matchers.ErfInvDraws``), which the port's step draws (K5 its match's
    from the particles' keys)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    key, k_noise, k_match, k_res = jax.random.split(key, 4)
    mc, p = cfg.matcher_cfg, cfg.n_particles
    keys = jax.random.split(k_match, p)
    kjs = None
    if cfg.proposal == "improved":
        pairs = jax.vmap(jax.random.split)(keys)
        keys, kjs = pairs[:, 0], jax.vmap(jax.random.split)(pairs[:, 1])

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    return tgm.Draws(
        proposal=tmatch.ErfInvDraws(t(jax.lax.erf_inv(jax.random.uniform(
            k_noise, (p, 3), minval=lo, maxval=1.0)))),
        u0=t(jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / p)),
        match=tmatch.ErfInvDraws(t(jax.vmap(lambda k: jax.vmap(lambda kr: jax.lax.erf_inv(
            jax.random.uniform(kr, (mc.batch, 3), minval=lo, maxval=1.0)))(
            jax.random.split(k, mc.rounds)))(keys))),
        probe=None if kjs is None else t(jax.vmap(lambda k: jax.random.normal(
            k, (cfg.proposal_samples, 3)))(kjs[:, 0])),
        sample=None if kjs is None else t(jax.vmap(lambda k: jax.random.normal(k, (3,)))(
            kjs[:, 1]))), key


@pytest.fixture(scope="module")
def rbpf_seq():
    occ, origin, scale = tdata.cecum_world()
    poses = tdata.rectangle_trajectory(step=0.12)[:GN]
    return tdata.synth_sequence(occ, origin, scale, poses, tdata.default_bearings(BEAMS),
                                rng=prng.key(3), odom_noise_xy=0.02, odom_noise_theta=0.01)


@pytest.mark.parametrize("kind", ("odom", "improved", "cow"))
def test_rbpf_from_a_seed_is_the_reference_from_its_key(rbpf_seq, kind):
    """The reference's jitted step from ``PRNGKey(5)``; the port's
    ``GMappingEngine(seed=5)``: the same ancestors every step, the key
    after the run, the particles' poses within 1e-4 m; and the port's run
    with the reference's draws injected, bit for bit."""
    scans, odom, gt = rbpf_seq
    jcfg, tcfg = rbpf_configs(kind)
    step = jax.jit(partial(jgm.gmapping_step, jcfg))
    st = jgm.init_state(jcfg, jax.random.PRNGKey(5))
    st = st.replace(poses=jnp.broadcast_to(jnp.asarray(gt[0].numpy()), (GP, 3)))
    want_poses, want_anc, draws = [], [], []
    for i in range(GN):
        draws.append(rbpf_draws(st.key, jcfg)[0])
        js = JScan(ranges=jnp.asarray(scans.ranges[i].numpy()),
                   bearings=jnp.asarray(scans.bearings[i].numpy()),
                   valid=jnp.asarray(scans.valid[i].numpy()))
        st, idx = step(st, js, jnp.asarray(odom[i].numpy()))
        want_poses.append(np.asarray(st.poses))
        want_anc.append(np.asarray(idx))
    e = tgm.GMappingEngine(tcfg, device="cpu", seed=5)
    e.state.poses = gt[0].expand(GP, 3).clone()
    e.run(scans, odom)
    all_poses, anc = e.genealogy
    np.testing.assert_array_equal(anc.numpy(), np.stack(want_anc))
    assert pose_diff(all_poses.numpy(), np.stack(want_poses)) <= POSE_TOL
    np.testing.assert_array_equal(convert.key_to_numpy(e.state.key), np.asarray(st.key))
    f = tgm.GMappingEngine(tcfg, device="cpu", seed=5)
    f.state.poses = gt[0].expand(GP, 3).clone()
    def stacked(name):
        if draws[0].__dict__[name] is None:
            return None
        if name in ("match", "proposal"):
            return tmatch.ErfInvDraws(torch.stack([d.__dict__[name].values for d in draws]))
        return torch.stack([d.__dict__[name] for d in draws])

    injected = tgm.Draws(**{fld.name: stacked(fld.name) for fld in dataclasses.fields(tgm.Draws)})
    f.run(scans, odom, injected)
    assert torch.equal(f.genealogy[0], all_poses) and torch.equal(f.genealogy[1], anc)
    assert torch.equal(f.state.log_weights, e.state.log_weights)
    assert torch.equal(f.state.key, e.state.key)


def test_full_pipeline_from_a_seed_is_the_reference_from_its_key(seq):
    scans, odom, gt = seq
    track = dict(map_size=MAP, usable_range=4.0, stride=2, mc_batch=BATCH, mc_rounds=ROUNDS)
    graph = dict(max_keyframes=16, max_edges=64, keyframe_distance=0.3, loop_radius=2.0,
                 min_index_gap=6, min_prob=0.55, max_candidates=2, local_map_size=64,
                 gn_iterations=6)
    bf = dict(half_x=0.5, half_y=0.5, half_theta=0.2, n_x=3, n_y=3, n_theta=3)
    jcfg = jfull.FullConfig(tracking=jtiny.fast_config(**track), kf_batch=4,
                            graph=jpg.PoseGraphConfig(**graph, loop_matcher=jmatch.BruteForceConfig(
                                **bf, scoring=jscore.ScoringConfig(reducer="overlap", stride=2))))
    tcfg = tfull.FullConfig(tracking=ttiny.fast_config(**track), kf_batch=4,
                            graph=tpg.PoseGraphConfig(**graph, loop_matcher=tmatch.BruteForceConfig(
                                **bf, scoring=tscore.ScoringConfig(reducer="overlap", stride=2))))
    je = jfull.FullSlamEngine(jcfg, n_beams=BEAMS, key=jax.random.PRNGKey(9))
    je.state = je.state.replace(pose=jnp.asarray(gt[0].numpy()))
    jtraj = np.asarray(je.run(jscans(scans), jnp.asarray(odom.numpy()), segment=N))
    te = tfull.FullSlamEngine(tcfg, n_beams=BEAMS, device="cpu", seed=9)
    te.state.pose = gt[0].clone()
    traj = te.run(scans, odom, segment=N)
    assert pose_diff(traj.numpy(), jtraj) <= POSE_TOL
    np.testing.assert_array_equal(convert.key_to_numpy(te.state.key), np.asarray(je.state.key))
    assert int(te.graph.n_kf) == int(je.graph.n_kf) >= 2
    noise, _ = engine_noise(jax.random.PRNGKey(9), N, tcfg.tracking.matcher_cfg, erf_inv=True)
    tf = tfull.FullSlamEngine(tcfg, n_beams=BEAMS, device="cpu", seed=9)
    tf.state.pose = gt[0].clone()
    assert torch.equal(tf.run(scans, odom, segment=N, noise=noise), traj)


CLI_PROPS = f"""\
cell.model = bayes_avg
matcher.type = monte_carlo
matcher.sigma_xy = 0.08
matcher.sigma_theta = 0.05
matcher.batch = {BATCH}
matcher.rounds = {ROUNDS}
scoring.reducer = overlap
scoring.window = 1
map.height = {MAP}
map.width = {MAP}
map.scale = 0.1
beam.hole_width = 0.3
beam.free_impl = dda
beam.wall_blur = true
"""


def test_both_clis_agree_on_the_synthetic_sequence(tmp_path, capsys):
    """The reference's CLI draws its synthetic sequence from ``PRNGKey(0)``
    and its engine from the default key; so does the port's."""
    props = tmp_path / "cfg.properties"
    props.write_text(CLI_PROPS)
    argv = ["--config", str(props), "--synthetic", "cecum", "--trajectory", "rectangle",
            "--steps", str(N), "--beams", str(BEAMS), "--cpu"]
    ref = jrun.main([*argv, "--out", str(tmp_path / "ref")])
    port = trun.main([*argv, "--out", str(tmp_path / "port")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == port
    assert port["scans"] == ref["scans"] == N
    assert abs(port["ate_m"] - ref["ate_m"]) <= POSE_TOL
    _, got = ttraj.load_tum(str(tmp_path / "port" / "trajectory.tum"))
    _, want = ttraj.load_tum(str(tmp_path / "ref" / "trajectory.tum"))
    assert pose_diff(got, want) <= POSE_TOL
