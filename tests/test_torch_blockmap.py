"""Port parity of the tiled block-pool map: ``ops/blockmap.py`` and
``raycast.scan_sample_cells`` against the reference's, and the engine on
the tiled map.

Blocks of 8 cells, a table of 20 x 20 tiles at 0.1 m (16 m, which holds
the cecum world). Allocation is exact (the same slots, the same
``n_alloc``); the pool's sums are f32 sums of the same samples in another
order, atol 1e-6. Test poses lie off the cell grid: from a pose on a cell
boundary the reference's jitted division by the scale (a product with its
reciprocal) and the port's IEEE division may put a DDA sample in
neighbouring cells.

The insert runs through ``kernels.pool_touched`` and ``kernels.pool_insert``
(K3 over the pool; their plain twins here), which the ordered host sums
match bit for bit with one thread.

Trap n: where the pool is exhausted the reference adds a sample at flat
index -1, which wraps into the last cell of the last block; the port drops
it. The exhaustion test pins that difference and nothing else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import engine as jeng
from slam_constructor_tpu.ops import blockmap as jbm
from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import matchers as jmatchers
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscoring
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.ops import blockmap as tbm
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import matchers as tmatchers
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scoring as tscoring
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen

torch.set_num_threads(1)

B, TILES, SCALE, N_BEAMS = 8, 20, 0.1, 96
MODELS = {"bayes_avg": (jcells.BayesAvgCell(), tcells.BayesAvgCell()),
          "tbm": (jcells.TBMCell(), tcells.TBMCell())}


@pytest.fixture(scope="module")
def seq():
    occ, origin, scale = datagen.cecum_world()
    # the rectangle's first pose, (-5.6, -1.6), lies on the cell grid: start a
    # little off it
    poses = datagen.rectangle_trajectory(step=0.1)[:8] + torch.tensor([0.013, 0.021, 0.0])
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(N_BEAMS), rng=7,
        odom_noise_xy=0.02, odom_noise_theta=0.01)
    return scans, odom, gt


def jscan(scans, i):
    return JScan(jnp.asarray(scans.ranges[i].numpy()), jnp.asarray(scans.bearings[i].numpy()),
                 jnp.asarray(scans.valid[i].numpy()))


def assert_same_bm(ref, port, atol=1e-6):
    np.testing.assert_array_equal(port.table.numpy(), np.asarray(ref.table))
    assert int(port.n_alloc) == int(ref.n_alloc)
    np.testing.assert_allclose(port.pool.numpy(), np.asarray(ref.pool), atol=atol, rtol=0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_make_block_map(model):
    jm, tm = MODELS[model]
    ref = jbm.make_block_map(jm, 5, 7, 11, block=B, scale=SCALE)
    port = tbm.make_block_map(tm, 5, 7, 11, block=B, scale=SCALE, device="cpu")
    assert_same_bm(ref, port, atol=0)
    np.testing.assert_array_equal(port.origin.numpy(), np.asarray(ref.origin))
    assert (port.height, port.width, port.capacity) == (ref.height, ref.width, ref.capacity)


def test_allocate_tiles_and_cells_to_slots():
    jm, tm = MODELS["bayes_avg"]
    ref = jbm.make_block_map(jm, 6, 5, 12, block=B, scale=SCALE)
    port = tbm.make_block_map(tm, 6, 5, 12, block=B, scale=SCALE, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(4):  # the fourth round runs the pool dry
        need = rng.uniform(size=(6, 5)) < 0.25
        ref = jbm.allocate_tiles(ref, jnp.asarray(need))
        port = tbm.allocate_tiles(port, torch.from_numpy(need))
        assert_same_bm(ref, port, atol=0)
        assert bool(port.overflowed) == bool(ref.overflowed)
        np.testing.assert_array_equal(float(tbm.allocated_fraction(port)),
                                      float(jbm.allocated_fraction(ref)))
    assert bool(port.overflowed)
    rows = rng.integers(-10, 6 * B + 10, 300)
    cols = rng.integers(-10, 5 * B + 10, 300)
    got = tbm.cells_to_slots(port, torch.from_numpy(rows), torch.from_numpy(cols))
    want = jbm.cells_to_slots(ref, jnp.asarray(rows), jnp.asarray(cols))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("estimator,blur", [("const", True), ("area", False)])
def test_scan_sample_cells(seq, estimator, blur):
    scans, _, gt = seq
    beam = dict(occupancy_estimator=estimator, wall_blur=blur, max_range=6.0)
    origin = np.array([-8.0, -8.0], np.float32)
    # eager JAX: its division by the scale is IEEE, as the port's
    got = tray.scan_sample_cells(torch.from_numpy(origin), SCALE, gt[3], scans[3],
                                 tray.BeamConfig(**beam))
    want = jray.scan_sample_cells(jnp.asarray(origin), SCALE, jnp.asarray(gt[3].numpy()),
                                  jscan(scans, 3), jray.BeamConfig(free_impl="dda", **beam))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the area estimator's overlap is computed in another order (2.4e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


# jitted, as the reference's engine runs it: XLA multiplies by the cell
# size's reciprocal and fuses the window's origin (ROADMAP trap m)
_extract = jax.jit(jbm.extract_window, static_argnums=(1, 3, 4))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_insert_scan_and_windows(seq, model):
    scans, _, gt = seq
    jm, tm = MODELS[model]
    beam = dict(wall_blur=True, max_range=6.0)
    ref = jbm.make_block_map(jm, TILES, TILES, 400, block=B, scale=SCALE)
    port = tbm.make_block_map(tm, TILES, TILES, 400, block=B, scale=SCALE, device="cpu")
    for i in (0, 3, 6):
        ref = jbm.insert_scan(ref, jm, jnp.asarray(gt[i].numpy()), jscan(scans, i),
                              jray.BeamConfig(free_impl="dda", **beam))
        port = tbm.insert_scan(port, tm, gt[i], scans[i], tray.BeamConfig(**beam))
        assert_same_bm(ref, port)
    assert 0 < int(port.n_alloc) < 400
    for center in ([0.3, -1.2], [-7.9, 7.9], [50.0, -50.0]):  # inside, a corner, clamped
        for th, tw in ((6, 6), (5, 9), (TILES + 2, 3)):
            got = tbm.extract_window(port, tm, torch.tensor(center), th, tw)
            want = _extract(ref, jm, jnp.asarray(center, jnp.float32), th, tw)
            np.testing.assert_allclose(got.cells.numpy(), np.asarray(want.cells), atol=1e-6)
            np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    np.testing.assert_allclose(tbm.occupancy_plane(port, tm).numpy(),
                               np.asarray(jbm.occupancy_plane(ref, jm)), atol=1e-6)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_exhausted_pool_drops_what_the_reference_wraps(seq, model):
    scans, _, gt = seq
    jm, tm = MODELS[model]
    beam = dict(wall_blur=True, max_range=6.0)
    cap = 9  # a scan touches some 40 tiles
    ref = jbm.make_block_map(jm, TILES, TILES, cap, block=B, scale=SCALE)
    port = tbm.make_block_map(tm, TILES, TILES, cap, block=B, scale=SCALE, device="cpu")
    ref = jbm.insert_scan(ref, jm, jnp.asarray(gt[2].numpy()), jscan(scans, 2),
                          jray.BeamConfig(free_impl="dda", **beam))
    port = tbm.insert_scan(port, tm, gt[2], scans[2], tray.BeamConfig(**beam))
    assert bool(port.overflowed) and int(port.n_alloc) == int(ref.n_alloc) > cap
    np.testing.assert_array_equal(port.table.numpy(), np.asarray(ref.table))
    rp, pp = np.asarray(ref.pool).copy(), port.pool.numpy().copy()
    # trap n: the reference's last cell of the last block took the dropped
    # samples' weight; the port's did not
    assert rp[-1, -1, -1, -1] > pp[-1, -1, -1, -1]
    rp[-1, -1, -1], pp[-1, -1, -1] = 0.0, 0.0
    np.testing.assert_allclose(pp, rp, atol=1e-6, rtol=0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_pool_insert_twin_equals_ordered_sums(seq, model):
    """K3 over the tiled pool on the CPU: the touched tiles are the
    reference's, and the twin's pool equals the ordered host sums
    (``kernels.pool_insert_ordered``) bit for bit with one thread, on every
    slot; q = 0 touches nothing."""
    scans, _, gt = seq
    jm, tm = MODELS[model]
    beam = dict(wall_blur=True, max_range=6.0)
    tbeam, jbeam = tray.BeamConfig(**beam), jray.BeamConfig(free_impl="dda", **beam)
    bm = tbm.make_block_map(tm, TILES, TILES, 400, block=B, scale=SCALE, device="cpu")
    for i in (0, 3, 6):
        pose, sc = gt[i][None], scans[i:i + 1]
        touched = kernels.pool_touched((TILES, TILES), B, bm.origin, bm.scale, pose, sc, tbeam)
        rows, cols, w, _ = jray.scan_sample_cells(jnp.asarray(bm.origin.numpy()), SCALE,
                                                  jnp.asarray(gt[i].numpy()), jscan(scans, i),
                                                  jbeam)
        ok = (w > 0) & (rows >= 0) & (rows < TILES * B) & (cols >= 0) & (cols < TILES * B)
        want = jnp.zeros((TILES, TILES), bool).at[
            jnp.clip(rows // B, 0, TILES - 1), jnp.clip(cols // B, 0, TILES - 1)].max(ok)
        np.testing.assert_array_equal(touched[0].numpy(), np.asarray(want))
        zero = torch.zeros(())
        assert not kernels.pool_touched((TILES, TILES), B, bm.origin, bm.scale, pose, sc, tbeam,
                                        zero).any()
        bm = tbm.allocate_tiles(bm, touched[0])
        ordered = bm.pool.clone()
        kernels.pool_insert_ordered(ordered, bm.table[None], bm.origin, bm.scale, tm, pose, sc,
                                    tbeam, touched, n_live=bm.n_alloc)
        got = kernels.pool_insert(bm.pool, bm.table[None], bm.origin, bm.scale, tm, pose, sc,
                                  tbeam, touched, n_live=bm.n_alloc)
        assert got is bm.pool  # in place
        np.testing.assert_array_equal(got.numpy(), ordered.numpy())


def test_tiled_engine_matches_reference(seq):
    """6 scans through both tiled engines with the reference's matcher
    normals injected: poses within 1e-4, pool within 1e-4."""
    scans, odom, gt = seq
    sc = dict(reducer="overlap", window=1)
    mc = dict(sigma_xy=0.08, sigma_theta=0.05, batch=16, rounds=4)
    tiles = dict(map_height=TILES * B, map_width=TILES * B, map_scale=SCALE,
                 map_storage="tiled", tile_block=B, tile_capacity=300, window_tiles=10)
    beam = dict(wall_blur=True, max_range=6.0)
    jcfg = jeng.EngineConfig(
        cell_model=jcells.TBMCell(), use_angle_histogram=True,
        matcher_cfg=jmatchers.MonteCarloConfig(scoring=jscoring.ScoringConfig(**sc), **mc),
        beam=jray.BeamConfig(free_impl="dda", **beam), **tiles)
    tcfg = teng.EngineConfig(
        cell_model=tcells.TBMCell(), use_angle_histogram=True,
        matcher_cfg=tmatchers.MonteCarloConfig(scoring=tscoring.ScoringConfig(**sc), **mc),
        beam=tray.BeamConfig(**beam), **tiles)
    n = 6
    js = JScan(jnp.asarray(scans.ranges[:n].numpy()), jnp.asarray(scans.bearings[:n].numpy()),
               jnp.asarray(scans.valid[:n].numpy()))
    state = jeng.init_state(jcfg).replace(pose=jnp.asarray(gt[0].numpy()))
    jfinal, jtraj, _ = jeng.run_sequence(jcfg, state, js, jnp.asarray(odom[:n].numpy()))
    key, noise = jax.random.PRNGKey(0), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        noise.append(np.stack([np.asarray(jax.random.normal(k, (mc["batch"], 3)))
                               for k in jax.random.split(sub, mc["rounds"])]))
    e = teng.Engine(tcfg, device="cpu")
    e.state.pose = gt[0].clone()
    traj, _ = e.run(scans[:n], odom[:n], noise=torch.from_numpy(np.stack(noise)))
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-4, rtol=0)
    tree = convert.state_to_numpy(e.state)
    np.testing.assert_array_equal(tree["table"], np.asarray(jfinal.gm.table))
    assert tree["n_alloc"] == int(jfinal.gm.n_alloc)
    np.testing.assert_allclose(tree["pool"], np.asarray(jfinal.gm.pool), atol=1e-4, rtol=0)
    # the state crosses back and forth unchanged
    back = convert.state_from_numpy(tree, device="cpu")
    assert isinstance(back.gm, tbm.BlockMap) and back.gm.block == B
    assert torch.equal(back.gm.pool, e.state.gm.pool)
    assert e.occupancy.shape == (TILES * B, TILES * B)

