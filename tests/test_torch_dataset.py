"""Port parity of the input and output utilities: ``utils/dataset.py``,
``utils/trajectory.py``, ``utils/viz.py`` and ``utils/metrics.py``
against the reference's, on the two CARMEN fixtures.

The parsers read the same text with the same float conversions, so the
ranges, odometry and ground truth are equal exactly; ``to_sequence``'s
odometry deltas go through each package's ``between`` in f32 (atol 1e-6).
The file writers write the same bytes for the same arrays.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.utils import dataset as jdata
from slam_constructor_tpu.utils import metrics as jmetrics
from slam_constructor_tpu.utils import trajectory as jtraj
from slam_constructor_tpu.utils import viz as jviz
from slam_constructor_tpu_torch.utils import dataset as tdata
from slam_constructor_tpu_torch.utils import metrics as tmetrics
from slam_constructor_tpu_torch.utils import trajectory as ttraj
from slam_constructor_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
FIXTURES = ("mini_flaser.clf", "mini_robotlaser.clf")


@pytest.mark.parametrize("name", FIXTURES)
def test_read_carmen_matches_reference_parser(name):
    ref = jdata._read_carmen_py(str(DATA / name))
    got = tdata.read_carmen(str(DATA / name))
    np.testing.assert_array_equal(got.ranges, ref.ranges)
    np.testing.assert_array_equal(got.odom_poses, ref.odom_poses)
    np.testing.assert_array_equal(got.timestamps, ref.timestamps)
    assert (got.start_angle, got.fov, got.max_range) == (ref.start_angle, ref.fov, ref.max_range)
    assert got.params == ref.params
    np.testing.assert_array_equal(got.bearings, ref.bearings)
    if ref.true_poses is None:
        assert got.true_poses is None and got.gt_at_scans() is None
    else:
        np.testing.assert_array_equal(got.true_poses, ref.true_poses)
        np.testing.assert_array_equal(got.gt_at_scans(), ref.gt_at_scans())
    assert got.ranges.shape[0] > 5 and got.ranges.shape[1] == 181


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("beam_stride,scan_stride", [(1, 1), (2, 3)])
def test_to_sequence_matches_reference(name, beam_stride, scan_stride):
    log = tdata.read_carmen(str(DATA / name))
    scans, odom, ts = tdata.to_sequence(log, beam_stride=beam_stride, scan_stride=scan_stride,
                                        device="cpu")
    jscans, jodom, jts = jdata.to_sequence(
        jdata._read_carmen_py(str(DATA / name)), beam_stride=beam_stride,
        scan_stride=scan_stride)
    np.testing.assert_array_equal(scans.ranges.numpy(), np.asarray(jscans.ranges))
    np.testing.assert_array_equal(scans.bearings.numpy(), np.asarray(jscans.bearings))
    np.testing.assert_array_equal(scans.valid.numpy(), np.asarray(jscans.valid))
    np.testing.assert_allclose(odom.numpy(), np.asarray(jodom), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ts, jts)
    assert odom.dtype == torch.float32 and scans.ranges.device.type == "cpu"


def _arrays():
    rng = np.random.default_rng(3)
    poses = rng.normal(0, 2.0, (17, 3)).astype(np.float32)
    occ = rng.uniform(0, 1, (23, 31)).astype(np.float32)
    return poses, occ


def test_writers_write_the_reference_bytes(tmp_path):
    poses, occ = _arrays()
    origin = np.array([-1.5, -1.1], np.float32)
    for pkg, arg, sub in ((jtraj, jnp.asarray, "ref"), (ttraj, torch.from_numpy, "port")):
        d = tmp_path / sub
        d.mkdir()
        pkg.save_tum(str(d / "t.tum"), arg(poses))
        pkg.save_tum(str(d / "ts.tum"), arg(poses), timestamps=np.arange(17) * 0.1 + 5)
        pkg.save_map_pgm(str(d / "m.pgm"), arg(occ))
    for pkg, arg, sub in ((jviz, jnp.asarray, "ref"), (tviz, torch.from_numpy, "port")):
        d = tmp_path / sub
        rgb = pkg.render_map_rgb(arg(occ), arg(poses), origin, 0.1, gt=arg(poses[::-1].copy()))
        np.save(d / "rgb.npy", rgb)
        pkg.save_ppm(str(d / "m.ppm"), rgb)
        pkg.save_map_yaml(str(d / "m.yaml"), "m.pgm", origin, 0.1)
    for f in ("t.tum", "ts.tum", "m.pgm", "m.ppm", "m.yaml", "rgb.npy"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f
    ts, back = ttraj.load_tum(str(tmp_path / "port" / "ts.tum"))
    jts, jback = jtraj.load_tum(str(tmp_path / "ref" / "ts.tum"))
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(back, jback)
    np.testing.assert_allclose(back[:, :2], poses[:, :2], atol=1e-6)


def test_save_png_falls_back_to_ppm_like_the_reference(tmp_path):
    _, occ = _arrays()
    rgb = tviz.render_map_rgb(torch.from_numpy(occ))
    wrote_png = tviz.save_png(str(tmp_path / "map.png"), rgb)
    ref_png = jviz.save_png(str(tmp_path / "ref.png"), jviz.render_map_rgb(occ))
    assert wrote_png == ref_png
    assert (tmp_path / ("map.png" if wrote_png else "map.ppm")).exists()


def test_metrics_logger_matches_reference(tmp_path):
    ref, port = jmetrics.MetricsLogger(), tmetrics.MetricsLogger()
    for step in range(4):
        ref.log(step, prob=0.5 + step, neff=np.float32(3 * step), tag="a")
        port.log(step, prob=torch.tensor(0.5 + step), neff=np.float32(3 * step), tag="a")
    assert port.summary() == ref.summary()
    assert [{k: v for k, v in r.items() if k != "t"} for r in port.rows] == [
        {k: v for k, v in r.items() if k != "t"} for r in ref.rows]
    port.save_jsonl(str(tmp_path / "m.jsonl"))
    back = tmetrics.MetricsLogger.load_jsonl(str(tmp_path / "m.jsonl"))
    assert back.rows == port.rows
    assert json.loads((tmp_path / "m.jsonl").read_text().splitlines()[2])["prob"] == 2.5
