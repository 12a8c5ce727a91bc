"""The port's native CARMEN parser (``native/carmen_parser.cpp``, built
with ``g++`` at first use) gives the arrays of the Python parser on the
two fixture logs; ``read_carmen`` prefers it as the reference does."""

from pathlib import Path

import numpy as np
import pytest

from slam_constructor_tpu.utils import dataset as jdataset
from slam_constructor_tpu_torch.utils import dataset

DATA = Path(__file__).resolve().parent / "data"
LOGS = ["mini_flaser.clf", "mini_robotlaser.clf"]


@pytest.fixture(scope="module")
def lib():
    lib = dataset.native_lib()
    if lib is None:
        pytest.skip("no C++ toolchain")
    return lib


def _same(a, b):
    np.testing.assert_array_equal(a.ranges, b.ranges)
    np.testing.assert_array_equal(a.odom_poses, b.odom_poses)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert (a.start_angle, a.fov, a.max_range) == (b.start_angle, b.fov, b.max_range)
    assert a.params == b.params
    if a.true_poses is None:
        assert b.true_poses is None
    else:
        np.testing.assert_array_equal(a.true_poses, b.true_poses)


@pytest.mark.parametrize("name", LOGS)
def test_native_parser_equals_python_parser(lib, name):
    native = dataset.read_carmen(str(DATA / name))
    python = dataset.read_carmen(str(DATA / name), prefer_native=False)
    assert native.ranges.shape[0] > 0 and native.ranges.dtype == np.float32
    _same(native, python)
    _same(native, jdataset.read_carmen(str(DATA / name)))


def test_native_library_is_built_in_the_checkout(lib):
    path = dataset._native.library_path(dataset.PARSER_SOURCE, "slamio")
    assert path.exists() and path.parent.parent.name == "build"
    assert "slam_constructor_tpu/" not in str(path)


def test_a_log_without_laser_records_falls_back(lib, tmp_path):
    """The native parser finds no scan: the Python parser reads the log."""
    log = tmp_path / "empty.clf"
    log.write_text("PARAM robot_front_laser_max 30.0\n")
    got = dataset.read_carmen(str(log))
    assert got.ranges.shape == (0,) and got.max_range == 30.0
    _same(got, dataset._read_carmen_py(str(log)))
