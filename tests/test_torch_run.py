"""The port's command-line runner (``slam_constructor_tpu_torch/run.py``)
against the reference's (``slam_constructor_tpu/run.py``), and on every
shipped config.

End to end on the same input: both CLIs, the port's with ``--cpu``, read
``tests/data/mini_flaser.clf`` (12 FLASER scans of 181 beams, TRUEPOS
ground truth) with a temporary ``.properties`` whose matcher is
deterministic (hill climbing): on the dense map, on the tiled map, and
with a gradient refine. The summaries carry the same keys, and the
trajectories written to ``trajectory.tum`` (6 decimals) agree within 1e-4
m and rad; the ATE the summaries print agrees within 1e-4 m. On the
synthetic sequence, which both CLIs draw from ``PRNGKey(0)``, they are
compared in ``test_torch_keys.py``.

Smoke runs: the port's CLI on each of ``configs/*.properties`` in a
temporary copy with the map, the RBPF's windows and the tile pool shrunk
(``SHRINK``), 3 synthetic scans of 120 beams, on the CPU: the outputs are
written and the poses are finite.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_constructor_tpu import run as jrun
from slam_constructor_tpu_torch import run as trun
from slam_constructor_tpu_torch.utils import config as tconfig
from slam_constructor_tpu_torch.utils import trajectory as ttraj

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FLASER = REPO / "tests" / "data" / "mini_flaser.clf"
OUTPUTS = ("trajectory.tum", "map.pgm", "map.yaml", "metrics.jsonl")

HILL_CLIMB = """\
cell.model = bayes_avg
matcher.type = hill_climbing
matcher.step_xy = 0.05
matcher.step_theta = 0.02
matcher.iterations = 8
scoring.reducer = overlap
map.height = 160
map.width = 160
map.scale = 0.1
beam.max_range = 8.0
beam.wall_blur = true
"""
TILED = """\
engine.map_storage = tiled
engine.tile_block = 8
engine.tile_capacity = 400
engine.window_tiles = 10
"""
GRADIENT = """\
refine.type = gradient
refine.iterations = 6
refine.step_xy = 0.03
refine.step_theta = 0.015
"""


@pytest.mark.parametrize("extra", ["", TILED, GRADIENT], ids=["dense", "tiled", "gradient"])
def test_both_clis_agree_on_a_carmen_log(tmp_path, capsys, extra):
    props = tmp_path / "cfg.properties"
    props.write_text(HILL_CLIMB + extra)
    argv = ["--config", str(props), "--dataset", str(FLASER), "--cpu"]
    ref = jrun.main([*argv, "--out", str(tmp_path / "ref")])
    port = trun.main([*argv, "--out", str(tmp_path / "port")])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == port
    assert sorted(port) == sorted(ref)
    assert port["scans"] == ref["scans"] == 12 and port["beams"] == ref["beams"] == 181
    assert abs(port["ate_m"] - ref["ate_m"]) <= 1e-4
    for name in OUTPUTS:
        assert (tmp_path / "port" / name).exists(), name
    ts, got = ttraj.load_tum(str(tmp_path / "port" / "trajectory.tum"))
    jts, want = ttraj.load_tum(str(tmp_path / "ref" / "trajectory.tum"))
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (tmp_path / "port" / "map.yaml").read_text() == (
        tmp_path / "ref" / "map.yaml").read_text()


#: the shrunk widths of the smoke runs (only the keys a config sets)
SHRINK = {"map.height": "96", "map.width": "96", "pf.match_window": "48",
          "pf.insert_window": "48", "matcher.window": "48", "engine.tile_block": "8",
          "engine.tile_capacity": "144", "engine.window_tiles": "8"}


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.properties")),
                         ids=lambda p: p.stem)
def test_cli_runs_every_shipped_config(tmp_path, capsys, path):
    props = tconfig.load_properties(str(path))
    props.update({k: v for k, v in SHRINK.items() if k in props})
    cfg = tmp_path / path.name
    cfg.write_text("".join(f"{k} = {v}\n" for k, v in props.items()))
    out = tmp_path / "out"
    res = trun.execute(trun.parse_args([
        "--config", str(cfg), "--synthetic", "cecum", "--trajectory", "rectangle",
        "--steps", "3", "--beams", "120", "--cpu", "--out", str(out)]))
    assert res.trajectory.shape == (3, 3) and bool(torch.isfinite(res.trajectory).all())
    assert res.summary["scans"] == 3 and np.isfinite(res.summary["ate_m"])
    for name in OUTPUTS:
        assert (out / name).exists(), name
    assert (out / "map.png").exists() or (out / "map.ppm").exists()
    occ = res.engine.occupancy
    assert occ.shape[-2:] == (96, 96) and bool(torch.isfinite(occ).all())


def test_cli_without_cpu_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--config", str(REPO / "configs" / "tiny.properties"), "--steps", "2",
                   "--out", str(tmp_path)])
