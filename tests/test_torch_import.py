"""The port runs without JAX: the machine with the card has none.

A subprocess blocks ``jax`` and ``flax`` from being imported, then imports
every module of ``slam_constructor_tpu_torch`` and runs two tinySLAM and
two vinySLAM steps, a few scans of the loop-closing pipeline and of the
GMapping RBPF, and the command-line runner on two shipped configs (the
gradient refine on a synthetic sequence, the tiled map on a CARMEN log), a
step of the ``distributed`` preset in a gloo group of one and the native
CARMEN parser, on the CPU. A source scan makes sure no file of the package, nor the GPU smoke
script, imports them or the reference package.
"""

import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "slam_constructor_tpu_torch"

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import pkgutil, importlib
import torch
torch.set_num_threads(1)
import slam_constructor_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from slam_constructor_tpu_torch.models import engine, tiny, viny
from slam_constructor_tpu_torch.utils import datagen
occ, origin, scale = datagen.box_world(6.0)
poses = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.05]])
scans, odom, gt = datagen.synth_sequence(occ, origin, scale, poses, datagen.default_bearings(64))
e = engine.Engine(tiny.tiny_config(map_size=64, mc_batch=8, mc_rounds=2), device="cpu")
traj, probs = e.run(scans, odom)
assert traj.shape == (2, 3) and bool(torch.isfinite(traj).all())
v = viny.make_engine(device="cpu", map_size=64, mc_batch=8, mc_rounds=2)
vtraj, _ = v.run(scans, odom)
assert vtraj.shape == (2, 3) and bool(torch.isfinite(vtraj).all())
from slam_constructor_tpu_torch.models import full, posegraph
from slam_constructor_tpu_torch.utils import convert
names = {m.name.rsplit(".", 1)[-1] for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
assert {"full", "posegraph", "matchers", "convert", "kernels"} <= names
poses6 = torch.tensor([[0.3 * i, 0.0, 0.0] for i in range(6)])
scans6, odom6, _ = datagen.synth_sequence(occ, origin, scale, poses6, datagen.default_bearings(64))
f = full.FullSlamEngine(
    full.FullConfig(
        tracking=tiny.fast_config(map_size=64, usable_range=2.0, mc_batch=8, mc_rounds=2),
        graph=posegraph.PoseGraphConfig(max_keyframes=8, max_edges=16, keyframe_distance=0.5,
                                        min_index_gap=2, max_candidates=2, local_map_size=32)),
    n_beams=64, device="cpu")
ftraj = f.run(scans6, odom6)
assert ftraj.shape == (6, 3) and bool(torch.isfinite(ftraj).all())
assert convert.graph_to_numpy(f.graph)["n_kf"] >= 2
from slam_constructor_tpu_torch.models import gmapping
assert {"gmapping", "resample"} <= names
g = gmapping.GMappingEngine(gmapping.fast_config(n_particles=4, map_size=64, usable_range=2.0),
                            device="cpu")
gtraj, gneff = g.run(scans6, odom6)
assert gtraj.shape == (6, 3) and bool(torch.isfinite(gtraj).all()) and g.winner_trajectory().shape == (6, 3)
assert {"config", "dataset", "blockmap", "run", "trajectory", "viz", "metrics"} <= names
import contextlib, io, tempfile
from slam_constructor_tpu_torch import run
for cfg, src in (("tiny_refined", ["--synthetic", "cecum", "--trajectory", "rectangle"]),
                 ("mit_stata", ["--dataset", "tests/data/mini_robotlaser.clf"])):
    with tempfile.TemporaryDirectory() as out, contextlib.redirect_stdout(io.StringIO()):
        summary = run.main(["--config", f"configs/{cfg}.properties", *src, "--steps", "2",
                            "--scan-stride", "4", "--cpu", "--out", out])
        assert summary["scans"] >= 2, summary
assert {"mesh", "particles", "halo", "dist_ba", "blockshard", "ep_cow", "ep2d", "multihost",
        "determinism", "profiling"} <= names
from slam_constructor_tpu_torch.parallel import mesh as meshlib
from slam_constructor_tpu_torch.utils import config as tconfig
meshlib.init(0, 1, "cpu", f"tcp://127.0.0.1:{meshlib.free_port()}")
try:
    dcfg, dst, dstep = tconfig.preset("distributed")(device="cpu", n_particles=2, map_height=64,
                                                     map_width=64)
    key0 = dst.key
    dst, anc = dstep(dst, scans6[0], odom6[0])  # drawn from the state's key
    assert anc.shape == (2,) and bool(torch.isfinite(dst.log_weights).all())
    assert not torch.equal(dst.key, key0)
finally:
    meshlib.shutdown()
from slam_constructor_tpu_torch.utils import dataset
assert dataset.read_carmen("tests/data/mini_flaser.clf").ranges.shape[0] > 0
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("ok", traj[-1].tolist())
"""


def test_package_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_no_file_of_the_package_imports_jax():
    # \b does not end at an underscore: the port's own name does not match
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|slam_constructor_tpu)\b", re.M)
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 17
    assert {"full.py", "posegraph.py", "gmapping.py", "resample.py", "run.py", "config.py",
            "dataset.py", "blockmap.py", "mesh.py", "particles.py", "halo.py", "dist_ba.py",
            "blockshard.py", "ep_cow.py", "ep2d.py", "multihost.py", "determinism.py",
            "profiling.py"} <= {f.name for f in files}
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
