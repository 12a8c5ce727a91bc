"""The port runs without JAX: the machine with the card has none.

A subprocess blocks ``jax`` and ``flax`` from being imported, then imports
every module of ``slam_constructor_tpu_torch`` and runs two tinySLAM steps
on the CPU. A source scan makes sure no file of the package names them.
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
from slam_constructor_tpu_torch.models import engine, tiny
from slam_constructor_tpu_torch.utils import datagen
occ, origin, scale = datagen.box_world(6.0)
poses = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.05]])
scans, odom, gt = datagen.synth_sequence(occ, origin, scale, poses, datagen.default_bearings(64))
e = engine.Engine(tiny.tiny_config(map_size=64, mc_batch=8, mc_rounds=2), device="cpu")
traj, probs = e.run(scans, odom)
assert traj.shape == (2, 3) and bool(torch.isfinite(traj).all())
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
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax)\b", re.M)
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) >= 12
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
