"""The checks ``chip_smoke.py`` makes on the card, held on the CPU: where an
RBPF slot run parts on the card and the CPU, ``climb_part_explained``
accepts the parting only at a call whose inputs agree on the two devices
and whose parting matches were decided closer than ``KNIFE_EDGE``."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from slam_constructor_tpu_torch.ops import kernels  # noqa: E402

M, H, W, R = 3, 32, 32, 24
SCALE, UNKNOWN = 0.1, 0.5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def calls(uniform: bool):
    """One scan's calls of the match and the climb on M small maps: a
    random map (its decisions far apart) or a uniform one (every candidate
    ties)."""
    rng = np.random.default_rng(3)
    plane = (np.full((M, H, W), 0.5) if uniform else rng.uniform(0, 1, (M, H, W)))
    plane = torch.from_numpy(plane.astype(np.float32))
    ang = np.linspace(-np.pi, np.pi, R, endpoint=False)
    rr = rng.uniform(0.5, 1.2, (M, R))
    pts = torch.from_numpy(np.stack([rr * np.cos(ang), rr * np.sin(ang)], -1).astype(np.float32))
    beam_w = torch.ones((M, R))
    origin = torch.zeros((M, 2))
    pose = torch.from_numpy(np.array([[1.6, 1.6, 0.1]] * M, np.float32))
    noise = torch.from_numpy(rng.standard_normal((M, 2, 4, 3)).astype(np.float32))
    mc = (plane, pts, beam_w, origin, pose, noise, SCALE, UNKNOWN, 0.05, 0.02, 2, kernels.BILINEAR)
    hc = (plane, pts, beam_w, origin, pose, SCALE, UNKNOWN, 0.1, 0.05, 4, 0.5, kernels.BILINEAR)
    return {"mc_match_batched": [mc], "hill_climb": [hc]}


def planted(c, kind, i, delta):
    """``c`` with argument ``i`` of ``kind``'s call moved by ``delta``."""
    a = list(c[kind][0])
    a[i] = a[i].clone()
    a[i].view(-1)[0] += delta
    return {**c, kind: [tuple(a)]}


def parting_climb(monkeypatch):
    """The card's climb stands in for a kernel whose first map ends 0.05 m
    from the twin's."""
    twin = kernels.hill_climb

    def climb(*a):
        pose, prob, trace = twin(*a)
        pose = pose.clone()
        pose[0, 0] += 0.05
        return pose, prob, trace

    monkeypatch.setattr(kernels, "hill_climb", climb)


@pytest.mark.parametrize("case", ["match input", "climb input", "agree"])
def test_climb_parting_with_different_inputs_is_not_explained(case, monkeypatch):
    """Inputs that differ on the two devices (at the match, or at the climb
    after an equal match) fail the check even where a later call decides
    closer than KNIFE_EDGE (the uniform map: every candidate ties); calls
    that agree throughout explain nothing."""
    cpu = calls(uniform=True)
    card = {"match input": planted(cpu, "mc_match_batched", 4, 1e-3),
            "climb input": planted(cpu, "hill_climb", 4, 1e-3),
            "agree": cpu}[case]
    if case != "agree":
        parting_climb(monkeypatch)
    assert not cs.climb_part_explained("test", card, cpu)


@pytest.mark.parametrize("uniform", [True, False], ids=["close decision", "far decisions"])
def test_climb_parting_with_equal_inputs(uniform, monkeypatch):
    """Equal inputs and a kernel that parts from the twin: explained only
    where the twin's decisions were closer than KNIFE_EDGE."""
    cpu = calls(uniform)
    _, margins = cs.twin_record(cpu["hill_climb"][0], kernels.hill_climb_loop,
                                kernels.overlap_score_ref)
    assert (float(margins[0].min()) < cs.KNIFE_EDGE) == uniform  # the case's premise
    parting_climb(monkeypatch)
    assert cs.climb_part_explained("test", cpu, cpu) == uniform
