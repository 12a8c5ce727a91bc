"""Carry engine state between the reference and the port.

A reference ``SlamState`` crosses as a dict of numpy arrays:
``cells`` f32[H, W, C] (C = the cell model's belief channels + 1: 2 for the
Bayes cells, 5 for the TBM cell), ``origin`` f32[2], ``scale`` float,
``pose`` f32[3], ``step`` int, ``last_prob`` float. The reference's PRNG key is not
carried over: its role moves to the ``Engine``'s ``torch.Generator``, or to
noise injected into ``slam_step``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.engine import SlamState
from ..ops.grid import GridMap


def state_from_numpy(tree: dict, device=None) -> SlamState:
    """Build the port's state from a numpy dict (see module docstring) on
    ``device`` (the card when none is named)."""
    device = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return SlamState(
        gm=GridMap(cells=f32(tree["cells"]), origin=f32(tree["origin"]), scale=float(tree["scale"])),
        pose=f32(tree["pose"]),
        step=torch.tensor(np.asarray(tree["step"], np.int32), device=device),
        last_prob=f32(tree["last_prob"]),
    )


def state_to_numpy(state: SlamState) -> dict:
    """The port's state as a numpy dict (see module docstring)."""
    return {
        "cells": state.gm.cells.cpu().numpy(),
        "origin": state.gm.origin.cpu().numpy(),
        "scale": float(state.gm.scale),
        "pose": state.pose.cpu().numpy(),
        "step": int(state.step),
        "last_prob": float(state.last_prob),
    }
