"""The one place that decides which device an entry point runs on.

The port runs on the card unless the caller asks for the CPU: an entry
point (``Engine``, ``make_engine``, ``init_state``, ``state_from_numpy``)
called without a device resolves to ``cuda``, and raises where there is no
card instead of carrying on on the CPU. Functions that only build tensors
(``make_grid_map``, ``datagen.*``) keep their explicit ``device`` argument.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was named: the port runs "
            'on the GPU by default; pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor (nested tuples of numbers) on ``device``,
    made once a process: a copy from the host waits for the device, so a
    step that must not sync takes its constants from here, made before it
    runs. The tensor is shared: never write into it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _constant(values, dtype, device)
