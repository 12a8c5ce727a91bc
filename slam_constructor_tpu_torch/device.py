"""The one place that decides which device an entry point runs on.

The port runs on the card unless the caller asks for the CPU: an entry
point (``Engine``, ``make_engine``, ``init_state``, ``state_from_numpy``)
called without a device resolves to ``cuda``, and raises where there is no
card instead of carrying on on the CPU. Functions that only build tensors
(``make_grid_map``, ``datagen.*``) keep their explicit ``device`` argument.
"""

from __future__ import annotations

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
