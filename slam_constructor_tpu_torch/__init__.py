"""PyTorch/CUDA port of ``slam_constructor_tpu``: the tinySLAM main path.

The JAX package beside this one is the reference. This package imports
``torch`` and numpy only, never ``jax`` or ``flax``, so it runs where JAX
is not installed. The layout mirrors the reference module for module:

- ``ops``: geometry, scans, cell models, grid maps, scoring (the
  ``overlap_score`` CUDA kernel in ``csrc/`` and its plain twin in
  ``ops/kernels.py``), the Monte-Carlo matcher and scan insertion;
- ``models``: the engine (``Engine``, ``slam_step``, ``run_sequence``) and
  the tinySLAM preset (``tiny_config``);
- ``utils``: synthetic worlds and sequences, ATE/RPE, and state conversion
  from the reference's ``SlamState``.

Entry points: ``models.tiny.tiny_config`` -> ``models.engine.Engine(cfg,
device=...)`` -> ``Engine.run(scans, odom)`` or ``Engine.handle_scan``.
"""

import torch

# fp32 everywhere: TF32 keeps ~3 decimal digits, the Hopper twin of the
# bf16-operand collapse the reference hit on the TPU
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
