"""PyTorch/CUDA port of ``slam_constructor_tpu``: the tinySLAM and vinySLAM
paths.

The JAX package beside this one is the reference. This package imports
``torch`` and numpy only, never ``jax`` or ``flax``, so it runs where JAX
is not installed. The layout mirrors the reference module for module:

- ``ops``: geometry, scans, cell models (Bayes, TBM), grid maps, scoring
  and scan insertion (the ``overlap_score`` and ``polar_free_plane`` CUDA
  kernels in ``csrc/``, their wrappers and plain twins in
  ``ops/kernels.py``) and the Monte-Carlo matcher;
- ``models``: the engine (``Engine``, ``slam_step``, ``run_sequence``) and
  the presets (``tiny_config``, ``viny_config``);
- ``utils``: synthetic worlds and sequences, ATE/RPE, and state conversion
  from the reference's ``SlamState``.

Entry points: ``models.tiny.tiny_config`` or ``models.viny.viny_config`` ->
``models.engine.Engine(cfg)`` -> ``Engine.run(scans, odom)`` or
``Engine.handle_scan``. They run on the card unless the caller passes
``device="cpu"`` (``device.resolve_device``).
"""

import torch

# fp32 everywhere: TF32 keeps ~3 decimal digits, the Hopper twin of the
# bf16-operand collapse the reference hit on the TPU
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
