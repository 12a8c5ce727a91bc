"""PyTorch/CUDA port of ``slam_constructor_tpu``: the tinySLAM and vinySLAM
paths and the loop-closing full pipeline.

The JAX package beside this one is the reference. This package imports
``torch`` and numpy only, never ``jax`` or ``flax``, so it runs where JAX
is not installed. The layout mirrors the reference module for module:

- ``ops``: geometry, scans, cell models (Bayes, TBM), grid maps, scoring
  and scan insertion (the ``overlap_score``, ``mc_match`` and
  ``polar_free_plane`` CUDA kernels in ``csrc/``, their wrappers and plain
  twins in ``ops/kernels.py``), the Monte-Carlo and the brute-force matcher;
- ``models``: the engine (``Engine``, ``slam_step``, ``run_sequence``), the
  presets (``tiny_config``, ``fast_config``, ``viny_config``), the keyframe
  pose graph (``posegraph``) and the loop-closing pipeline
  (``full.FullSlamEngine``);
- ``utils``: synthetic worlds and sequences, ATE/RPE, and conversion of the
  reference's ``SlamState`` and ``PoseGraphState``.

Entry points: ``models.tiny.tiny_config`` or ``models.viny.viny_config`` ->
``models.engine.Engine(cfg)`` -> ``Engine.run(scans, odom)`` or
``Engine.handle_scan``; ``models.full.FullConfig`` ->
``models.full.FullSlamEngine(cfg)`` -> ``FullSlamEngine.run(scans, odom)``.
They run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``).
"""

import torch

# fp32 everywhere: TF32 keeps ~3 decimal digits, the Hopper twin of the
# bf16-operand collapse the reference hit on the TPU
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
