"""Tensor ops of the port (counterparts of ``slam_constructor_tpu.ops``)."""
