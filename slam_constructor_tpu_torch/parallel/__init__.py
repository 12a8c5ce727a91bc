"""The multi-device layer: one rank a device over ``torch.distributed``."""
