"""Optimizers of the port (twin of ``repro.optim``)."""
from repro_torch.optim import adamw

__all__ = ["adamw"]
