"""Models of the port (twin of ``repro.models``): the dense decoder-only
transformer so far; the other families wait (ROADMAP Queue 1)."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import DenseLM

__all__ = ["DenseLM", "ModelConfig"]
