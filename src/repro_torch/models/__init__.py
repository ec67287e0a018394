"""Models of the port (twin of ``repro.models``): the dense transformer and
the moe, ssm and hybrid families; encdec and vlm wait (ROADMAP Queue 1)."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.hybrid import RecurrentGemmaLM
from repro_torch.models.moe import MoELM
from repro_torch.models.ssm import Mamba2LM
from repro_torch.models.transformer import DenseLM

__all__ = ["DenseLM", "Mamba2LM", "MoELM", "ModelConfig", "RecurrentGemmaLM"]
