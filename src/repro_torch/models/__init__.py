"""Models of the port (twin of ``repro.models``): the dense transformer and
the moe, ssm, hybrid, encdec and vlm families."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.encdec import WhisperLM
from repro_torch.models.hybrid import RecurrentGemmaLM
from repro_torch.models.moe import MoELM
from repro_torch.models.ssm import Mamba2LM
from repro_torch.models.transformer import DenseLM
from repro_torch.models.vlm import InternVLM

__all__ = ["DenseLM", "InternVLM", "Mamba2LM", "MoELM", "ModelConfig", "RecurrentGemmaLM",
           "WhisperLM"]
