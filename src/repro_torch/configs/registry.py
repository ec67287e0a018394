"""Architecture registry: assigned configs, input shapes, and skip rules.

Twin of ``repro.configs.registry``. Each ``repro_torch/configs/<arch>.py``
defines ``CONFIG`` (the exact published configuration) and ``SMOKE`` (a
reduced same-family config for CPU tests), field for field the reference's
with torch dtypes. ``ARCHS``, ``SHAPES``, ``skip_reason`` and ``cells`` are
the reference's, and every arch builds its family's twin; an unknown arch
raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

from repro_torch.models.common import ModelConfig

ARCHS = (
    "gemma-2b", "gemma2-2b", "yi-34b", "mistral-nemo-12b", "whisper-large-v3",
    "mamba2-370m", "qwen3-moe-30b-a3b", "grok-1-314b", "recurrentgemma-2b",
    "internvl2-2b",
)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# long_500k requires a sub-quadratic/stateful path: run for SSM / hybrid /
# local+global archs; skip for pure full attention and for the audio
# enc-dec (context capped by encoder semantics).
LONG_OK = {"mamba2-370m", "recurrentgemma-2b", "gemma2-2b"}


def skip_reason(arch: str, shape: str) -> str | None:
    if shape == "long_500k" and arch not in LONG_OK:
        if arch == "whisper-large-v3":
            return "enc-dec audio model: context capped by 30s encoder windows"
        return "pure full-attention arch: no sub-quadratic path at 524k"
    return None


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(arch)
    return importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_')}")


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    mod = _module(arch)
    return mod.SMOKE if smoke else mod.CONFIG


def model_class(cfg: ModelConfig):
    from repro_torch.models.encdec import WhisperLM
    from repro_torch.models.hybrid import RecurrentGemmaLM
    from repro_torch.models.moe import MoELM
    from repro_torch.models.ssm import Mamba2LM
    from repro_torch.models.transformer import DenseLM
    from repro_torch.models.vlm import InternVLM

    return {
        "dense": DenseLM, "moe": MoELM, "ssm": Mamba2LM,
        "hybrid": RecurrentGemmaLM, "encdec": WhisperLM, "vlm": InternVLM,
    }[cfg.family]


def build_model(arch: str, mesh=None, *, smoke: bool = False,
                shape: str | None = None, **kw: Any):
    cfg = get_config(arch, smoke=smoke)
    cls = model_class(cfg)
    if cfg.family == "encdec":
        cell = SHAPES.get(shape or "", None)
        max_target = max(kw.pop("max_target", 448),
                         (cell.seq_len if cell else 448))
        return cls(cfg, mesh, max_target=max_target, **kw)
    return cls(cfg, mesh, **kw)


def cells(include_skipped: bool = False):
    """All 40 (arch, shape) cells; skipped ones annotated."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            reason = skip_reason(arch, shape)
            if reason is None or include_skipped:
                out.append((arch, shape, reason))
    return out
