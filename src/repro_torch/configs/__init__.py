"""Per-architecture configs (exact published configurations) + registry."""
from repro_torch.configs.registry import ARCHS, SHAPES, build_model, cells, get_config, skip_reason

__all__ = ["ARCHS", "SHAPES", "build_model", "cells", "get_config", "skip_reason"]
