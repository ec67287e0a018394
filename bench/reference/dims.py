"""The sizes a configuration file states, under the source's key names.

Where the program departs from the published model in a number, the file
states the published one under the source's key and the one the program
runs under ``program_<key>``; the reference follows the program's.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Dims:
    family: str            # dense | moe
    layers: int
    d: int
    heads: int
    kv_heads: int
    hd: int
    ff: int                # the dense MLP's width, or one expert's
    vocab: int
    theta: float
    eps: float
    tie: bool
    dtype: torch.dtype     # the weights' storage type
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0

    @classmethod
    def of(cls, cfg: dict) -> "Dims":
        """From a configuration file's JSON object (Hugging Face key names)."""
        if cfg.get("hidden_act", "silu") != "silu":
            raise ValueError(f"unsupported activation {cfg['hidden_act']!r}")
        moe = int(cfg.get("num_experts", 0)) > 0
        if moe and not cfg.get("norm_topk_prob", False):
            raise ValueError("the MoE reference renormalises the top-k probabilities")
        return cls(
            family="moe" if moe else "dense",
            layers=int(cfg["num_hidden_layers"]), d=int(cfg["hidden_size"]),
            heads=int(cfg["num_attention_heads"]), kv_heads=int(cfg["num_key_value_heads"]),
            hd=int(cfg["head_dim"]),
            ff=int(cfg["moe_intermediate_size"] if moe else cfg["intermediate_size"]),
            vocab=int(cfg["vocab_size"]), theta=float(cfg["rope_theta"]),
            eps=float(cfg.get("program_rms_norm_eps", cfg["rms_norm_eps"])), tie=bool(cfg["tie_word_embeddings"]),
            dtype=DTYPES[cfg["torch_dtype"]],
            experts=int(cfg.get("num_experts", 0)), top_k=int(cfg.get("num_experts_per_tok", 0)),
            capacity_factor=float(cfg.get("capacity_factor", 0.0)),
        )
