"""Cells of BENCHMARK.json cut to a size the CPU tests can run."""
from __future__ import annotations

from bench import spec

SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             vocab_size=256, num_hidden_layers=2)
SMALL_MOE = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32)
SMALL_DENSE = dict(intermediate_size=128)
CELLS = ("moe-train-s2k", "dense-train-s2k")


def small_cell(name: str, *, dtype: str = "bfloat16", seq_len: int = 32,
               batch: int = 4) -> spec.Cell:
    """``name``'s cell with every width and the traffic cut small; its
    optimizer, checked steps and limits as they are."""
    cell = spec.load_cell(name)
    cfg = dict(cell.config, **SMALL, torch_dtype=dtype)
    cfg.update(SMALL_MOE if "num_experts" in cfg else SMALL_DENSE)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, seq_len=seq_len, global_batch=batch)
    return cell
