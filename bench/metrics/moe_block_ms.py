"""moe_block_ms: device milliseconds a step spends in the program's MoE
block, ``repro_torch.models.moe._moe_local`` (route, rank, dispatch,
experts, combine): every layer's call, its forward, remat's recompute of it
and its backward, read from the traced steps (``bench.trace``). Nothing to
read where no MoE block runs."""
from bench.trace import per_step_ms

WRAPS = "repro_torch.models.moe:_moe_local"


def read(run):
    return per_step_ms(run, "moe_block_ms")
