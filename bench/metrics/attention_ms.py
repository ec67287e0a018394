"""attention_ms: device milliseconds a step spends in the program's
attention, ``repro_torch.models.common.attention``: every layer's call, its
forward, remat's recompute of it and its backward, read from the traced
steps (``bench.trace``)."""
from bench.trace import per_step_ms

WRAPS = "repro_torch.models.common:attention"


def read(run):
    return per_step_ms(run, "attention_ms")
