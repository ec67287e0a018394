"""adamw_ms: device milliseconds a step spends in the program's optimizer
update, ``repro_torch.optim.adamw.apply`` (global-norm clip and AdamW over
the whole parameter tree), read from the traced steps (``bench.trace``)."""
from bench.trace import per_step_ms

WRAPS = "repro_torch.optim.adamw:apply"


def read(run):
    return per_step_ms(run, "adamw_ms")
