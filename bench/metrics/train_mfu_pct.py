"""train_mfu_pct: the window's model FLOPs (``bench.flops``, PaLM's count)
over its host-clock seconds, as a share of one H100's dense bf16 peak.
The card's power limit is printed on the result's ``device`` line."""
from bench import flops


def read(run):
    if run.device.type != "cuda" or run.window_steps == 0:
        return None
    return 100.0 * run.step_flops * run.window_steps / run.window_s / flops.BF16_PEAK_FLOPS
