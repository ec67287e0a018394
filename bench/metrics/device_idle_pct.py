"""device_idle_pct: the share of the traced span in which no operation ran
on the card (torch.profiler's trace: kernels, copies, fills)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
