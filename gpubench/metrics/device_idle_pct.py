"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on a card, in percent: the mean over the cell's cards."""


def read(trace):
    if not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
