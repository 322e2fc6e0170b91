"""device_idle_pct (%, device trace): the share of the traced stretch, on
the host's clock from the first traced request's start to the last one's end,
in which no kernel, copy or set ran on the card."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
