"""entry.between_idle_ms (ms, device trace): device idle time per request in
the traced stretch while the host was outside every `run_fwd` span of the
program: the caller's time between requests (benchmark/spans.py). With
engine.dispatch_idle_ms and io.stage_idle_ms it puts every idle second of
the trace's gaps down once. Nothing where the program keeps no spans."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, spans.BETWEEN)
