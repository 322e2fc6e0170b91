"""engine.dispatch_idle_ms (ms, device trace): device idle time per request
in the traced stretch while the host was inside a `fwd.step` span of the
program or in `fwd`'s own time between steps: the card waiting on the fused
executor's Python between launches (benchmark/spans.py places the program's
spans on the trace's clock and cuts each gap where a span starts or ends).
Nothing where the program keeps no spans."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, spans.DISPATCH)
