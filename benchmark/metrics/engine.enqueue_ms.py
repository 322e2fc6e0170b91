"""engine.enqueue_ms (ms, host clock): host time per request in the traced
stretch from the start of the program's `run_fwd` span to the end of its
last `fwd.step` span, the mean: how long the host takes to put a forward on
the card, to set beside the card's busy time per request. Nothing without a
device trace or where the program keeps no step spans."""

from benchmark import spans


def read(run):
    s = spans.enqueue_s(run)
    return None if s is None else 1e3 * s
