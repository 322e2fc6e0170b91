"""req_p95_ms (ms, host clock): the 95th percentile of the latency of every
request in the window, from its hand-off to `run_fwd` to its logits on the
host (Python's `statistics.quantiles`, inclusive, n=20)."""

import statistics


def read(run):
    if len(run.latencies) < 2:
        return None
    return 1e3 * statistics.quantiles(run.latencies, n=20,
                                      method="inclusive")[18]
