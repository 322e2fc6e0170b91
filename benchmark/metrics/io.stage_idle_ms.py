"""io.stage_idle_ms (ms, device trace): device idle time per request in the
traced stretch while the host was inside `run_fwd.upload`, `fwd.inputs`,
`fwd.outputs`, `run_fwd.readback` or `run_fwd`'s own time: the card waiting
on the pageable upload, the input checks and staging, the outputs and the
readback, which also waits out the queued forward (benchmark/spans.py).
Nothing where the program keeps no spans."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, spans.STAGE)
