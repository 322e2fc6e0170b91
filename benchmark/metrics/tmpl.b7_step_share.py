"""tmpl.b7_step_share (%, program spans): the share of the traced requests'
conv steps that ran on kernel B7, from the `route` each conv step's
`fwd.step` span carries (`b7`, `b6` or `vendor`: the kernel or the vendor
library the step's forward took), read through benchmark/spans.py. Nothing
where the program's steps carry no route, or without a device trace: off
the card the B7 route runs the kernel's plain version."""

from benchmark import spans


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    reqs = spans.traced_requests(t.n)
    if reqs is None:
        return None
    routes = [a["route"] for req in reqs
              for _i, name, _s, _e, _p, a in req
              if name == "fwd.step" and a and "route" in a]
    if not routes:
        return None
    return 100.0 * sum(r == "b7" for r in routes) / len(routes)
