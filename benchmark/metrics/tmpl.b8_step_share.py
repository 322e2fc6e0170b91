"""tmpl.b8_step_share (%, program spans): the share of the traced requests'
grouped conv steps (those whose `fwd.step` span carries `groups` > 1) that
ran on kernel B8 (`route` b8, not the vendor conv), read through
benchmark/spans.py. Nothing where the program's steps carry no groups, or
without a device trace: off the card the B8 route runs the kernel's plain
version."""

from benchmark import spans


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    reqs = spans.traced_requests(t.n)
    if reqs is None:
        return None
    routes = [a.get("route") for req in reqs
              for _i, name, _s, _e, _p, a in req
              if name == "fwd.step" and a and a.get("groups", 1) > 1]
    if not routes:
        return None
    return 100.0 * sum(r == "b8" for r in routes) / len(routes)
