"""io.staged_share (%, program spans): the share of the traced requests'
uploaded bytes that went through the program's pinned stager, from the
`staged` (the bytes the stager copied, as it counts them) and `bytes` each
`run_fwd.upload` span carries, read through benchmark/spans.py. A gauge of
the pinned path's reach, 100 where every upload takes it: the upload's
time is in io.memcpy_ms and io.stage_idle_ms. Nothing where no upload span
carries `staged` (a program with no stager, which uploads through a
pageable copy), without a device trace (off the card nothing is staged)
or without the program's spans."""

from benchmark import spans


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    reqs = spans.traced_requests(t.n)
    if reqs is None:
        return None
    ups = [a for req in reqs for _i, name, _s, _e, _p, a in req
           if name == "run_fwd.upload" and a and "staged" in a]
    total = sum(a["bytes"] for a in ups)
    if not total:
        return None
    return 100.0 * sum(a["staged"] for a in ups) / total
