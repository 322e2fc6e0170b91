"""The program's spans of a traced stretch, placed on the device trace's clock.

While a profiler records, the port's timers (`boda_tpu_torch/core/timers.py`)
keep spans (name, start_ns, end_ns, parent, request, attrs) on
`time.time_ns()`'s clock in `global_timer_log.spans`: a request per
`TorchFwd.run_fwd` call, holding `run_fwd.upload`, `fwd` (with `fwd.inputs`,
one `fwd.step` per step and `fwd.outputs`) and `run_fwd.readback`. This module
takes that list from `sys.modules`, so it imports nothing of the program, and
finds nothing (None) where the program is not loaded or keeps no spans. It
keeps the spans of the stretch's n requests, the last n the list holds (the
profiler records the traced calls alone).

`Trace`'s times are the profiler's clock less a base that `trace.py` drops,
so the spans are placed by a shift found from the host's CUDA calls: each
call the program makes in a request lies inside that request's `run_fwd`
span, and the `cudaDeviceSynchronize` that `traced` makes after each request
lies after it (the profiler's own sync at its stop, with no call before it,
closes no request). Every request bounds the shift from both sides; the
shift is the middle of what all of them allow, and where they allow nothing
the spans are not placed.

Each idle gap of the trace (`Trace.gaps`) is cut where a placed span starts
or ends, and each piece is put down to one of three buckets by the innermost
span that holds it: DISPATCH (a step, or the executor's own time between
steps), STAGE (the input's upload, the input and output staging, the
readback, `run_fwd`'s own time) or BETWEEN (outside every request: the
caller's time). A gap is cut, not given whole to the span that holds its
middle: the gap from one request's readback to the next one's upload has
its middle near the requests' boundary, so a shift a few microseconds off
would move all of it between buckets.
"""

from __future__ import annotations

import bisect
import sys

TIMERS_MODULE = "boda_tpu_torch.core.timers"
SYNC = "cudaDeviceSynchronize"
DISPATCH, STAGE, BETWEEN = "dispatch", "stage", "between"
BUCKET_OF = {"fwd.step": DISPATCH, "fwd": DISPATCH,
             "run_fwd.upload": STAGE, "fwd.inputs": STAGE,
             "fwd.outputs": STAGE, "run_fwd.readback": STAGE,
             "run_fwd": STAGE}


def program_spans():
    """The program's span list, or None where it keeps none or dropped
    some past its cap."""
    log = getattr(sys.modules.get(TIMERS_MODULE), "global_timer_log", None)
    spans = getattr(log, "spans", None)
    if not isinstance(spans, list) or getattr(log, "dropped", 0):
        return None
    return spans


def traced_requests(n: int):
    """The last n requests' spans: [[(index, name, start_ns, end_ns,
    parent, attrs), ...] per request, its `run_fwd` first], or None where
    the list holds fewer than n finished requests."""
    spans = program_spans()
    if spans is None or n <= 0:
        return None
    spans = list(spans)
    roots = [i for i, s in enumerate(spans)
             if s[4] == i and s[2] is not None]
    if len(roots) < n:
        return None
    keep = {i: [] for i in roots[-n:]}
    for i in range(roots[-n], len(spans)):
        name, start, end, parent, req, attrs = spans[i]
        if req in keep and end is not None:
            keep[req].append((i, name, start, end, parent, attrs))
    return list(keep.values())


def request_calls(host):
    """[(the host's CUDA calls of a request, the sync after it)]: the calls
    between one `cudaDeviceSynchronize` and the next that holds some (a
    sync with none before it, such as the profiler's own at its stop,
    closes nothing)."""
    syncs = sorted(h for h in host if h[2] == SYNC)
    calls = sorted(h for h in host if h[2] != SYNC)
    starts = [c[0] for c in calls]
    out, prev = [], float("-inf")
    for sync in syncs:
        mine = calls[bisect.bisect_left(starts, prev):
                     bisect.bisect_left(starts, sync[0])]
        if mine:
            out.append((mine, sync))
        prev = sync[1]
    return out


def clock_bounds(requests, host):
    """(lo, hi): the shifts c (s) for which every request's `run_fwd`,
    at (ns - the first request's start_ns) * 1e-9 + c on the trace's
    clock, holds the host's CUDA calls made before the harness's sync that
    follows it, and ends before that sync. None where the syncs do not
    split the calls into as many requests."""
    segs = request_calls(host)
    if len(segs) != len(requests):
        return None
    ref = requests[0][0][2]
    lo, hi = float("-inf"), float("inf")
    prev = float("-inf")
    for req, (mine, sync) in zip(requests, segs):
        a = (req[0][2] - ref) * 1e-9
        b = (req[0][3] - ref) * 1e-9
        lo = max(lo, max(c[1] for c in mine) - b, prev - a)
        hi = min(hi, mine[0][0] - a, sync[0] - b)
        prev = sync[1]
    return lo, hi


class Placed:
    """The traced requests' spans on the trace's clock, by start: (start_s,
    end_s, name, parent index, attrs, index)."""

    def __init__(self, spans: list):
        self.spans = spans
        self.starts = [sp[0] for sp in self.spans]
        self.by_index = {sp[5]: sp for sp in self.spans}
        self.line = self.timeline()
        self.line_starts = [x[0] for x in self.line]

    def innermost(self, t: float):
        """The innermost span that holds t, or None. Spans of one thread
        nest or do not meet, so it is the one that starts last before t or
        an ancestor of it."""
        k = bisect.bisect_right(self.starts, t) - 1
        sp = self.spans[k] if k >= 0 else None
        while sp is not None and sp[1] < t:
            sp = self.by_index.get(sp[3])
        return sp

    def bucket(self, t: float) -> str:
        sp = self.innermost(t)
        while sp is not None:
            if sp[2] in BUCKET_OF:
                return BUCKET_OF[sp[2]]
            sp = self.by_index.get(sp[3])
        return BETWEEN

    def timeline(self) -> list:
        """[(start, end, bucket)]: the requests' time cut where any span
        starts or ends, each piece in the bucket of its innermost span,
        neighbours of one bucket merged."""
        pts = sorted({x for sp in self.spans for x in sp[:2]})
        out = []
        for a, b in zip(pts, pts[1:]):
            k = self.bucket((a + b) / 2)
            if out and out[-1][2] == k:
                out[-1] = (out[-1][0], b, k)
            else:
                out.append((a, b, k))
        return out

    def parts(self, s: float, e: float) -> dict:
        """{bucket: seconds} of the stretch [s, e], cut by the timeline:
        every second of it in exactly one bucket (BETWEEN outside every
        request)."""
        out = dict.fromkeys((DISPATCH, STAGE, BETWEEN), 0.0)
        held = 0.0
        k = max(bisect.bisect_right(self.line_starts, s) - 1, 0)
        while k < len(self.line) and self.line[k][0] < e:
            a, b, bucket = self.line[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[bucket] += part
                held += part
            k += 1
        out[BETWEEN] += (e - s) - held
        return out


def placed(run):
    """The traced requests' spans placed on run.trace's clock, or None."""
    t = run.trace
    if t is None or not t.host:
        return None
    reqs = traced_requests(t.n)
    if reqs is None:
        return None
    bounds = clock_bounds(reqs, t.host)
    if bounds is None or bounds[0] > bounds[1]:
        return None
    shift = (bounds[0] + bounds[1]) / 2
    ref = reqs[0][0][2]
    # by start; of two that start at once, the holder first (the lower
    # index: a span is listed when it opens)
    spans = sorted(
        (((s - ref) * 1e-9 + shift, (e - ref) * 1e-9 + shift, name, parent,
          attrs, i) for req in reqs for i, name, s, e, parent, attrs in req),
        key=lambda sp: (sp[0], sp[5]))
    return Placed(spans)


def idle_split(run):
    """{bucket: device idle seconds over the traced stretch}: every second
    of Trace.gaps() in exactly one bucket; None where the trace holds no
    device events or the spans cannot be placed."""
    t = run.trace
    if t is None or not t.device:
        return None
    p = placed(run)
    if p is None:
        return None
    out = dict.fromkeys((DISPATCH, STAGE, BETWEEN), 0.0)
    for s, e in t.gaps():
        for k, v in p.parts(s, e).items():
            out[k] += v
    return out


def idle_ms(run, bucket: str):
    """A bucket's device idle ms per traced request, or None."""
    split = idle_split(run)
    return None if split is None else 1e3 * split[bucket] / run.trace.n


def enqueue_s(run):
    """Host seconds per traced request from the start of `run_fwd` to the
    end of its last `fwd.step`, their mean; None without a device trace or
    without step spans."""
    t = run.trace
    if t is None or not t.device:
        return None
    reqs = traced_requests(t.n)
    if reqs is None:
        return None
    out = []
    for req in reqs:
        ends = [e for _i, name, _s, e, _p, _a in req if name == "fwd.step"]
        if not ends:
            return None
        out.append((max(ends) - req[0][2]) * 1e-9)
    return sum(out) / len(out)
