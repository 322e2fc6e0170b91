"""Host-side scope timing with a global per-tag aggregate log, and spans
while a profiler records.

Capability parity with the reference's timer_t / global_timer_log
(timers.H:19, finalize print at boda.cc:111): RAII scope timers accumulate
(count, total duration) per tag; `global_timer_log_finalize()` renders the
CNT / TOT_DUR / AVG_DUR table printed at process exit.

While a torch profiler records (`torch.autograd.profiler.
_is_profiler_enabled`), each timer is also a span: a record
(name, start_ns, end_ns, parent, request, attrs) in `TimerLog.spans`, on
`time.time_ns()`'s clock (the clock of the profiler's trace, up to a
constant), and a `record_function(tag)` range in the profiler's own trace.
`parent` is the index of the enclosing open span of the same thread;
`request` is the index of the innermost enclosing span opened with
`request=True` (one `TorchFwd.run_fwd` call), which every span of that call
shares. `TimerLog.recorder` records intervals measured by the caller, with
no range and no aggregate row: the executor's steps (`engine/torch_fwd.py`),
whose host cost is the thing measured. The list stops growing at SPAN_CAP
records (threads that race past it add a few more); later spans are counted
in `dropped`, and only `clear()` empties it. With no profiler recording, a
timer costs one flag test more than the aggregate alone.

The port's copy of boda_tpu/core/timers.py, with the spans added.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional

from torch.autograd import profiler as _profiler

SPAN_CAP = 1 << 18


def recording() -> bool:
    """True while a torch profiler records."""
    return _profiler._is_profiler_enabled


class TimerLog:
    def __init__(self):
        self.tags: dict[str, tuple[int, float]] = {}
        # (name, start_ns, end_ns, parent, request, attrs); end_ns is None
        # while the span is open
        self.spans: list[tuple] = []
        self.dropped = 0
        self._local = threading.local()

    def add(self, tag: str, dur: float) -> None:
        cnt, tot = self.tags.get(tag, (0, 0.0))
        self.tags[tag] = (cnt + 1, tot + dur)

    def clear(self) -> None:
        self.tags.clear()
        self.spans.clear()
        self.dropped = 0

    def _open_spans(self) -> list:
        """This thread's open spans, innermost last: (index, request)."""
        st = getattr(self._local, "open", None)
        if st is None:
            st = self._local.open = []
        return st

    def open(self, name: str, request: bool = False,
             attrs: Optional[dict] = None) -> Optional[int]:
        """Opens a span now inside this thread's innermost open one; its
        index, or None past the cap."""
        st = self._open_spans()
        parent, req = st[-1] if st else (None, None)
        spans = self.spans
        if len(spans) >= SPAN_CAP:
            self.dropped += 1
            return None
        rec = (name, time.time_ns(), None, parent, req, attrs)
        spans.append(rec)
        # another thread may append between these lines: find this record
        i = len(spans) - 1
        while i >= 0 and spans[i] is not rec:
            i -= 1
        if i < 0:  # cleared meanwhile
            return None
        if request:
            req = i
            spans[i] = rec[:4] + (req, attrs)
        st.append((i, req))
        return i

    def close(self, i: int) -> None:
        end = time.time_ns()
        st = self._open_spans()
        if st and st[-1][0] == i:
            st.pop()
        if i < len(self.spans) and self.spans[i][2] is None:
            name, start, _end, parent, req, attrs = self.spans[i]
            self.spans[i] = (name, start, end, parent, req, attrs)

    def recorder(self, name: str):
        """add(start_ns, end_ns, attrs): records closed spans `name` inside
        this thread's innermost open span as it is now, at the cost of an
        append (the executor's steps)."""
        st = self._open_spans()
        parent, req = st[-1] if st else (None, None)
        spans = self.spans

        def add(start_ns: int, end_ns: int, attrs: Optional[dict]) -> None:
            if len(spans) < SPAN_CAP:
                spans.append((name, start_ns, end_ns, parent, req, attrs))
            else:
                self.dropped += 1
        return add

    def render(self) -> str:
        if not self.tags:
            return "TIMERS: (none)\n"
        rows = [("TAG", "CNT", "TOT_DUR", "AVG_DUR")]
        for tag in sorted(self.tags, key=lambda t: -self.tags[t][1]):
            cnt, tot = self.tags[tag]
            rows.append((tag, str(cnt), _fmt_dur(tot), _fmt_dur(tot / cnt)))
        w = [max(len(r[i]) for r in rows) for i in range(4)]
        out = ["TIMERS:"]
        for r in rows:
            out.append("  " + "  ".join(s.ljust(w[i]) for i, s in enumerate(r)))
        return "\n".join(out) + "\n"


def _fmt_dur(s: float) -> str:
    if s >= 1.0:
        return f"{s:.3f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.3f}ms"
    return f"{s * 1e6:.1f}us"


global_timer_log = TimerLog()


@contextmanager
def timer(tag: str, log: Optional[TimerLog] = None, request: bool = False,
          **attrs):
    """Adds the scope's duration to tag's aggregate row; while a profiler
    records, the scope is also a span (attrs: its attributes; request:
    it opens a request) and a record_function range."""
    log = log or global_timer_log
    t0 = time.perf_counter()
    if not _profiler._is_profiler_enabled:
        try:
            yield
        finally:
            log.add(tag, time.perf_counter() - t0)
        return
    i = log.open(tag, request, attrs or None)
    try:
        with _profiler.record_function(tag):
            yield
    finally:
        if i is not None:
            log.close(i)
        log.add(tag, time.perf_counter() - t0)


def global_timer_log_finalize(print_fn=print) -> None:
    if global_timer_log.tags:
        print_fn(global_timer_log.render(), end="")
