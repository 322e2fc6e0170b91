"""Host-side scope timing with a global per-tag aggregate log.

Capability parity with the reference's timer_t / global_timer_log
(timers.H:19, finalize print at boda.cc:111): RAII scope timers accumulate
(count, total duration) per tag; `global_timer_log_finalize()` renders the
CNT / TOT_DUR / AVG_DUR table printed at process exit.

The port's copy of boda_tpu/core/timers.py.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional


class TimerLog:
    def __init__(self):
        self.tags: dict[str, tuple[int, float]] = {}
        self.enabled = True

    def add(self, tag: str, dur: float) -> None:
        cnt, tot = self.tags.get(tag, (0, 0.0))
        self.tags[tag] = (cnt + 1, tot + dur)

    def clear(self) -> None:
        self.tags.clear()

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
def timer(tag: str, log: Optional[TimerLog] = None):
    log = log or global_timer_log
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if log.enabled:
            log.add(tag, time.perf_counter() - t0)


def timer_log() -> TimerLog:
    return global_timer_log


def global_timer_log_finalize(print_fn=print) -> None:
    if global_timer_log.tags:
        print_fn(global_timer_log.render(), end="")
