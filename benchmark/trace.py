"""The device trace of a stretch of requests, and what is read from it.

`traced` runs `n` requests under `torch.profiler` with the card's activity
(CUPTI), after one request as the profiler's warm-up, with 0.25 s of idle time
inside each end of the recorded window: the margin and the warm-up of the
port's `tune/xprof.traced_steps`, which lost a trace's first kernels or events
whose clock had drifted without them. It exports the profile as a Chrome trace
into a temporary directory, reads it back and deletes it.

`Trace` holds the device events (kernels, copies, sets) and the host's CUDA
calls. Kernel names are reduced to kinds by `kernel_kind`, a copy of the port's
name rules (`tune/xprof.kernel_kind`): the name without template arguments,
parameter list, return type, anonymous namespace or instance suffix.
"""

from __future__ import annotations

import bisect
import json
import re
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

MARGIN_S = 0.25
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_TRAIL_ID = re.compile(r"\.\d+$")
_TEMPLATE_ARGS = re.compile(r"<[^<>]*>")


def _strip_params(k: str) -> str:
    depth = 0
    for i in range(len(k) - 1, 0, -1):
        if k[i] == ")":
            depth += 1
        elif k[i] == "(":
            depth -= 1
            if depth == 0:
                return k[:i].rstrip()
    return k


def kernel_kind(name: str) -> str:
    """'void at::native::vectorized_elementwise_kernel<4, ...>(int, ...)'
    -> 'at::native::vectorized_elementwise_kernel'."""
    k = name.replace("(anonymous namespace)::", "")
    prev = None
    while prev != k:
        prev, k = k, _TEMPLATE_ARGS.sub("", k)
    if k.endswith(")"):
        k = _strip_params(k)
    if k.startswith("void "):
        k = k[5:]
    return _TRAIL_ID.sub("", k.strip())


@dataclass
class Trace:
    """What one traced stretch of `n` requests holds. Times in seconds."""
    n: int
    window_s: float
    device: list = field(default_factory=list)   # (start, end, cat, name)
    host: list = field(default_factory=list)     # (start, end, name)

    def kernels(self) -> list:
        return [e for e in self.device if e[2] == "kernel"]

    def seconds(self, pred, cat: str = "kernel") -> float:
        """Device seconds of the events of category cat whose name
        satisfies pred."""
        return sum(e[1] - e[0] for e in self.device
                   if e[2] == cat and pred(e[3]))

    def busy_s(self) -> float:
        """Seconds in which any device event ran (their union)."""
        tot, end = 0.0, None
        for s, e, _c, _n in sorted(self.device):
            if end is None or s > end:
                tot += e - s
                end = e
            elif e > end:
                tot += e - end
                end = e
        return tot

    def gaps(self) -> list:
        """(start, end) of each stretch between device events."""
        out, end = [], None
        for s, e, _c, _n in sorted(self.device):
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return out

    def device_ops(self, top: int = 10) -> list:
        """[kind, seconds] of the device operations that took most time."""
        by: dict = {}
        for s, e, c, n in self.device:
            k = kernel_kind(n) if c == "kernel" else n
            by[k] = by.get(k, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:top]

    def idle_gaps(self, top: int = 10) -> list:
        """[what the host was doing, idle seconds]: each gap between device
        events under the innermost host CUDA call that spans its middle
        ('host, outside any CUDA call' where none does), summed by that
        name; and the idle time of the window outside the first and last
        device event, which the host's clock and the card's do not place
        exactly, as 'before the first or after the last device event'."""
        by: dict = {}
        hosts = sorted(self.host)
        starts = [h[0] for h in hosts]
        for s, e in self.gaps():
            mid = (s + e) / 2
            best = None
            # the calls of one host thread do not overlap but for a driver
            # call inside a runtime call: the few that start last before
            # the middle hold any that spans it
            i = bisect.bisect_right(starts, mid)
            for hs, he, hn in hosts[max(0, i - 8):i]:
                if he >= mid and (best is None or he - hs < best[1] - best[0]):
                    best = (hs, he, hn)
            k = best[2] if best else "host, outside any CUDA call"
            by[k] = by.get(k, 0.0) + (e - s)
        edge = self.window_s - self.busy_s() - sum(by.values())
        if edge > 0:
            by["before the first or after the last device event"] = edge
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:top]


def parse_chrome_trace(path: Path, n: int, window_s: float) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    t = Trace(n, window_s)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            t.device.append((s, e, cat, ev.get("name", "")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            t.host.append((s, e, ev.get("name", "")))
    return t


def traced(request, n: int, on_card: bool) -> Trace:
    """Trace `n` calls of request() (each followed by a synchronize), after
    one call as the profiler's warm-up; window_s is the host's time from
    the start of the first traced call to the end of the last."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    act = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    with profile(activities=act, schedule=schedule(
            wait=0, warmup=1, active=n, repeat=1)) as prof:
        request()
        sync()
        prof.step()
        time.sleep(MARGIN_S)
        t0 = time.perf_counter()
        for i in range(n):
            request()
            sync()
            if i == n - 1:
                t1 = time.perf_counter()
                time.sleep(MARGIN_S)
            prof.step()
    with tempfile.TemporaryDirectory() as d:
        fn = Path(d) / "trace.json"
        prof.export_chrome_trace(str(fn))
        return parse_chrome_trace(fn, n, t1 - t0)
