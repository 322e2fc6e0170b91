"""The readers of the program's spans (benchmark/spans.py and the four
metrics on it): on a synthetic trace and span list with a known clock shift
and known gaps each metric reads exactly, and every gap lands in one idle
bucket; they find nothing without the program's spans or where the spans
cannot be placed; and on a CPU rehearsal they read None or numbers, raise
nothing and load no JAX."""

import json
import subprocess
import sys
import types

import pytest

from benchmark import spans, spec
from benchmark.trace import Trace

from .small import SMALL

READERS = ("engine.dispatch_idle_ms", "io.stage_idle_ms",
           "entry.between_idle_ms", "engine.enqueue_ms")
REQ_US = 10_000   # a request every 10 ms on both clocks
BASE_NS = 1_790_857_026_123_456_789   # the program's clock at request 0
TRACE_S = 12.5    # the trace's clock at request 0

# one request, us from its start on the program's clock: its spans, the
# host's CUDA calls, and the card's events
SPANS = [  # (name, start, end, parent position or None, attrs)
    ("run_fwd", 0, 8000, None, None),
    ("run_fwd.upload", 0, 2000, 0, {"bytes": 19267584}),
    ("fwd", 2010, 7000, 0, None),
    ("fwd.inputs", 2010, 2300, 2, None),
    ("fwd.step", 2300, 2400, 2, {"call_tag": "conv1", "func_name": "a"}),
    ("fwd.step", 2600, 2700, 2, {"call_tag": "pool1", "func_name": "b"}),
    ("fwd.outputs", 6900, 7000, 2, None),
    ("run_fwd.readback", 7400, 7999.5, 0, {"bytes": 512000}),
]
CALLS = [(1, 1990, "cudaMemcpyAsync"), (2310, 2390, "cudaLaunchKernel"),
         (2610, 2690, "cudaLaunchKernel"), (7500, 7999, "cudaMemcpyAsync"),
         (8001, 8050, "cudaDeviceSynchronize")]
DEVICE = [(100, 1000, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)"),
          (1200, 1990, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)"),
          (2100, 2250, "kernel", "preproc"), (2380, 2500, "kernel", "a"),
          (2800, 6800, "kernel", "b"), (6950, 7100, "kernel", "out"),
          (7600, 7700, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)"),
          (7800, 7810, "gpu_memset", "Memset (Device)")]
# each request's gaps, us, cut where a span starts or ends: [1000, 1200]
# in the upload; [1990, 2100] in the upload, run_fwd and fwd.inputs;
# [2250, 2380] 50 in fwd.inputs and 80 in a step; [2500, 2800] in fwd and a
# step; [6800, 6950] 100 in fwd and 50 in fwd.outputs; [7100, 7600] in
# run_fwd and the readback; [7700, 7800] in the readback; and but for the
# last request [7810, 10100]: 190 in the readback and run_fwd, 2000 between
# the requests and 100 in the next one's upload
STAGE_US, DISPATCH_US = 1010, 480     # every request's own
STAGE_NEXT_US, BETWEEN_US = 290, 2000  # each request's but the last
ENQUEUE_US = 2700


def synthetic(n: int, shift_us: float = 0.0, earlier: int = 1):
    """(the timers module's stand-in, a Trace) of n requests after
    `earlier` requests of another stretch; the trace's clock is the
    program's moved by shift_us more than the base."""
    log = [("torch_fwd_init", BASE_NS - 10**9, BASE_NS - 10**8, None, None,
            None)]
    for k in range(-earlier, n):
        t0 = BASE_NS + k * REQ_US * 1000
        first = len(log)
        log += [(name, t0 + int(s * 1000), t0 + int(e * 1000),
                 None if parent is None else first + parent, first, attrs)
                for name, s, e, parent, attrs in SPANS]
    mod = types.SimpleNamespace(global_timer_log=types.SimpleNamespace(
        spans=log))
    t = Trace(n, n * REQ_US * 1e-6)

    def at(k, us):
        return TRACE_S + (k * REQ_US + us + shift_us) * 1e-6
    for k in range(n):
        t.host += [(at(k, s), at(k, e), name) for s, e, name in CALLS]
        t.device += [(at(k, s), at(k, e), c, name)
                     for s, e, c, name in DEVICE]
    return mod, t


def read_all(monkeypatch, mod, t):
    if mod is None:
        monkeypatch.delitem(sys.modules, spans.TIMERS_MODULE, raising=False)
    else:
        monkeypatch.setitem(sys.modules, spans.TIMERS_MODULE, mod)
    run = types.SimpleNamespace(trace=t)
    return {m: spec.metric_reader(m)(run) for m in READERS}


@pytest.mark.parametrize("n,shift_us,earlier", [(2, 0.0, 1), (3, 0.7, 0),
                                                (30, -0.9, 2)])
def test_each_metric_reads_exactly(monkeypatch, n, shift_us, earlier):
    mod, t = synthetic(n, shift_us, earlier)
    got = read_all(monkeypatch, mod, t)
    want = {"engine.dispatch_idle_ms": DISPATCH_US / 1e3,
            "io.stage_idle_ms": (STAGE_US + STAGE_NEXT_US * (n - 1) / n)
            / 1e3,
            "entry.between_idle_ms": BETWEEN_US * (n - 1) / n / 1e3,
            "engine.enqueue_ms": ENQUEUE_US / 1e3}
    assert got == pytest.approx(want, rel=1e-9, abs=1e-9)
    # the shift is found to within the slack the calls leave (1 us)
    run = types.SimpleNamespace(trace=t)
    p = spans.placed(run)
    assert p.spans[0][0] == pytest.approx(TRACE_S + shift_us * 1e-6,
                                          abs=1.01e-6)
    assert [s[2] for s in p.spans[:3]] == ["run_fwd", "run_fwd.upload",
                                           "fwd"]


def test_every_idle_second_lands_in_one_bucket(monkeypatch):
    mod, t = synthetic(5, 0.3)
    monkeypatch.setitem(sys.modules, spans.TIMERS_MODULE, mod)
    run = types.SimpleNamespace(trace=t)
    p = spans.placed(run)
    for s, e in t.gaps():
        parts = p.parts(s, e)
        assert set(parts) == {spans.DISPATCH, spans.STAGE, spans.BETWEEN}
        assert min(parts.values()) >= 0
        assert sum(parts.values()) == pytest.approx(e - s, rel=1e-12)
    split = spans.idle_split(run)
    assert sum(split.values()) == pytest.approx(
        sum(e - s for s, e in t.gaps()), rel=1e-12)
    assert t.busy_s() + sum(split.values()) == pytest.approx(
        t.device[-1][1] - t.device[0][0], rel=1e-12)
    # a gap across the requests' boundary is cut there
    s, e = TRACE_S + (7810 + 0.3) * 1e-6, TRACE_S + (10100 + 0.3) * 1e-6
    assert p.parts(s, e) == pytest.approx(
        {spans.STAGE: 290e-6, spans.DISPATCH: 0.0, spans.BETWEEN: 2000e-6},
        abs=2e-12)
    # a moment in each span's own time, us from the second request's start
    own = {"run_fwd": 7200, "run_fwd.upload": 1000, "fwd": 5000,
           "fwd.inputs": 2100, "fwd.step": 2350, "fwd.outputs": 6950,
           "run_fwd.readback": 7700, None: 9000}
    assert {n: p.bucket(TRACE_S + (REQ_US + us + 0.3) * 1e-6)
            for n, us in own.items()} == {
        "run_fwd": spans.STAGE, "run_fwd.upload": spans.STAGE,
        "fwd": spans.DISPATCH, "fwd.inputs": spans.STAGE,
        "fwd.step": spans.DISPATCH, "fwd.outputs": spans.STAGE,
        "run_fwd.readback": spans.STAGE, None: spans.BETWEEN}
    assert p.innermost(TRACE_S + (REQ_US + 2350) * 1e-6)[4] == \
        {"call_tag": "conv1", "func_name": "a"}
    assert p.bucket(p.spans[0][0] - 1e-3) == spans.BETWEEN


def test_nothing_without_the_programs_spans(monkeypatch):
    _mod, t = synthetic(2)
    assert set(read_all(monkeypatch, None, t).values()) == {None}
    # a program whose timers keep no span list (before spans existed)
    old = types.SimpleNamespace(global_timer_log=types.SimpleNamespace(
        tags={}))
    assert set(read_all(monkeypatch, old, t).values()) == {None}
    # fewer requests than the trace's n
    mod, t = synthetic(2, earlier=0)
    t.n = 3
    assert set(read_all(monkeypatch, mod, t).values()) == {None}
    # a list that dropped spans past its cap
    mod, t = synthetic(2)
    mod.global_timer_log.dropped = 1
    assert set(read_all(monkeypatch, mod, t).values()) == {None}


def test_nothing_where_the_spans_cannot_be_placed(monkeypatch):
    # a sync inside a request: no shift puts every call inside its
    # request and every sync outside
    mod, t = synthetic(2)
    t.host.append((t.host[2][0], t.host[2][0] + 1e-6,
                   "cudaDeviceSynchronize"))
    t.host.remove(t.host[4])
    got = read_all(monkeypatch, mod, t)
    assert got["engine.dispatch_idle_ms"] is None
    assert got["engine.enqueue_ms"] == pytest.approx(ENQUEUE_US / 1e3)
    # a clock that drifts 50 us over one request
    mod, t = synthetic(2)
    t.host = [(s + (50e-6 if s > TRACE_S + REQ_US * 1e-6 else 0),
               e + (50e-6 if s > TRACE_S + REQ_US * 1e-6 else 0), n)
              for s, e, n in t.host]
    monkeypatch.setitem(sys.modules, spans.TIMERS_MODULE, mod)
    run = types.SimpleNamespace(trace=t)
    lo, hi = spans.clock_bounds(spans.traced_requests(2), t.host)
    assert lo > hi and spans.placed(run) is None
    # no device events (a CPU run): no idle and no enqueue
    mod, t = synthetic(2)
    t.device = []
    assert set(read_all(monkeypatch, mod, t).values()) == {None}


REHEARSE = """
import json, sys
from benchmark import run as R, spans, spec
from benchmark.tests.small import small_cell
cell = small_cell({w!r})
r = R.run_cell(cell, 2**41 + 5, 0.5, True, device="cpu", overrides={ov!r})
reqs = spans.traced_requests(r.trace.n)
print(json.dumps({{
    "metrics": {{m: spec.metric_reader(m)(r) for m in {readers!r}}},
    "requests": [[s[1] for s in q] for q in reqs],
    "forbidden": R.forbidden_modules()}}))
"""


def test_cpu_rehearsal_reads_without_raising():
    code = REHEARSE.format(w="googlenet-bf16-b128", readers=READERS,
                           ov=dict(SMALL, trace_requests=2))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=spec.ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(out["metrics"]) == set(READERS)
    assert all(v is None or isinstance(v, float)
               for v in out["metrics"].values())
    # the program kept both traced requests' spans; a CPU trace has no
    # device events, so nothing is read from them
    assert len(out["requests"]) == 2
    for names in out["requests"]:
        assert names[:3] == ["run_fwd", "run_fwd.upload", "fwd"]
        assert names[-1] == "run_fwd.readback"
        assert names.count("fwd.step") > 10
    assert out["forbidden"] == []
