"""The readers of kernel B7's two metrics on synthetic traces: kern.b7_ms
sums B7's kernels by name (its conv and split-K reduce, not B6's or
cuDNN's) per request; tmpl.b7_step_share reads the `route` of the conv
steps' `fwd.step` spans. Both find nothing where the program has no B7
kernel or its spans carry no route (the parent of the change that added
them), and the share nothing without a device trace (a CPU run)."""

import sys
import types

import pytest

from benchmark import spans, spec
from benchmark.trace import Trace

B7 = "void (anonymous namespace)::bconv_kernel<128, 1>(__nv_bfloat16 const*)"
B7_REDUCE = "void (anonymous namespace)::bconv_reduce((anonymous namespace)::BOuts, int, int, int)"
B6 = "void (anonymous namespace)::qconv_kernel<__nv_bfloat16, 1>(signed char const*)"
CUDNN = "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw"


def _trace(n, kernels=((B7, 0.001),)):
    t = Trace(n, 1.0)
    t.device = [(0.01 * i, 0.01 * i + d, "kernel", name)
                for i, (name, d) in enumerate(kernels)]
    return t


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_kern_b7_ms_sums_b7_kernels_per_request():
    t = _trace(2, [(B7, 0.003), (B7_REDUCE, 0.001), (B6, 0.002),
                   (CUDNN, 0.004), (B7, 0.002)])
    got = _read("kern.b7_ms", types.SimpleNamespace(trace=t))
    assert got == pytest.approx(1e3 * 0.006 / 2)


def test_kern_b7_ms_finds_nothing_without_b7():
    t = _trace(3, [(B6, 0.002), (CUDNN, 0.004)])
    assert _read("kern.b7_ms", types.SimpleNamespace(trace=t)) is None
    assert _read("kern.b7_ms", types.SimpleNamespace(trace=None)) is None


def _spans_module(requests):
    """The timers module's stand-in: one request span per entry of
    `requests`, each holding a `fwd.step` span per (route or None)."""
    log, t0 = [], 1_000_000_000
    for routes in requests:
        root = len(log)
        log.append(("run_fwd", t0, t0 + 1000, root, root, None))
        for i, r in enumerate(routes):
            attrs = {"call_tag": f"s{i}", "func_name": "xla_conv"}
            if r is not None:
                attrs["route"] = r
            log.append(("fwd.step", t0 + i, t0 + i + 1, root, root, attrs))
        t0 += 10_000
    return types.SimpleNamespace(
        global_timer_log=types.SimpleNamespace(spans=log))


@pytest.mark.parametrize("requests,want", [
    ([["b7"] * 50] * 3, 100.0),
    ([["b7"] * 19 + ["b6"] * 31] * 2, 38.0),
    ([["b7", "vendor", None, "b7"]], 100.0 * 2 / 3),
])
def test_b7_step_share_reads_the_routes(monkeypatch, requests, want):
    monkeypatch.setitem(sys.modules, spans.TIMERS_MODULE,
                        _spans_module(requests))
    run = types.SimpleNamespace(trace=_trace(len(requests)))
    assert _read("tmpl.b7_step_share", run) == pytest.approx(want)
    # a CPU run: no device events, and the route ran the plain version
    run.trace.device = []
    assert _read("tmpl.b7_step_share", run) is None


def test_b7_step_share_finds_nothing_without_routes(monkeypatch):
    # the parent's spans carry no route
    monkeypatch.setitem(sys.modules, spans.TIMERS_MODULE,
                        _spans_module([[None] * 5] * 2))
    run = types.SimpleNamespace(trace=_trace(2))
    assert _read("tmpl.b7_step_share", run) is None
    # fewer requests than the trace's n, no program, no trace
    run.trace.n = 3
    assert _read("tmpl.b7_step_share", run) is None
    monkeypatch.delitem(sys.modules, spans.TIMERS_MODULE)
    assert _read("tmpl.b7_step_share",
                 types.SimpleNamespace(trace=_trace(2))) is None
    assert _read("tmpl.b7_step_share",
                 types.SimpleNamespace(trace=None)) is None
