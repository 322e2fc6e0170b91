"""The port's spans (core/timers.py, engine/torch_fwd.py) on the CPU: with no
profiler the timers keep their aggregate alone (no record_function, no span,
no step hook); under a profiler each run_fwd is a request of nested spans,
one `fwd.step` per step, in the fused executor, the per-call mode and a
one-slot mesh; the list's cap and clear(); cnet_xprof's rows leave the
spans out."""

import json
import threading
import time

import numpy as np
import pytest
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from boda_tpu_torch.core import timers
from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.core.timers import global_timer_log, timer
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.tune.xprof import aggregate_profile

FUSED_CHILDREN = ["run_fwd.upload", "fwd", "run_fwd.readback"]


@pytest.fixture(autouse=True)
def clean_log():
    global_timer_log.clear()
    yield
    global_timer_log.clear()


def _engine(spec: str = ""):
    pipe = build_model("mini", batch=2)
    eng = make_engine(f"(engine=torch,device=cpu{spec})")
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    x = NDA(d, np.random.RandomState(0).randn(*d.shape).astype(np.float32))
    return eng, {pipe.data_img_node_names[0]: x}, ["prob"]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _request(spans, root):
    """The spans of the request opened by spans[root], by index."""
    return {i: s for i, s in enumerate(spans) if s[4] == root}


def _check_tree(spans, req):
    """Every span of a request is closed and lies inside its parent."""
    for i, (name, start, end, parent, _r, _a) in req.items():
        assert end is not None and start <= end, name
        if parent is not None:
            p = spans[parent]
            assert p[1] <= start and end <= p[2], (name, p[0])
            assert parent < i


def test_no_profiler_keeps_the_aggregate_alone(monkeypatch):
    entered = []
    real = autograd_profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()
    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    eng, feed, get = _engine()
    hooks = []
    fwd = eng.fwd

    def spy(*a, **k):
        hooks.append(k.get("step_hook", "absent"))
        return fwd(*a, **k)
    eng.fwd = spy
    before = global_timer_log.tags.get("run_fwd", (0, 0.0))[0]
    eng.run_fwd(feed, get)
    assert entered == [] and global_timer_log.spans == []
    assert hooks == [None]
    assert global_timer_log.tags["run_fwd"][0] == before + 1
    for tag in ("run_fwd.upload", "fwd", "fwd.inputs", "fwd.outputs",
                "run_fwd.readback"):
        assert global_timer_log.tags[tag][0] == 1, tag
    assert "fwd.step" not in global_timer_log.tags
    # the same counting class opens one range per timer under a profiler
    _profiled(lambda: eng.run_fwd(feed, get))
    assert entered == ["run_fwd", "run_fwd.upload", "fwd", "fwd.inputs",
                       "fwd.outputs", "run_fwd.readback"]


@pytest.mark.parametrize("tune", ["()", "(prec=bf16,layout=nhwc)"])
def test_profiled_run_fwd_is_one_request(tune):
    eng, feed, get = _engine(f",op_tune={tune}")
    _profiled(lambda: eng.run_fwd(feed, get))
    spans = global_timer_log.spans
    roots = [i for i, s in enumerate(spans) if s[4] == i]
    assert [spans[i][0] for i in roots] == ["run_fwd"]
    root = roots[0]
    assert spans[root][3] is None
    req = _request(spans, root)
    assert len(req) == len(spans)
    _check_tree(spans, req)
    kids = [i for i, s in req.items() if s[3] == root]
    assert [spans[i][0] for i in kids] == FUSED_CHILDREN
    up, f, rb = kids
    in_fwd = [spans[i] for i, s in req.items() if s[3] == f]
    names = [s[0] for s in in_fwd]
    steps = eng.plan.steps
    assert names == ["fwd.inputs"] + ["fwd.step"] * len(steps) \
        + ["fwd.outputs"]
    assert [(s[5]["call_tag"], s[5]["func_name"]) for s in in_fwd[1:-1]] \
        == [(s.call_tag, s.func_name) for s in steps]
    # the steps run one after another, between the inputs and the outputs
    ends = [s[2] for s in in_fwd[:-1]]
    starts = [s[1] for s in in_fwd[1:]]
    assert all(e <= s for e, s in zip(ends, starts))
    # off the card nothing goes through the pinned stager
    assert spans[up][5] == {"bytes": feed["data"].v.nbytes, "staged": 0}
    assert spans[rb][5] == {"bytes": 2 * 10 * 4}  # mini's prob, b2 f32
    # on time.time_ns()'s clock
    assert abs(spans[root][1] - time.time_ns()) < 60e9


def test_per_call_mode_run_func_spans():
    eng, feed, get = _engine(",fuse=0")
    _profiled(lambda: eng.run_fwd(feed, get))
    spans = global_timer_log.spans
    root = next(i for i, s in enumerate(spans) if s[0] == "run_fwd")
    req = _request(spans, root)
    _check_tree(spans, req)
    kids = [s for s in req.values() if s[3] == root]
    assert [s[0] for s in kids] == ["run_func"] * len(eng.fwd_calls)
    assert all(s[4] == root for s in kids)


def test_one_slot_mesh_forward_spans():
    eng, feed, get = _engine(",mesh_dp=1")
    assert eng.mesh is not None and eng.mesh.shape == {"dp": 1, "mp": 1}
    _profiled(lambda: eng.run_fwd(feed, get))
    spans = global_timer_log.spans
    req = _request(spans, 0)
    assert len(req) == len(spans)
    _check_tree(spans, req)
    steps = [s for s in spans if s[0] == "fwd.step"]
    assert [s[5]["call_tag"] for s in steps] == \
        [s.call_tag for s in eng.plan.steps]


def test_requests_of_several_calls_and_threads():
    eng, feed, get = _engine()

    def two():
        eng.run_fwd(feed, get)
        eng.run_fwd(feed, get)
    _profiled(two)
    spans = global_timer_log.spans
    roots = [i for i, s in enumerate(spans) if s[4] == i]
    assert len(roots) == 2 and roots[0] == 0
    assert sum(len(_request(spans, r)) for r in roots) == len(spans)
    assert spans[roots[0]][2] <= spans[roots[1]][1]
    # another thread's spans have their own parents
    global_timer_log.clear()
    barrier = threading.Barrier(2)

    def worker(tag):
        with timer(tag, request=True):
            barrier.wait(timeout=30)
            with timer(tag + ".in"):
                barrier.wait(timeout=30)
    with profile(activities=[ProfilerActivity.CPU]):
        ts = [threading.Thread(target=worker, args=(t,)) for t in "ab"]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    spans = global_timer_log.spans
    by = {s[0]: (i, s) for i, s in enumerate(spans)}
    for tag in "ab":
        i, _ = by[tag]
        _, inner = by[tag + ".in"]
        assert inner[3] == i and inner[4] == i


def test_a_span_closes_when_its_scope_raises():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with timer("outer", request=True):
                with timer("inner"):
                    raise ValueError("x")
        with timer("after"):
            pass
    (o, i, a) = global_timer_log.spans
    assert o[2] is not None and i[2] is not None and i[3] == 0
    assert a[3] is None and a[4] is None
    assert global_timer_log.tags["inner"][0] == 1


@pytest.mark.parametrize("profiled", [False, True])
def test_a_scope_adds_to_its_spans_attrs(profiled):
    def scopes():
        with timer("up", bytes=4) as attrs:
            attrs["staged"] = 3
        with timer("bare") as attrs:
            attrs["late"] = 1   # a span opened with none keeps none
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            scopes()
        assert [(s[0], s[5]) for s in global_timer_log.spans] == [
            ("up", {"bytes": 4, "staged": 3}), ("bare", None)]
    else:
        scopes()
        assert global_timer_log.spans == []
    assert global_timer_log.tags["up"][0] == 1


def test_clear_and_the_cap(monkeypatch):
    monkeypatch.setattr(timers, "SPAN_CAP", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(5):
            with timer(f"t{k}"):
                pass
    assert [s[0] for s in global_timer_log.spans] == ["t0", "t1", "t2"]
    assert global_timer_log.dropped == 2
    # a profiler run or a timer without one keeps the list
    with timer("unprofiled"):
        pass
    assert len(global_timer_log.spans) == 3
    global_timer_log.clear()
    assert global_timer_log.spans == [] and global_timer_log.dropped == 0
    assert global_timer_log.tags == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with timer("again"):
            pass
    assert [s[0] for s in global_timer_log.spans] == ["again"]


def test_ranges_in_the_trace_and_not_in_xprof_rows(tmp_path):
    eng, feed, get = _engine()
    _, prof = _profiled(lambda: eng.run_fwd(feed, get))
    fn = tmp_path / "trace.json"
    prof.export_chrome_trace(str(fn))
    names = {e.get("name") for e in json.loads(fn.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"run_fwd", "run_fwd.upload", "fwd", "fwd.inputs",
            "fwd.outputs", "run_fwd.readback"} <= names
    assert "fwd.step" not in names
    rows = {r["op"] for r in aggregate_profile(prof, device=False)}
    assert rows and not rows & names
