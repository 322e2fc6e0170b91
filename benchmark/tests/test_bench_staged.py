"""io.staged_share on the synthetic traced stretch of test_bench_spans: 100
where every upload span's `staged` equals its `bytes`, the byte-weighted
share where some are not staged, 0 where spans carry `staged` = 0, and
nothing where no span carries `staged` (a program with no stager), without
a device trace or without the program's spans."""

import sys
import types

import pytest

from benchmark import spans, spec

from .test_bench_spans import synthetic

WIRE = 19267584   # the b128 u8 batch of the synthetic upload span


def staged_share(monkeypatch, mod, t):
    if mod is None:
        monkeypatch.delitem(sys.modules, spans.TIMERS_MODULE, raising=False)
    else:
        monkeypatch.setitem(sys.modules, spans.TIMERS_MODULE, mod)
    return spec.metric_reader("io.staged_share")(
        types.SimpleNamespace(trace=t))


def with_staged(mod, staged):
    """mod's spans with `staged` on each upload span: staged(k) for the
    k-th upload span, None to leave it out."""
    log = mod.global_timer_log.spans
    k = 0
    for i, (name, s, e, p, r, a) in enumerate(log):
        if name == "run_fwd.upload":
            v = staged(k)
            if v is not None:
                log[i] = (name, s, e, p, r, dict(a, staged=v))
            k += 1
    return mod


@pytest.mark.parametrize("n", [2, 30])
def test_reads_the_staged_share_of_the_traced_bytes(monkeypatch, n):
    mod, t = synthetic(n)
    assert staged_share(monkeypatch, with_staged(mod, lambda k: WIRE),
                        t) == 100.0
    mod, t = synthetic(n)
    assert staged_share(monkeypatch, with_staged(mod, lambda k: 0), t) == 0.0
    # the earlier stretch's request is left out: the traced n alone count
    mod, t = synthetic(n, earlier=1)
    half = with_staged(mod, lambda k: 0 if k % 2 else WIRE)
    want = 100.0 * sum(1 for k in range(1, n + 1) if k % 2 == 0) / n
    assert staged_share(monkeypatch, half, t) == pytest.approx(want)


def test_nothing_where_nothing_says_what_was_staged(monkeypatch):
    # a program with no stager: its upload spans carry bytes alone
    mod, t = synthetic(2)
    assert staged_share(monkeypatch, mod, t) is None
    # no device trace (a CPU run)
    mod, t = synthetic(2)
    t.device = []
    assert staged_share(monkeypatch, with_staged(mod, lambda k: WIRE),
                        t) is None
    # no trace, no spans, or fewer requests than the trace's n
    mod, t = synthetic(2)
    assert staged_share(monkeypatch, None, t) is None
    assert spec.metric_reader("io.staged_share")(
        types.SimpleNamespace(trace=None)) is None
    mod, t = synthetic(2, earlier=0)
    t.n = 3
    assert staged_share(monkeypatch, with_staged(mod, lambda k: WIRE),
                        t) is None
