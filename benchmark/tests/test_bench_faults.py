"""A run with the timed path broken underneath comes out not correct: for
each fault a one-card classification cell can have, put under `run_fwd`'s
answers on the CPU at a small size. (A cell on one card has no exchange
between chips to leave out.)"""

import numpy as np
import pytest

from benchmark.run import run_cell

from .small import SMALL, small_cell


def stale(request):
    """The program returns its previous answer: its state unchanged."""
    last = {}

    def f(u8):
        out = request(u8)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return f


def half_batch(request):
    """Half of the batch left out: its rows answered with the others'."""
    def f(u8):
        out = request(u8).copy()
        h = len(out) // 2
        out[h:2 * h] = out[:h]
        return out
    return f


def altered(request):
    """An answer altered where it is produced: in each request after the
    three warm-up ones, the first row has its largest and smallest logits
    swapped."""
    n = {"i": 0}

    def f(u8):
        out = request(u8).copy()
        n["i"] += 1
        if n["i"] > 3:
            a, b = int(np.argmax(out[0])), int(np.argmin(out[0]))
            out[0, a], out[0, b] = out[0, b], out[0, a]
        return out
    return f


@pytest.mark.parametrize("fault", [stale, half_batch, altered])
@pytest.mark.parametrize("w", ["googlenet-bf16-b128", "resnet50-bf16-b128",
                               "resnet50-int8-b128"])
def test_fault_is_not_correct(w, fault):
    r = run_cell(small_cell(w), 2**36 + 11, 0.5, False, device="cpu",
                 overrides=SMALL, wrap=fault)
    assert r.attempted >= 3
    assert not r.correct
    assert any(v > lim for v, lim in r.checks.values())


def test_sound_run_is_correct():
    r = run_cell(small_cell("googlenet-bf16-b128"), 2**36 + 11, 0.5,
                 False, device="cpu", overrides=SMALL)
    assert r.correct and r.attempted >= 3


def test_the_mean_row_sees_a_shift_shared_by_every_row():
    """Noise drawn apart for each row moves the batch's mean row by about
    1/sqrt(rows) of what it moves each row; the same shift in every row
    moves the mean row as much. Both numbers share the spread's scale."""
    from benchmark.check import spread, worst_err, worst_mean_err
    g = np.random.default_rng(5)
    ref = g.normal(size=(128, 1000)) + 50.0
    s = spread(ref)
    noise = 0.01 * s * g.normal(size=ref.shape) / np.sqrt(1000)
    shift = 0.01 * s * g.normal(size=(1, 1000)) / np.sqrt(1000)
    refs = {0: ref}
    assert worst_err([(0, ref + noise)], refs) == pytest.approx(0.01, rel=0.3)
    assert worst_mean_err([(0, ref + noise)], refs) < 0.002
    assert worst_mean_err([(0, ref + shift)], refs) == \
        pytest.approx(0.01, rel=0.1)
    assert worst_mean_err([(0, None)], refs) == float("inf")
