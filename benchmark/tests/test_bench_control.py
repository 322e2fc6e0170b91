"""The control comes out not correct: the plain reference one precision
below the one each site declares (bf16 -> int8 at the input's own absmax,
int8 -> int4 at the calibrated one), put in the program's place and held to
the cell's limit against the reference at the declared precision, while the
program's own answers pass it; where the cell mixes precisions, so does the
control that lowers only the sites above int8. On the CPU at a small size, and under `card` at each cell's
own size over three seeds (`python -m benchmark.limits` prints the same
readings for any number of seeds)."""

import pytest

from benchmark import spec
from benchmark.limits import readings
from benchmark.run import run_cell

from .small import SMALL, small_cell

CELLS = ["resnet50-int8-b128", "googlenet-bf16-b128", "resnet50-bf16-b128"]
NUMBERS = ("logit_err", "mean_logit_err")


def fails(pair, limits):
    """Whether a reading [logit_err, mean_logit_err] is over a limit."""
    return any(v > limits[n] for v, n in zip(pair, NUMBERS))


@pytest.mark.parametrize("w", CELLS)
def test_control_fails_the_limit_small(w):
    cell = small_cell(w)
    r = run_cell(cell, 2**35 + 7, 0.5, False, device="cpu", overrides=SMALL)
    assert r.correct
    got = readings(r, 2**35 + 7, "cpu")
    assert fails(got["control"], cell.limits)
    for fault in ("stale_answer", "half_batch", "altered_answer"):
        assert fails(got[fault], cell.limits)


@pytest.mark.card
@pytest.mark.parametrize("w", CELLS)
def test_control_fails_the_limit_at_cell_size(w, card):
    cell = spec.load_cell(w)
    for seed in (2**33 + 1, 2**33 + 2, 2**33 + 3):
        r = run_cell(cell, seed, 2.0, False)
        assert r.correct
        got = readings(r, seed)
        assert fails(got["control"], cell.limits)
        if "int8" in r.sites.values():
            assert fails(got["control_above_int8"], cell.limits)
