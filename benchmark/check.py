"""The comparison that decides `correct`.

Every request the run timed returned the logits of one batch of the request
pool. The plain reference computes each pool batch's logits once, from the
benchmark's own weights and images, at the precision the cell declares (bf16
storage and operands, int8 sites from integer codes; float32 sums, TF32 off).
Each logit row the program returned is held against its reference row by

    err = || program row - reference row ||_2 / spread

where spread is the root mean square distance of the reference batch's rows
from their mean row: the gap as a share of what tells one image's logits from
another's. (At seeded weights the logits of distinct images are nearly
parallel, so a share of the row's own norm would rate another image's answer
as close.) Two numbers are compared, each with the cell's limit from
`cells/<workload>.json`:

- `logit_err`, the largest `err` over every row of every request: a wrong,
  stale or missing row, or a precision far below the declared one;
- `mean_logit_err`, the largest over the requests of the gap between the
  batch's mean rows, || mean program row - mean reference row ||_2 / spread.
  Rounding that departs from the reference's at random moves the rows apart
  and their mean little; a precision below the declared one at some sites
  (int8 filters where bf16 ones are declared) moves every row alike, and so
  the mean.

A request that failed, a non-finite logit or a row count that differs from
the batch counts as not correct.
"""

from __future__ import annotations

import numpy as np


def spread(ref: np.ndarray) -> float:
    """The root mean square distance of ref's rows from their mean row
    (float64)."""
    ref = np.asarray(ref, np.float64)
    d = ref - ref.mean(axis=0, keepdims=True)
    return float(np.sqrt((d * d).sum(axis=1).mean()))


def row_err(out: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """err of each row of out against the same row of ref (float64)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    if out.shape != ref.shape:
        return np.full(max(len(out), len(ref), 1), np.inf)
    num = np.linalg.norm(out - ref, axis=1)
    err = num / max(spread(ref), np.finfo(np.float64).tiny)
    return np.where(np.isfinite(err), err, np.inf)


def worst_err(answers: list, refs: dict) -> float:
    """The largest err over [(pool index, logits or None)], each against
    refs[pool index]; inf where an answer is missing."""
    worst = 0.0
    for k, out in answers:
        if out is None:
            return float("inf")
        worst = max(worst, float(row_err(out, refs[k]).max()))
    return worst


def worst_mean_err(answers: list, refs: dict) -> float:
    """The largest gap between the mean rows of an answer and of its
    reference, as a share of the reference's spread, over [(pool index,
    logits or None)]; inf where an answer is missing."""
    worst = 0.0
    for k, out in answers:
        if out is None or np.shape(out) != np.shape(refs[k]):
            return float("inf")
        out = np.asarray(out, np.float64)
        ref = np.asarray(refs[k], np.float64)
        gap = np.linalg.norm(out.mean(axis=0) - ref.mean(axis=0)) \
            / max(spread(ref), np.finfo(np.float64).tiny)
        worst = max(worst, float(gap) if np.isfinite(gap) else np.inf)
    return worst
