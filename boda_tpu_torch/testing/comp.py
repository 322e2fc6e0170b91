"""Numerical comparison machinery: the comp_util equivalent.

Capability parity with comp_util.{H,cc}: compare named tensor maps between
engines with max-relative-difference tolerances (mrd_toler default 5e-4,
per-var overrides, test_compute.cc:44-46), produce stable human-readable
mismatch reports (pinned by expected-error tests), and digest streams
(write/compare vs known-good digest files — the mechanism that makes
device-vs-reference correctness testable without shipping tensors).

The port's copy of boda_tpu/testing/comp.py.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from ..core.digest import Digest, nda_digest
from ..core.dims import NDA

DEFAULT_MRD_TOLER = 5e-4


def mrd(a: np.ndarray, b: np.ndarray) -> float:
    """Max relative difference, scaled by the max magnitude over both."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(np.abs(a).max(initial=0.0), np.abs(b).max(initial=0.0), 1e-30)
    return float(np.abs(a - b).max(initial=0.0) / scale)


def comp_vars(a: dict[str, NDA], b: dict[str, NDA],
              mrd_toler: float = DEFAULT_MRD_TOLER,
              var_mrd_toler: Optional[dict[str, float]] = None,
              tag_a: str = "a", tag_b: str = "b") -> list[str]:
    """Compare all vars present in both maps; return mismatch descriptions
    (empty = pass). Missing-from-one vars are reported."""
    errs = []
    var_mrd_toler = var_mrd_toler or {}
    for name in sorted(set(a) | set(b)):
        if name not in a:
            errs.append(f"var '{name}' missing from {tag_a}")
            continue
        if name not in b:
            errs.append(f"var '{name}' missing from {tag_b}")
            continue
        va, vb = a[name], b[name]
        if va.dims.shape != vb.dims.shape:
            errs.append(f"var '{name}' shape mismatch: {va.dims.shape} vs {vb.dims.shape}")
            continue
        tol = var_mrd_toler.get(name, mrd_toler)
        d = mrd(va.v, vb.v)
        if d > tol:
            errs.append(f"var '{name}' mrd {d:.3g} > toler {tol:.3g} "
                        f"({tag_a} vs {tag_b})")
    return errs


# ---- digest streams (files of 'name digest-lexp' lines) ----

def write_digest_stream(path: Union[str, Path], vars: dict[str, NDA],
                        self_cmp_mrd: float = 0.0) -> None:
    with open(path, "w") as f:
        for name in sorted(vars):
            d = nda_digest(vars[name], self_cmp_mrd=self_cmp_mrd)
            f.write(f"{name} {d}\n")


def read_digest_stream(path: Union[str, Path]) -> dict[str, Digest]:
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        name, _, rest = line.partition(" ")
        out[name] = Digest.from_lexp(rest)
    return out


def comp_digests(vars: dict[str, NDA], kg: dict[str, Digest],
                 mrd_toler: float = DEFAULT_MRD_TOLER,
                 ignore_missing: bool = False) -> list[str]:
    """Compare live tensors against known-good digests (reference:
    --kg-digests-fn, test_compute.cc:267-269)."""
    errs = []
    for name, d in sorted(kg.items()):
        if name not in vars:
            if not ignore_missing:
                errs.append(f"var '{name}' in known-good digests but not produced")
            continue
        live = nda_digest(vars[name])
        msg = live.comp(d, mrd_toler)
        if msg:
            errs.append(f"var '{name}': {msg}")
    return errs
