"""Fuzzy tensor digests for golden-output regression testing.

Capability parity with the reference's nda_digest_t (boda_base.H:1051-1073):
a compact, magnitude-aware summary of a tensor that (a) serializes to a
stable one-line text form archived in golden test dirs, and (b) compares
against another digest with a max-relative-difference tolerance
(`self_cmp_mrd`), so GPU/TPU-vs-reference correctness is testable without
shipping full tensors.

The port's copy of boda_tpu/core/digest.py, without impl='cpp': the
Python digest is the one the golden files were written with.
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional, Union

import numpy as np

from .dims import NDA, Dims
from .error import RtErr
from .lexp import Lexp, parse_lexp


class Digest:
    __slots__ = ("dims", "cnt", "vmin", "vmax", "avg", "rms", "qhash", "self_cmp_mrd")

    def __init__(self, dims: Dims, cnt: int, vmin: float, vmax: float, avg: float,
                 rms: float, qhash: str, self_cmp_mrd: float = 0.0):
        self.dims = dims
        self.cnt = cnt
        self.vmin = vmin
        self.vmax = vmax
        self.avg = avg
        self.rms = rms
        self.qhash = qhash
        self.self_cmp_mrd = self_cmp_mrd

    def to_lexp(self) -> Lexp:
        l = Lexp.empty_list()
        l.add_key_lexp("dims", self.dims.to_lexp())
        l.add_key_val("cnt", str(self.cnt))
        for k in ("vmin", "vmax", "avg", "rms"):
            l.add_key_val(k, f"{getattr(self, k):.17g}")
        l.add_key_val("qhash", self.qhash)
        if self.self_cmp_mrd:
            l.add_key_val("self_cmp_mrd", f"{self.self_cmp_mrd:.9g}")
        return l

    def __str__(self):
        return str(self.to_lexp())

    @staticmethod
    def from_lexp(l: Union[Lexp, str]) -> "Digest":
        if isinstance(l, str):
            l = parse_lexp(l)
        l.deep_inc_use_cnt()
        dk = l.get_kid("dims")
        if dk is None:
            raise RtErr("digest lexp missing 'dims'")
        dims = Dims.from_lexp(dk)

        def f(k, default=None):
            v = l.get_kid(k)
            if v is None:
                if default is not None:
                    return default
                raise RtErr(f"digest lexp missing '{k}'")
            return v.leaf_val

        return Digest(dims, int(f("cnt")), float(f("vmin")), float(f("vmax")),
                      float(f("avg")), float(f("rms")), f("qhash"),
                      float(f("self_cmp_mrd", "0")))

    def comp(self, o: "Digest", mrd_toler: float) -> Optional[str]:
        """Compare to another digest; return None if equal-within-tolerance,
        else a human-readable mismatch description (stable for err-tests)."""
        if self.dims.shape != o.dims.shape:
            return f"digest dims mismatch: {self.dims.pretty()} != {o.dims.pretty()}"
        if self.cnt != o.cnt:
            return f"digest cnt mismatch: {self.cnt} != {o.cnt}"
        tol = max(mrd_toler, self.self_cmp_mrd, o.self_cmp_mrd)
        scale = max(abs(self.vmin), abs(self.vmax), abs(o.vmin), abs(o.vmax), 1e-30)
        for k in ("vmin", "vmax", "avg", "rms"):
            a, b = getattr(self, k), getattr(o, k)
            rd = abs(a - b) / scale
            if rd > tol:
                return f"digest {k} mismatch: {a:.9g} != {b:.9g} (rel diff {rd:.3g} > toler {tol:.3g})"
        if tol == 0.0 and self.qhash != o.qhash:
            return f"digest qhash mismatch: {self.qhash} != {o.qhash}"
        return None


def nda_digest(x, dims: Optional[Dims] = None,
               self_cmp_mrd: float = 0.0) -> Digest:
    """Digest a tensor (NDA or numpy array)."""
    if isinstance(x, NDA):
        dims = dims or x.dims
        v = x.v
    else:
        v = np.asarray(x)
        if dims is None:
            dims = Dims([(f"d{i}", s) for i, s in enumerate(v.shape)])
    fv = np.asarray(v, dtype=np.float64).reshape(-1)
    cnt = fv.size
    if cnt == 0:
        return Digest(dims, 0, 0.0, 0.0, 0.0, 0.0, "empty", self_cmp_mrd)
    vmin = float(fv.min())
    vmax = float(fv.max())
    avg = float(fv.mean())
    rms = float(math.sqrt(np.mean(fv * fv)))
    # quantized hash: values rounded to ~2^-20 of max magnitude → exact-match hash
    mag = max(abs(vmin), abs(vmax), 1e-30)
    q = np.round(fv / mag * (1 << 20)).astype(np.int64)
    qhash = hashlib.sha256(q.tobytes()).hexdigest()[:16]
    return Digest(dims, cnt, vmin, vmax, avg, rms, qhash, self_cmp_mrd)
