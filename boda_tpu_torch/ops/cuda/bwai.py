"""bwai: the bandwidth probe template (the reference's test/rtc/bwai.cucl),
profiled by ops_prof like any op, which gives the card's achievable
memory rates:

  bw_op=copy   out[i] = in[i]: read and write streaming rate
  bw_op=scale  out[i] = in[i]*a + b: a little arithmetic on the stream
  bw_op=read   out[0] = sum(in): the read-only rate (`out` is tiny, n=8 in
               the op files, so the probe writes almost nothing; the sum
               consumes every element)

Port of boda_tpu/ops/pallas/bwai.py, in torch ops on the tensor's device:
copy a fresh tensor, scale with the constants in x's dtype, read an f32
sum cast to x's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template


@template
class Bwai(KernelTemplate):
    name = "bwai"
    args = [adecl("in", IN, "n"), adecl("out", OUT, "n")]
    sig_str_keys = ["bw_op"]
    sig_nda_keys = ["a", "b"]

    @classmethod
    def _params(cls, rfs: OpBase):
        op = rfs.str_vals.get("bw_op", "copy")
        a = float(rfs.nda_vals["a"].item()) if "a" in rfs.nda_vals else 2.0
        b = float(rfs.nda_vals["b"].item()) if "b" in rfs.nda_vals else 1.0
        return op, a, b

    @classmethod
    def build(cls, rfs: OpBase):
        op, a, b = cls._params(rfs)
        n_out = rfs.get_dims("out")["n"]
        if op == "copy":
            return torch.clone
        if op == "scale":
            # the constants in x's dtype, as the JAX body has them, made
            # once per dtype and device
            consts: dict = {}

            def fn_scale(x):
                key = (x.dtype, x.device)
                if key not in consts:
                    consts[key] = tuple(torch.tensor(v, dtype=x.dtype,
                                                     device=x.device)
                                        for v in (a, b))
                ca, cb = consts[key]
                return x * ca + cb
            return fn_scale
        if op == "read":
            def fn_read(x):
                out = torch.zeros(n_out, dtype=x.dtype, device=x.device)
                out[0] = x.float().sum().to(x.dtype)
                return out
            return fn_read
        raise RtErr(f"bwai: unknown bw_op '{op}'")

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        op, a, b = cls._params(rfs)
        x = np.asarray(x)
        if op == "copy":
            return x.copy()
        if op == "scale":
            return (x * x.dtype.type(a) + x.dtype.type(b)).astype(x.dtype)
        out = np.zeros(rfs.get_dims("out")["n"], x.dtype)
        out[0] = x.astype(np.float64).sum().astype(x.dtype)
        return out

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        op, _a, _b = cls._params(rfs)
        n = rfs.get_dims("in")["n"]
        return {"copy": 0, "scale": 2 * n, "read": n}[op]

    @classmethod
    def bytes_accessed(cls, rfs: OpBase) -> int:
        op, _a, _b = cls._params(rfs)
        d = rfs.get_dims("in")
        isz = np.dtype(d.dtype).itemsize
        n = d["n"]
        if op == "read":
            od = rfs.get_dims("out")
            return n * isz + od["n"] * np.dtype(od.dtype).itemsize
        return 2 * n * isz
