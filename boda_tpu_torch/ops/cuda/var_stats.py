"""The `var_stats` template: [min, max, mean, sum of squares] of a tensor in
f32, the per-node statistics of the engine's enable_stats.

Port of boda_tpu/ops/pallas/var_stats.py (VarStats, :17-58), which the JAX
package computes outside Pallas too. The input is cast to f32 first, from
bf16 storage as well, as the JAX template casts it; torch's f32 sums run in
another order than XLA's, so min and max are exact and the mean and the sum
of squares agree within rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.dims import NDA, Dims
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template

STAT_NAMES = ("min", "max", "avg", "ssqs")


@template
class VarStats(KernelTemplate):
    """stats = [min, max, avg, sum_of_squares] of `in` (4-vector out)."""

    name = "var_stats"
    nhwc_ok = True  # whole-tensor reduction: layout agnostic
    args = [adecl("in", IN, ""), adecl("stats", OUT, "n")]
    sig_nda_keys = ["in"]

    @classmethod
    def check_args(cls, op: OpBase) -> OpBase:
        rfs = OpBase({"func_name": cls.name})
        rfs.nda_vals["in"] = op.nda_vals["in"]
        rfs.nda_vals["stats"] = NDA(Dims.make(n=4))
        return rfs

    @classmethod
    def in_args(cls):
        return ["in"]

    @classmethod
    def out_args(cls):
        return ["stats"]

    @classmethod
    def io_args(cls):
        return []

    @classmethod
    def build(cls, rfs: OpBase):
        def fn(x):
            xf = x.float()
            return torch.stack([xf.min(), xf.max(), xf.mean(),
                                (xf * xf).sum()])
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        xf = np.asarray(x, np.float64)
        return np.array([xf.min(), xf.max(), xf.mean(), (xf * xf).sum()],
                        dtype=np.float32)
