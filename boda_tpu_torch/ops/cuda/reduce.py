"""Reduction template: sum N same-shaped inputs, stacked on a leading
dim, into one output (the reference's reduce.cucl; BckConv's filter
gradient sums across image blocks with it).

Port of boda_tpu/ops/pallas/reduce.py (jnp.sum over axis 0). Here the
inputs are added one after another into an f32 sum, in the order XLA's
reduce over the leading axis adds them, and the sum is rounded once to
the inputs' dtype, as XLA sums a bf16 jnp.sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template


@template
class Reduce(KernelTemplate):
    """out = sum over leading 'ins' dim of stacked inputs."""

    name = "reduce"
    args = [adecl("ins", IN, ""), adecl("out", OUT, "")]
    sig_nda_keys = ["ins", "out"]

    @classmethod
    def check_args(cls, op: OpBase) -> OpBase:
        rfs = OpBase({"func_name": cls.name})
        rfs.nda_vals["ins"] = op.nda_vals["ins"]
        rfs.nda_vals["out"] = op.nda_vals["out"]
        return rfs

    @classmethod
    def in_args(cls):
        return ["ins"]

    @classmethod
    def out_args(cls):
        return ["out"]

    @classmethod
    def io_args(cls):
        return []

    @classmethod
    def build(cls, rfs: OpBase):
        def fn(ins):
            acc = ins[0].to(torch.float32, copy=True)
            for t in ins[1:]:
                acc += t
            return acc.to(ins.dtype)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, ins):
        return np.asarray(ins).sum(axis=0)
