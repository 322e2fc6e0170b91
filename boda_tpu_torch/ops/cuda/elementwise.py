"""Elementwise templates: relu, eltwise (SUM, MAX, PROD), inference
dropout, and dot (c = a * b, the kernel of the torch_rtc_test smoke mode).

Port of boda_tpu/ops/pallas/elementwise.py, which computes these outside
Pallas too. Each works on NCHW or NHWC storage alike, in the tensors'
own dtype (bf16 edges add in bf16 in both packages).
"""

from __future__ import annotations

import torch

from boda_tpu.core.error import RtErr
from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.pallas import elementwise as jew

from ..registry import template


@template
class Dot(jew.Dot):
    @classmethod
    def build(cls, rfs: OpBase):
        return torch.mul


@template
class Relu(jew.Relu):
    @classmethod
    def build(cls, rfs: OpBase):
        return torch.relu


@template
class Eltwise(jew.Eltwise):
    @classmethod
    def build(cls, rfs: OpBase):
        op = rfs.str_vals.get("ew_op", "SUM")
        fns = {"SUM": torch.add, "MAX": torch.maximum, "PROD": torch.mul}
        if op not in fns:
            raise RtErr(f"eltwise: unknown ew_op '{op}' "
                        f"(have: {','.join(fns)})")
        return fns[op]


@template
class Dropout(jew.Dropout):
    """Inference dropout is the identity. Train-mode masks are not ported
    yet: such a step raises when built."""

    @classmethod
    def build(cls, rfs: OpBase):
        if rfs.str_vals.get("drop_mode", "infer") != "infer" \
                or "seed" in rfs.nda_vals:
            raise RtErr("dropout: only inference mode is ported to torch "
                        "(train-mode masks are not)")
        return lambda x: x
