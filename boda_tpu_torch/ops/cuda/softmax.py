"""The `softmax` template: over channels, taken in f32 and cast back to the
edge dtype. Port of boda_tpu/ops/pallas/softmax.py (Softmax, :29-38)."""

from __future__ import annotations

import torch

from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.pallas import softmax as jsoftmax

from ..registry import template


@template
class Softmax(jsoftmax.Softmax):
    @classmethod
    def build(cls, rfs: OpBase):
        # channels are the last axis of an NHWC storage tensor
        ax = -1 if rfs.str_vals.get("io_layout") == "nhwc" else 1

        def fn(x):
            return torch.softmax(x.float(), dim=ax).to(x.dtype)
        return fn
