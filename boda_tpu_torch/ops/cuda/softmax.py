"""The `softmax` template: over channels, taken in f32 and cast back to the
edge dtype. Port of boda_tpu/ops/pallas/softmax.py (Softmax, :22-42); the
training templates there (sm_grad_and_loss, sum_loss_over_imgs) are not on
the port's paths and are left out."""

from __future__ import annotations

import numpy as np
import torch

from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template


@template
class Softmax(KernelTemplate):
    name = "softmax"
    args = [adecl("in", IN, "img chan y x"), adecl("out", OUT, "img chan y x")]
    nhwc_ok = True

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        x64 = np.asarray(x, np.float64)
        e = np.exp(x64 - x64.max(axis=1, keepdims=True))
        return (e / e.sum(axis=1, keepdims=True)).astype(np.asarray(x).dtype)

    @classmethod
    def build(cls, rfs: OpBase):
        # channels are the last axis of an NHWC storage tensor
        ax = -1 if rfs.str_vals.get("io_layout") == "nhwc" else 1

        def fn(x):
            return torch.softmax(x.float(), dim=ax).to(x.dtype)
        return fn
