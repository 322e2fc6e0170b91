"""Elementwise templates: relu, eltwise (SUM, MAX, PROD), inference
dropout, and dot (c = a * b, the kernel of the torch_rtc_test smoke mode).

Port of boda_tpu/ops/pallas/elementwise.py (Dot, Relu, Eltwise,
Dropout), which computes these outside Pallas too. Each works on NCHW or
NHWC storage alike, in the tensors' own dtype (bf16 edges add in bf16 in
both packages). The JAX package's copy, split_copy, zero_if_nonpos and
scale templates are not on the port's paths and are left out.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import IN, INOUT, OUT, KernelTemplate, adecl, template


@template
class Dot(KernelTemplate):
    """Backend smoke-test kernel (reference: rtc_test's dot.cucl,
    rtc_compute.cc:135): c = a * b elementwise over a 1-D index space."""

    name = "dot"
    args = [adecl("a", IN, "n"), adecl("b", IN, "n"), adecl("c", OUT, "n")]

    @classmethod
    def build(cls, rfs: OpBase):
        return torch.mul

    @classmethod
    def ref_impl(cls, rfs: OpBase, a, b):
        return np.asarray(a) * np.asarray(b)


@template
class Relu(KernelTemplate):
    """In-place ReLU at an unfused graph position."""

    name = "relu"
    args = [adecl("inout", INOUT, "img chan y x")]
    nhwc_ok = True  # elementwise: storage-layout agnostic

    @classmethod
    def build(cls, rfs: OpBase):
        return torch.relu

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        return np.maximum(np.asarray(x), 0)


_EW_NP = {"SUM": np.add, "MAX": np.maximum, "PROD": np.multiply}


@template
class Eltwise(KernelTemplate):
    """Binary eltwise (SUM/MAX/PROD over two inputs): caffe's Eltwise
    layer, the residual adds of a ResNet."""

    name = "eltwise"
    args = [adecl("a", IN, "img chan y x"), adecl("b", IN, "img chan y x"),
            adecl("out", OUT, "img chan y x")]
    sig_str_keys = ["ew_op"]
    nhwc_ok = True  # elementwise: storage-layout agnostic

    @classmethod
    def build(cls, rfs: OpBase):
        op = rfs.str_vals.get("ew_op", "SUM")
        fns = {"SUM": torch.add, "MAX": torch.maximum, "PROD": torch.mul}
        if op not in fns:
            raise RtErr(f"eltwise: unknown ew_op '{op}' "
                        f"(have: {','.join(fns)})")
        return fns[op]

    @classmethod
    def ref_impl(cls, rfs: OpBase, a, b):
        return _EW_NP[rfs.str_vals.get("ew_op", "SUM")](np.asarray(a),
                                                        np.asarray(b))


def _infer_only(rfs: OpBase) -> None:
    if rfs.str_vals.get("drop_mode", "infer") != "infer" \
            or "seed" in rfs.nda_vals:
        raise RtErr("dropout: only inference mode is ported to torch "
                    "(train-mode masks are not)")


@template
class Dropout(KernelTemplate):
    """Inference dropout is the identity. Train-mode masks are not ported
    yet: such a step raises when built."""

    name = "dropout"
    args = [adecl("seed", IN, "v", opt=True),
            adecl("inout", INOUT, "img chan y x")]
    nhwc_ok = True
    sig_nda_keys = ["dropout_ratio", "det_drop_seed"]
    sig_str_keys = ["drop_mode"]

    @classmethod
    def build(cls, rfs: OpBase):
        _infer_only(rfs)
        return lambda x: x

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        _infer_only(rfs)
        return np.asarray(x)
