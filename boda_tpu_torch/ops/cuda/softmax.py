"""Softmax and the training loss templates: softmax (over channels, taken
in f32 and cast back to the edge dtype), sm_grad_and_loss (the softmax
gradient and per-pixel cross-entropy given labels) and sum_loss_over_imgs
(the reference's SoftmaxWithLoss lowering, rtc_fwd.cc:365-374).

Port of boda_tpu/ops/pallas/softmax.py (:22-96), in torch ops: the
max-subtracted softmax the reference uses, a one-hot of the labels, and
-log(max(p, 1e-30)).
"""

from __future__ import annotations

import numpy as np
import torch

from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template


def _np_softmax(x):
    x = np.asarray(x, np.float64)
    m = x.max(axis=1, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=1, keepdims=True)


@template
class Softmax(KernelTemplate):
    name = "softmax"
    args = [adecl("in", IN, "img chan y x"), adecl("out", OUT, "img chan y x")]
    nhwc_ok = True

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        return _np_softmax(x).astype(np.asarray(x).dtype)

    @classmethod
    def build(cls, rfs: OpBase):
        # channels are the last axis of an NHWC storage tensor
        ax = -1 if rfs.str_vals.get("io_layout") == "nhwc" else 1

        def fn(x):
            return torch.softmax(x.float(), dim=ax).to(x.dtype)
        return fn


@template
class SmGradAndLoss(KernelTemplate):
    """Softmax gradient + per-pixel cross-entropy loss given labels."""

    name = "sm_grad_and_loss"
    args = [adecl("in", IN, "img chan y x"), adecl("label", IN, "img y x"),
            adecl("in_grad", OUT, "img chan y x"), adecl("loss", OUT, "img y x")]

    @classmethod
    def build(cls, rfs: OpBase):
        C = rfs.get_dims("in")["chan"]

        def fn(x, label):
            sm = torch.softmax(x, dim=1)
            li = label.long()
            onehot = torch.nn.functional.one_hot(li, C).movedim(-1, 1) \
                .to(x.dtype)
            p = torch.take_along_dim(sm, li[:, None], dim=1)[:, 0]
            loss = -torch.log(p.clamp_min(1e-30))
            return sm - onehot, loss.to(x.dtype)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, label):
        x = np.asarray(x)
        C = x.shape[1]
        sm = _np_softmax(x)
        li = np.asarray(label).astype(np.int64)
        onehot = np.moveaxis(np.eye(C)[li], -1, 1)
        grad = (sm - onehot).astype(x.dtype)
        p = np.take_along_axis(sm, li[:, None], axis=1)[:, 0]
        loss = (-np.log(np.maximum(p, 1e-30))).astype(x.dtype)
        return grad, loss


@template
class SumLossOverImgs(KernelTemplate):
    name = "sum_loss_over_imgs"
    args = [adecl("loss", IN, "img y x"), adecl("loss_sum", OUT, "n")]

    @classmethod
    def build(cls, rfs: OpBase):
        def fn(loss):
            return loss.sum().reshape(1)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, loss):
        return np.asarray(np.sum(loss)).reshape(1)
