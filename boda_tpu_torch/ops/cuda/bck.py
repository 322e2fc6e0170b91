"""Backward-op templates: BckConv, Spreading and bck_lrn, the steps
graph/pipe.add_bck_ops adds to a training plan (reference: BckConv.cucl,
Spreading.cucl, bck_lrn.cucl; conv_util.cc:732-800).

Port of boda_tpu/ops/pallas/bck.py, which derives each gradient with
jax.vjp over the forward builder; here the same gradients come from torch
(aten.convolution_backward in full FP32 for BckConv, autograd through the
port's own pool and lrn templates for the other two). The declared args,
sig keys, flops and the independent numpy references are the JAX
package's, so the engine=ref plans and the cross-backend digests compare
two independent derivations as there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .util import full_fp32


def _bck_conv_params(rfs: OpBase):
    """BckConv sigs carry out_grad (not out); extract geometry directly."""
    st = rfs.get_dims_or_none("stride")
    pad = rfs.get_dims_or_none("in_pad")
    sy, sx = (st["y"], st["x"]) if st else (1, 1)
    py, px = (pad["y"], pad["x"]) if pad else (0, 0)
    return sy, sx, py, px


def _vjp(fn, x, og):
    """The gradient of fn at x for the cotangent og, through autograd."""
    with torch.enable_grad():
        xv = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(fn(xv), xv, og.to(xv.dtype))
    return dx.to(x.dtype)


@template
class BckConv(KernelTemplate):
    """Conv backward: (in, filts, out_grad) → (in_grad, filts_grad,
    biases_grad). Reference lowers BckConv to 3 calls (rtc_fwd.cc:378-401);
    here one convolution_backward produces all three."""

    name = "BckConv"
    args = [adecl("in", IN, "img chan y x"),
            adecl("filts", IN, "out_chan in_chan y x"),
            adecl("out_grad", IN, "img chan y x"),
            adecl("in_grad", OUT, "img chan y x"),
            adecl("filts_grad", OUT, "out_chan in_chan y x"),
            adecl("biases_grad", OUT, "out_chan")]
    sig_nda_keys = ["in_pad", "stride", "kern_sz"]

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        ogd = rfs.get_dims("out_grad")
        fd = rfs.get_dims("filts")
        return 3 * 2 * ogd.sz() * fd["in_chan"] * fd["y"] * fd["x"]

    @classmethod
    def build(cls, rfs: OpBase):
        sy, sx, py, px = _bck_conv_params(rfs)

        def fn(x, w, og):
            with full_fp32():
                dx, dw, db = torch.ops.aten.convolution_backward(
                    og.float(), x.float(), w.float(), [w.shape[0]], [sy, sx],
                    [py, px], [1, 1], False, [0, 0], 1, [True, True, True])
            return dx.to(x.dtype), dw.to(w.dtype), db.to(w.dtype)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, w, og):
        sy, sx, py, px = _bck_conv_params(rfs)
        x = np.asarray(x, np.float64)
        w = np.asarray(w, np.float64)
        og = np.asarray(og, np.float64)
        n, C, H, W = x.shape
        oc, ic, ky, kx = w.shape
        oy, ox = og.shape[2], og.shape[3]
        xp = np.pad(x, ((0, 0), (0, 0), (py, py), (px, px)))
        dxp = np.zeros_like(xp)
        dw = np.zeros_like(w)
        for yy in range(ky):
            for xx in range(kx):
                win = xp[:, :, yy:yy + oy * sy:sy, xx:xx + ox * sx:sx][:, :, :oy, :ox]
                dw[:, :, yy, xx] = np.einsum("nohw,nchw->oc", og, win, optimize=True)
                dxp[:, :, yy:yy + oy * sy:sy, xx:xx + ox * sx:sx] += np.einsum(
                    "nohw,oc->nchw", og, w[:, :, yy, xx], optimize=True)
        dx = dxp[:, :, py:py + H, px:px + W]
        db = og.sum(axis=(0, 2, 3))
        return (dx.astype(np.float32), dw.astype(np.float32), db.astype(np.float32))


@template
class Spreading(KernelTemplate):
    """Max-pool backward (reference: Spreading.cucl): spread out_grad back
    to the argmax input positions of each pooling window."""

    name = "Spreading"
    args = [adecl("in", IN, "img chan y x"),
            adecl("out", IN, "img chan y x"),
            adecl("out_grad", IN, "img chan y x"),
            adecl("in_grad", OUT, "img chan y x")]
    sig_nda_keys = ["kern_sz", "stride", "in_pad"]
    sig_str_keys = ["avg_pool"]

    @classmethod
    def build(cls, rfs: OpBase):
        from .pool import Pool
        pool_fn = Pool.build(rfs)

        def fn(x, _out, og):
            return _vjp(pool_fn, x, og)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, out, og):
        from .pool import _params
        ind, outd, ky, kx, sy, sx, py, px, avg = _params(rfs)
        x = np.asarray(x, np.float64)
        out = np.asarray(out, np.float64)
        og = np.asarray(og, np.float64)
        n, c, H, W = x.shape
        oy, ox = og.shape[2], og.shape[3]
        dx = np.zeros_like(x)
        for yy in range(oy):
            for xx in range(ox):
                y0, x0 = yy * sy - py, xx * sx - px
                y1, x1 = min(y0 + ky, H), min(x0 + kx, W)
                y0c, x0c = max(y0, 0), max(x0, 0)
                if avg:
                    cnt = (min(y0 + ky, H + py) - y0) * (min(x0 + kx, W + px) - x0)
                    dx[:, :, y0c:y1, x0c:x1] += og[:, :, yy:yy + 1, xx:xx + 1] / cnt
                else:
                    win = x[:, :, y0c:y1, x0c:x1]
                    # caffe-style: gradient goes to positions equal to the max
                    mask = win == out[:, :, yy:yy + 1, xx:xx + 1]
                    dx[:, :, y0c:y1, x0c:x1] += mask * og[:, :, yy:yy + 1, xx:xx + 1]
        return dx.astype(np.float32)


@template
class BckLrn(KernelTemplate):
    name = "bck_lrn"
    args = [adecl("in", IN, "img chan y x"),
            adecl("out_grad", IN, "img chan y x"),
            adecl("in_grad", OUT, "img chan y x")]
    sig_nda_keys = ["local_size", "alpha", "beta", "k"]

    @classmethod
    def build(cls, rfs: OpBase):
        from .lrn import Lrn
        lrn_fn = Lrn.build(rfs)

        def fn(x, og):
            return _vjp(lrn_fn, x, og)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, og):
        # numerical-gradient-free closed form is long; use the same windowed
        # formula caffe uses, derived independently of the autograd path.
        from .lrn import _params
        n_, alpha, beta, k = _params(rfs)
        x = np.asarray(x, np.float64)
        og = np.asarray(og, np.float64)
        C = x.shape[1]
        pre = n_ // 2
        sq = x * x
        scale = np.empty_like(x)
        for c in range(C):
            c0, c1 = max(0, c - pre), min(C, c - pre + n_)
            scale[:, c] = k + (alpha / n_) * sq[:, c0:c1].sum(axis=1)
        # d out_c / d in_c' = δ(c,c') s_c^-β - 2αβ/n · x_c x_c' s_c^(-β-1) [c' in win(c)]
        ratio = og * x * np.power(scale, -beta - 1.0)
        dx = og * np.power(scale, -beta)
        acc = np.zeros_like(x)
        for c in range(C):
            c0, c1 = max(0, c - pre), min(C, c - pre + n_)
            acc[:, c0:c1] += ratio[:, c:c + 1]
        dx -= (2.0 * alpha * beta / n_) * x * acc
        return dx.astype(np.float32)
