"""Convolution templates on kernel B1: k1conv, conv, ipconv; and the
vendor convs xla_conv and s2d_conv.

Port of boda_tpu/ops/pallas/conv.py (K1Conv, Conv, IpConv, XlaConv,
S2dConv). The three matmul variants reshape or im2col their input with
plain torch ops and run the product, bias and ReLU on `matmul_ext`
(kernel B1), with the bias added in f32 as build_matmul_ext does. Each
template takes and returns NCHW tensors, or NHWC storage tensors in the
edge dtype when the plan's fused-storage pass marked the step
io_layout=nhwc.

XlaConv and S2dConv are vendor roles in the JAX package (XLA convs, the
latter over a 2x2 phase-stacked input). Here both are F.conv2d on cuDNN in
full FP32; the phase stacking only re-indexes the same arithmetic, so it
is dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from boda_tpu.core.error import RtErr
from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.pallas import conv as jconv
from boda_tpu.ops.pallas.conv import conv_params

from ..registry import template
from .sgemm import matmul_ext
from .util import compute_dtype, full_fp32, storage_io, store_dtype


def _bias_f32(b):
    return None if b is None else b.float().contiguous()


@template
class K1Conv(jconv.K1Conv):
    """1x1 conv (stride 1 or a strided subsample) as one B1 product:
    (img*y*x, in_chan) . (out_chan, in_chan)^T."""

    @classmethod
    def build(cls, rfs: OpBase):
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        if (fd["y"], fd["x"]) != (1, 1):
            raise RtErr(f"k1conv: needs a 1x1 filter, got {fd}")
        n, C = ind["img"], ind["chan"]
        oc, oy, ox = fd["out_chan"], outd["y"], outd["x"]
        M = n * oy * ox
        io_nhwc, _ = storage_io(rfs)
        cdt, odt = compute_dtype(rfs), store_dtype(rfs)

        def fn(x, filts, b=None):
            if not io_nhwc:
                x = x.permute(0, 2, 3, 1)
            if (sy, sx) != (1, 1):
                x = x[:, ::sy, ::sx, :]
            # the strided subsample and the NCHW permute are views; the
            # kernel takes a contiguous A, so this copies them
            a = x.to(cdt).contiguous().view(M, C)
            c = matmul_ext(a, filts.to(cdt).contiguous().view(oc, C),
                           _bias_f32(b), relu, odt)
            c = c.view(n, oy, ox, oc)
            return c if io_nhwc else c.permute(0, 3, 1, 2).contiguous()
        return fn


@template
class Conv(jconv.Conv):
    """General (strided) conv as an im2col B1 product: the (img*oy*ox,
    ky*kx*C) patch matrix, in tap-major channel-minor order, times the
    filter reordered to (out_chan, ky, kx, C)."""

    @classmethod
    def build(cls, rfs: OpBase):
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        n, C = ind["img"], ind["chan"]
        oc, ky, kx = fd["out_chan"], fd["y"], fd["x"]
        oy, ox = outd["y"], outd["x"]
        M, K = n * oy * ox, C * ky * kx
        io_nhwc, _ = storage_io(rfs)
        cdt, odt = compute_dtype(rfs), store_dtype(rfs)

        def fn(x, filts, b=None):
            xh = x if io_nhwc else x.permute(0, 2, 3, 1)
            xh = F.pad(xh.to(cdt), (0, 0, px, px, py, py))
            cols = [xh[:, yy:yy + (oy - 1) * sy + 1:sy,
                       xx:xx + (ox - 1) * sx + 1:sx, :].reshape(M, C)
                    for yy in range(ky) for xx in range(kx)]
            a = torch.cat(cols, dim=1)
            wmat = filts.to(cdt).permute(0, 2, 3, 1).reshape(oc, K)
            c = matmul_ext(a, wmat.contiguous(), _bias_f32(b), relu, odt)
            c = c.view(n, oy, ox, oc)
            return c if io_nhwc else c.permute(0, 3, 1, 2).contiguous()
        return fn


@template
class IpConv(jconv.IpConv):
    """Inner product (fc): the flattened input times the filter, whose
    (chan, y, x) axes are reordered to (y, x, chan) under NHWC storage."""

    @classmethod
    def build(cls, rfs: OpBase):
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        n, C, H, W = ind.shape
        oc = fd["out_chan"]
        if (outd["y"], outd["x"]) != (1, 1):
            raise RtErr(f"ipconv: needs a 1x1 output, got {outd}")
        K = C * H * W
        io_nhwc, _ = storage_io(rfs)
        cdt, odt = compute_dtype(rfs), store_dtype(rfs)

        def fn(x, filts, b=None):
            a = x.to(cdt).contiguous().view(n, K)
            w = filts.to(cdt)
            if io_nhwc:
                w = w.reshape(oc, C, H, W).permute(0, 2, 3, 1)
            c = matmul_ext(a, w.contiguous().view(oc, K), _bias_f32(b), relu,
                           odt)
            return c.view(n, 1, 1, oc) if io_nhwc else c.view(n, oc, 1, 1)
        return fn


def _cudnn_conv(rfs: OpBase):
    """A vendor conv step as F.conv2d (cuDNN) in full FP32 on the
    compute-dtype-rounded operands, + f32 bias, ReLU and one rounding to
    the stored dtype: the f32-output XLA conv of the JAX package
    (conv.py:281-296, :334-379). Takes and returns NCHW, or NHWC storage
    tensors when the plan's fused-storage pass marked the step."""
    ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
    io_nhwc, _ = storage_io(rfs)
    cdt, odt = compute_dtype(rfs), store_dtype(rfs)

    def fn(x, w, b=None):
        xc = x.to(cdt).float()
        if io_nhwc:
            xc = xc.permute(0, 3, 1, 2)
        with full_fp32():
            y = F.conv2d(xc, w.to(cdt).float(), stride=(sy, sx),
                         padding=(py, px))
        if b is not None:
            y = y + b.float()[None, :, None, None]
        if relu:
            y = torch.relu(y)
        y = y.to(odt)
        return y.permute(0, 2, 3, 1).contiguous() if io_nhwc else y
    return fn


@template
class XlaConv(jconv.XlaConv):
    """The vendor conv (cuDNN's role; XLA's in the JAX package,
    conv.py:128-296), non-quantised: NCHW or storage NHWC, f32 or bf16
    operands, bias and ReLU. The int8 forms are refused."""

    @classmethod
    def build(cls, rfs: OpBase):
        for k in ("quant8", "in_q8", "out_q8", "grad_q8"):
            if rfs.get_u32_or(k, 0):
                raise RtErr(f"xla_conv: the int8 form ({k}=1) is not ported "
                            f"to torch yet (ROADMAP A6)")
        return _cudnn_conv(rfs)


@template
class S2dConv(jconv.S2dConv):
    """The thin-channel stride-2 stem conv (ResNet conv1: 7x7/s2, C=3) on
    cuDNN as a plain stride-2 conv: the JAX package's 2x2 phase stacking
    only re-indexes the same arithmetic, so it is dropped."""

    @classmethod
    def build(cls, rfs: OpBase):
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        if (sy, sx) != (2, 2):
            raise RtErr(f"s2d_conv: needs stride 2, got ({sy}, {sx})")
        return _cudnn_conv(rfs)
