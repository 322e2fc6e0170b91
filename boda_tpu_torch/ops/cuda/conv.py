"""Convolution templates on kernel B1: k1conv, conv, ipconv; and the
vendor convs xla_conv and s2d_conv.

Port of boda_tpu/ops/pallas/conv.py (K1Conv, Conv, IpConv, XlaConv,
S2dConv). The three matmul variants reshape or im2col their input with
plain torch ops and run the product, bias and ReLU on `matmul_ext`
(kernel B1), with the bias added in f32 as build_matmul_ext does. Each
template takes and returns NCHW tensors, or NHWC storage tensors in the
edge dtype when the plan's fused-storage pass marked the step
io_layout=nhwc.

XlaConv, XlaConv2 (conv2.py) and S2dConv are vendor roles in the JAX
package (XLA convs, the last over a 2x2 phase-stacked input). Here all
three are F.conv2d on cuDNN in full FP32 on the operands rounded to the
compute dtype (vendor_conv says why not in bf16), channels_last under NHWC
storage; the phase stacking only re-indexes the same arithmetic, so it is
dropped.

The conv family's metadata is the JAX package's (conv.py:35-126):
`conv_params`, the shared `_ConvBase` (declared args, reduced-signature
keys, flops, the float64 reference) and `make_conv_op`. The JAX deconv
template is not on the port's paths and is left out.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.dims import Dims
from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .sgemm import matmul_ext
from .util import compute_dtype, full_fp32, storage_io, store_dtype


# the member tags of a sibling-fused conv (the JAX xla_conv2,
# boda_tpu/ops/pallas/conv2.py:31): up to 4-way fusion; read by the lowering
SIBS = ("a", "b", "c", "d")


def conv_params(rfs: OpBase):
    ind = rfs.get_dims("in")
    outd = rfs.get_dims("out")
    fd = rfs.get_dims("filts")
    st = rfs.get_dims_or_none("stride")
    pad = rfs.get_dims_or_none("in_pad")
    sy, sx = (st["y"], st["x"]) if st else (1, 1)
    py, px = (pad["y"], pad["x"]) if pad else (0, 0)
    relu = rfs.get_u32_or("conv_has_relu", 0) == 1
    return ind, outd, fd, sy, sx, py, px, relu


def conv_flops(rfs: OpBase) -> int:
    _ind, outd, fd, *_ = conv_params(rfs)
    return 2 * outd.sz() * fd["in_chan"] * fd["y"] * fd["x"]


class _ConvBase(KernelTemplate):
    args = [adecl("in", IN, "img chan y x"),
            adecl("filts", IN, "out_chan in_chan y x"),
            # set by the weight-prequantization pass (engine/lower.py):
            # filts arrive int8 with this per-out_chan dequant scale
            adecl("filts_scale", IN, "out_chan", opt=True),
            adecl("biases", IN, "out_chan", opt=True),
            adecl("out", OUT, "img chan y x")]
    sig_nda_keys = ["in_pad", "stride", "kern_sz", "conv_has_relu", "work",
                    "quant8", "act_scale", "prequant_w",
                    "in_q8", "out_q8", "out_scale", "grad_q8"]
    sig_str_keys = ["prec", "layout"]
    nhwc_ok = True

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        return conv_flops(rfs)

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, w, *rest):
        """Direct float64 conv reference (shared by all variants)."""
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        if rfs.get_u32_or("prequant_w", 0):
            # prequantized weights: (x, wq, sws[, b]) — dequantize first
            sws, rest = rest[0], rest[1:]
            w = np.asarray(w, np.float64) \
                * np.asarray(sws, np.float64).reshape(-1, 1, 1, 1)
        b = rest[0] if rest else None
        x = np.asarray(x, np.float64)
        if rfs.get_u32_or("in_q8", 0):
            # int8 storage edge: input arrives quantized at the static
            # act_scale — dequantize
            x = x * (float(rfs.nda_vals["act_scale"].item()) / 127.0)
        w = np.asarray(w, np.float64)
        n, C, H, W = x.shape
        oc, ic, ky, kx = w.shape
        oy, ox = outd["y"], outd["x"]
        xp = np.pad(x, ((0, 0), (0, 0), (py, py), (px, px)))
        out = np.zeros((n, oc, oy, ox))
        for yy in range(ky):
            for xx in range(kx):
                win = xp[:, :, yy:yy + oy * sy:sy, xx:xx + ox * sx:sx]
                win = win[:, :, :oy, :ox]
                out += np.einsum("nchw,oc->nohw", win, w[:, :, yy, xx],
                                 optimize=True)
        if b is not None:
            out += np.asarray(b, np.float64)[None, :, None, None]
        if relu:
            out = np.maximum(out, 0)
        if rfs.get_u32_or("out_q8", 0):
            # int8 storage edge: the epilogue stores the quantized value
            os_ = float(rfs.nda_vals["out_scale"].item())
            out = np.clip(np.round(out * (127.0 / os_)), -127, 127) \
                .astype(np.int8)
        return out


def make_conv_op(n: int, cin: int, h: int, w: int, cout: int, ky: int, kx: int,
                 sy: int = 1, sx: int = 1, py: int = 0, px: int = 0,
                 func_name: str = "xla_conv", relu: bool = False,
                 bias: bool = True) -> OpBase:
    """Helper: construct a Convolution op sig in reference layout."""
    oy = (h + 2 * py - ky) // sy + 1
    ox = (w + 2 * px - kx) // sx + 1
    op = OpBase({"type": "Convolution", "func_name": func_name})
    op.set_dims("in", Dims.make(img=n, chan=cin, y=h, x=w))
    op.set_dims("filts", Dims.make(out_chan=cout, in_chan=cin, y=ky, x=kx))
    if bias:
        op.set_dims("biases", Dims.make(out_chan=cout))
    op.set_dims("out", Dims.make(img=n, chan=cout, y=oy, x=ox))
    op.set_null_dims("in_pad", y=py, x=px)
    op.set_null_dims("stride", y=sy, x=sx)
    op.set_null_dims("kern_sz", y=ky, x=kx)
    if relu:
        op.set_u32("conv_has_relu", 1)
    return op


def _bias_f32(b):
    return None if b is None else b.float().contiguous()


@template
class K1Conv(_ConvBase):
    """1x1 conv (stride 1 or a strided subsample) as one B1 product:
    (img*y*x, in_chan) . (out_chan, in_chan)^T."""

    name = "k1conv"

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
class Conv(_ConvBase):
    """General (strided) conv as an im2col B1 product: the (img*oy*ox,
    ky*kx*C) patch matrix, in tap-major channel-minor order, times the
    filter reordered to (out_chan, ky, kx, C)."""

    name = "conv"

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
class IpConv(_ConvBase):
    """Inner product (fc): the flattened input times the filter, whose
    (chan, y, x) axes are reordered to (y, x, chan) under NHWC storage."""

    name = "ipconv"

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


def vendor_conv(stride, pad, cdt, io_nhwc):
    """The vendor conv of a step (cuDNN's role; XLA's in the JAX package):
    conv(x, w, b) -> the f32 conv of the operands rounded to the compute
    dtype `cdt`, + the f32 bias, as a logical NCHW tensor. It runs F.conv2d
    in full FP32 (never TF32) on the rounded operands, also under prec=bf16:
    FP32 products of bf16 values are exact, so the sum is rounded nowhere
    before the bias, as in the JAX templates (bf16 operands, f32
    accumulation, f32 output: boda_tpu/ops/mxu_grad.py mxu_conv). A bf16
    cuDNN conv would round that sum to bf16 before the bias, since torch's
    conv has no f32 output for bf16 operands: one rounding more, which moves
    14-34% of the stored values by one bf16 step and fails the 5e-3 gate
    against the JAX template (PERF.md section 6), so it is not used.

    Under NHWC storage (io_nhwc) x arrives NHWC and is passed on as the
    channels_last NCHW tensor it already is, with the filter in
    channels_last too, so the result comes back channels_last and its NHWC
    view is contiguous: no permute copy on either side."""
    cl = torch.channels_last

    def conv(x, w, b=None):
        xc, wc = x.to(cdt).float(), w.to(cdt).float()
        if io_nhwc:
            xc, wc = xc.permute(0, 3, 1, 2), wc.contiguous(memory_format=cl)
        with full_fp32():
            y = F.conv2d(xc, wc, stride=stride, padding=pad)
        if b is not None:
            y = y + b.float()[None, :, None, None]
        return y
    return conv


def vendor_store(y, relu: bool, odt, io_nhwc):
    """The epilogue of a vendor conv step: ReLU, one rounding to the stored
    dtype, and the step's storage form (NCHW, or NHWC: a view of a
    channels_last result, copied only where it is not)."""
    if relu:
        y = torch.relu(y)
    y = y.to(odt)
    # a member of a sibling group is a channel slice: the copy splits it off
    return y.permute(0, 2, 3, 1).contiguous() if io_nhwc else y.contiguous()


def _cudnn_conv(rfs: OpBase):
    """A vendor conv step (vendor_conv, vendor_store) of a conv sig: the
    f32-output XLA conv of the JAX package (conv.py:281-296, :334-379).
    Takes and returns NCHW, or NHWC storage tensors when the plan's
    fused-storage pass marked the step."""
    ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
    io_nhwc, _ = storage_io(rfs)
    odt = store_dtype(rfs)
    conv = vendor_conv((sy, sx), (py, px), compute_dtype(rfs), io_nhwc)

    def fn(x, w, b=None):
        return vendor_store(conv(x, w, b), relu, odt, io_nhwc)
    return fn


@template
class XlaConv(_ConvBase):
    """The vendor conv (cuDNN's role; XLA's in the JAX package,
    conv.py:128-296), non-quantised: NCHW or storage NHWC, f32 or bf16
    operands, bias and ReLU. The int8 forms are refused."""

    name = "xla_conv"

    @classmethod
    def build(cls, rfs: OpBase):
        for k in ("quant8", "in_q8", "out_q8", "grad_q8"):
            if rfs.get_u32_or(k, 0):
                raise RtErr(f"xla_conv: the int8 form ({k}=1) is not ported "
                            f"to torch yet (ROADMAP A3)")
        return _cudnn_conv(rfs)


@template
class S2dConv(_ConvBase):
    """The thin-channel stride-2 stem conv (ResNet conv1: 7x7/s2, C=3) on
    cuDNN as a plain stride-2 conv: the JAX package's 2x2 phase stacking
    only re-indexes the same arithmetic, so it is dropped."""

    name = "s2d_conv"

    @classmethod
    def build(cls, rfs: OpBase):
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        if (sy, sx) != (2, 2):
            raise RtErr(f"s2d_conv: needs stride 2, got ({sy}, {sx})")
        return _cudnn_conv(rfs)
