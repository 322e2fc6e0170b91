"""Convolution templates on kernel B1: k1conv, conv, ipconv; and the
vendor convs xla_conv and s2d_conv.

Port of boda_tpu/ops/pallas/conv.py (K1Conv, Conv, IpConv, XlaConv,
S2dConv). The three matmul variants reshape or im2col their input with
plain torch ops and run the product, bias and ReLU on `matmul_ext`
(kernel B1), with the bias added in f32 as build_matmul_ext does. Each
template takes and returns NCHW tensors, or NHWC storage tensors in the
edge dtype when the plan's fused-storage pass marked the step
io_layout=nhwc.

Deconv (the transposed conv) is an XLA conv over the lhs-dilated input in
the JAX package; here it is F.conv_transpose2d on cuDNN, under the same
rule as the vendor convs below.

XlaConv, XlaConv2 (conv2.py) and S2dConv are vendor roles in the JAX
package (XLA convs, the last over a 2x2 phase-stacked input). Under
prec=bf16 with NHWC storage, on inference, all three run on kernel B7
(bconv.py: bf16 operands, f32 sums, the bias, ReLU and store in its
epilogue; takes_b7 gives the rule). Else they are F.conv2d on cuDNN in
full FP32 on the operands rounded to the compute dtype (vendor_conv says
why not in bf16), channels_last under NHWC storage; the phase stacking
only re-indexes the same arithmetic, so it is dropped. The int8 forms of XlaConv and XlaConv2 (quant8, in_q8) run on
kernel B6 (qconv.py), an int8 edge's store (out_q8) also after a float
vendor conv. Under autograd the vendor convs carry the mixed-precision VJP
of ops/mxu_grad.py, with the int8 weight gradient of grad_q8 on B6. The
matmul variants k1conv, conv and ipconv have no backward, in the JAX
package as here: their kernel's wrapper refuses autograd.

The conv family's metadata is the JAX package's (conv.py:35-126):
`conv_params`, the shared `_ConvBase` (declared args, reduced-signature
keys, flops, the float64 reference), `make_conv_op` and `make_deconv_op`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.dims import Dims
from ...core.error import RtErr
from ..mxu_grad import grad_q8_site, mxu_conv, relu_store
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .bconv import FilterCache, Member, bconv, ohwi_bf16, records_grad
from .qconv import absmax, act_quantize, qconv, quantize_filter, \
    static_act_scale, store_int8
from .sgemm import matmul_ext
from .util import compute_dtype, storage_io, store_dtype


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


def vendor_conv(stride, pad, cdt, io_nhwc, transposed: bool = False,
                q8: bool = False):
    """The vendor conv of a step (cuDNN's role; XLA's in the JAX package):
    conv(x, w, b) -> the f32 conv of the operands rounded to the compute
    dtype `cdt`, + the f32 bias, as a logical NCHW tensor. It runs in full
    FP32 (never TF32) on the rounded operands, also under prec=bf16: FP32
    products of bf16 values are exact, so the sum is rounded nowhere before
    the bias, as in the JAX templates (bf16 operands, f32 accumulation, f32
    output: boda_tpu/ops/mxu_grad.py mxu_conv). A bf16 cuDNN conv would
    round that sum to bf16 before the bias, since torch's conv has no f32
    output for bf16 operands: one rounding more, which moves 14-34% of the
    stored values by one bf16 step and fails the 5e-3 gate against the JAX
    template (PERF.md section 6), so it is not used.

    Under autograd the conv carries the mixed-precision VJP of
    ops/mxu_grad.mxu_conv (bf16 grad convs, the cd operands as residuals;
    q8: the int8 weight gradient of grad_q8 on kernel B6).

    Under NHWC storage (io_nhwc) x arrives NHWC and is passed on as the
    channels_last NCHW tensor it already is, with the filter in
    channels_last too, so the result comes back channels_last and its NHWC
    view is contiguous: no permute copy on either side.

    transposed: a deconv step's F.conv_transpose2d (its filter given
    (in_chan, out_chan, ky, kx))."""

    def conv(x, w, b=None):
        if io_nhwc:
            x = x.permute(0, 3, 1, 2)
        y = mxu_conv(x, w, stride, pad, cdt, transposed, io_nhwc, q8)
        if b is not None:
            y = y + b.float()[None, :, None, None]
        return y
    return conv


def vendor_store(y, relu: bool, odt, io_nhwc, out_absmax: float = 0.0):
    """The epilogue of a vendor conv step: ReLU, one rounding to the stored
    dtype (int8: an int8 edge's store at out_absmax, conv.py:173-179), and
    the step's storage form (NCHW, or NHWC: a view of a channels_last
    result, copied only where it is not). A ReLU before a float store is
    ops/mxu_grad.relu_store, whose backward keeps the stored output."""
    if odt == torch.int8:
        y = store_int8(torch.relu(y) if relu else y, out_absmax)
    else:
        y = relu_store(y, odt) if relu else y.to(odt)
    # a member of a sibling group is a channel slice: the copy splits it off
    return y.permute(0, 2, 3, 1).contiguous() if io_nhwc else y.contiguous()


def _scale_of(rfs: OpBase, key: str) -> float:
    """A sig's calibrated absmax (act_scale, out_scale) as the f32 value it
    holds, or 0.0 where it has none."""
    return float(rfs.nda_vals[key].item()) if key in rfs.nda_vals else 0.0


def takes_b7(cdt, io_nhwc: bool, transposed: bool = False) -> bool:
    """The route of a float vendor conv step, from what its sig says: kernel
    B7 (ops/cuda/bconv.py) where its operands are bf16 under NHWC storage
    and it is not a transposed conv; else the vendor conv. The built step
    takes B7 on every call that records no autograd graph (a CPU tensor
    takes B7's plain version, the vendor arithmetic); under autograd it runs
    the vendor conv, whose VJP (ops/mxu_grad) saves the rounded operands.
    prec=f32, NCHW storage and deconv keep the vendor conv: they need FP32
    operands or an NCHW result."""
    return cdt == torch.bfloat16 and io_nhwc and not transposed


def _bias_b7(b):
    return None if b is None else b.float().contiguous()


def _cudnn_conv(rfs: OpBase, q8: bool = False):
    """A float vendor conv step of a conv sig: the f32-output XLA conv of
    the JAX package (conv.py:281-296, :334-379), stored int8 where it
    produces an int8 edge (out_q8); on kernel B7 where takes_b7 says so,
    else vendor_conv and vendor_store. Takes and returns NCHW, or NHWC
    storage tensors when the plan's fused-storage pass marked the step. q8:
    the int8 weight gradient under autograd (grad_q8). The fn's `route` is
    "b7" or "vendor"."""
    ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
    io_nhwc, _ = storage_io(rfs)
    out_absmax = _scale_of(rfs, "out_scale") \
        if rfs.get_u32_or("out_q8", 0) else 0.0
    odt = torch.int8 if out_absmax else store_dtype(rfs)
    cdt = compute_dtype(rfs)
    conv = vendor_conv((sy, sx), (py, px), cdt, io_nhwc, q8=q8)

    def vendor_fn(x, w, b=None):
        return vendor_store(conv(x, w, b), relu, odt, io_nhwc, out_absmax)
    if not takes_b7(cdt, io_nhwc):
        vendor_fn.route = "vendor"
        return vendor_fn
    member = (Member(fd["out_chan"], relu, odt, out_absmax),)
    filt = FilterCache(ohwi_bf16)

    def fn(x, w, b=None):
        if records_grad(x, w, b):
            return vendor_fn(x, w, b)
        return bconv(x.to(torch.bfloat16).contiguous(), filt(w),
                     (_bias_b7(b),), member, (sy, sx), (py, px))[0]
    fn.route = "b7"
    return fn


def int8_conv(stride, pad, relu: bool, odt, io_nhwc: bool, prequant: bool,
              act_absmax: float, in_q8: bool, out_absmax: float = 0.0):
    """The int8 conv of a step on kernel B6 (the JAX template's quant8
    forms, conv.py:187-266): conv(x, w, *rest) with rest = (sws, b) where
    the weights arrive prequantized (int8 OIHW and their per-out_chan
    scales), else (b,) and the per-channel weight quantize runs here in
    torch ops; b may be absent. x arrives in the storage form (int8 NHWC
    under in_q8, at the static act_absmax); the activation quantize runs
    on the layout it arrives in, and an NCHW int8 copy is permuted to NHWC
    for the kernel (a quarter of the f32 bytes). Returns the step's output
    in the storage form, of odt (int8: stored at out_absmax).

    Where the scale is dynamic, conv.slot_absmax(x, ...) is x's max|x| on
    the device, and conv(x, ..., amax=m) quantizes at the scale of the max m
    (an f32 [1] tensor on x's device) in place of x's own: under a dp split
    (engine/mesh_fwd.py) m is the dp group's, so each slot's scale is the
    whole batch's, as GSPMD reduces the JAX template's max (conv.py:58)."""
    s_in = {}  # in_q8: the static s_act, one f32 [1] tensor per device

    def conv(x, w, *rest, amax=None):
        sws, rest = (rest[0], rest[1:]) if prequant else (None, rest)
        b = rest[0] if rest else None
        wq, sws = (w, sws) if prequant else quantize_filter(w)
        if in_q8:
            xq, s_act = x, s_in.get(x.device)
            if s_act is None:
                s_act = s_in[x.device] = torch.full(
                    (1,), static_act_scale(act_absmax), device=x.device)
        else:
            xq, s_act = act_quantize(x.contiguous(), act_absmax, amax=amax)
        if not io_nhwc:
            xq = xq.permute(0, 2, 3, 1)
        y = qconv(xq.contiguous(), wq.permute(0, 2, 3, 1).contiguous(), s_act,
                  sws.float().contiguous(),
                  None if b is None else b.float().contiguous(), stride, pad,
                  relu, odt, out_absmax)
        return y if io_nhwc else y.permute(0, 3, 1, 2).contiguous()
    if not in_q8 and not act_absmax:
        conv.slot_absmax = lambda x, *_: absmax(x.contiguous())
    conv.route = "b6"
    return conv


@template
class XlaConv(_ConvBase):
    """The vendor conv (cuDNN's role; XLA's in the JAX package,
    conv.py:128-296): NCHW or storage NHWC, f32 or bf16 operands, bias and
    ReLU; its int8 forms on kernel B6: quant8 with prequantized weights
    (prequant_w) or the weight quantize in the step, a static (act_scale) or
    dynamic activation scale, an input that arrives int8 (in_q8), and an
    int8 output edge (out_q8), also after a float conv. grad_q8 (training:
    the int8 weight gradient on B6) leaves the forward as it is; the JAX
    template takes it only in its NHWC form (storage NHWC or layout=nhwc,
    conv.py:219-223, :274-278), and so does this one."""

    name = "xla_conv"

    @classmethod
    def build(cls, rfs: OpBase):
        quant8 = rfs.get_u32_or("quant8", 0) == 1
        in_q8 = rfs.get_u32_or("in_q8", 0) == 1
        out_q8 = rfs.get_u32_or("out_q8", 0) == 1
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        io_nhwc, _ = storage_io(rfs)
        prequant = rfs.get_u32_or("prequant_w", 0) == 1
        act_absmax = _scale_of(rfs, "act_scale")
        out_absmax = _scale_of(rfs, "out_scale") if out_q8 else 0.0
        # the lowering (engine/lower._apply_int8_edges) sets in_q8 only on
        # static-scale prequantized int8 readers and out_q8 only in
        # storage-NHWC plans; the JAX template has no other form of either
        if out_q8 and (not io_nhwc or not out_absmax > 0):
            raise RtErr(f"xla_conv: out_q8 needs the storage-NHWC form and "
                        f"out_scale > 0 (io_layout="
                        f"{rfs.str_vals.get('io_layout', '')}, out_scale="
                        f"{out_absmax})")
        if in_q8 and not (quant8 and prequant and act_absmax > 0):
            raise RtErr("xla_conv: in_q8 needs quant8, prequant_w and a "
                        "static act_scale > 0")
        if not quant8:
            return _cudnn_conv(rfs, grad_q8_site(
                rfs, io_nhwc or rfs.str_vals.get("layout") == "nhwc"))
        return int8_conv((sy, sx), (py, px), relu,
                         torch.int8 if out_q8 else store_dtype(rfs), io_nhwc,
                         prequant, act_absmax, in_q8, out_absmax)


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


@template
class Deconv(_ConvBase):
    """Transposed convolution (caffe's Deconvolution): each input pixel
    (iy, ix) adds x[n, i, iy, ix] * w[o, i, ky, kx] at out[n, o,
    iy*sy + ky - py, ix*sx + kx - px]; out = (in - 1) * stride + kernel -
    2 * pad.

    The filter arrives in the pipe's convention (out_chan, in_chan, y, x),
    out_chan being this layer's output channels (graph/caffe_io.py
    transposes a caffemodel's physical (in_chan, out_chan, ky, kx) blob at
    weight-copy time). F.conv_transpose2d wants (in_chan, out_chan, ky,
    kx) and runs the scatter itself, so the first two dims are swapped and
    the taps are not flipped (the JAX body flips them, since it runs a
    correlation). It is a vendor conv (vendor_conv, vendor_store): full
    FP32 on the operands rounded to the compute dtype, then the f32 bias,
    the ReLU and one rounding to the stored dtype; a bf16 conv_transpose2d
    would round the sum to bf16 before the bias (PERF.md, fault C2)."""

    name = "deconv"

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        ind = rfs.get_dims("in")
        fd = rfs.get_dims("filts")
        return 2 * ind.sz() * fd["out_chan"] * fd["y"] * fd["x"]

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, w, b=None):
        """Independent numpy scatter: each input pixel (iy,ix) adds
        x[n,i,iy,ix]·w[o,i,ky,kx] at out[n,o, iy·sy+ky−py, ix·sx+kx−px]."""
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        x = np.asarray(x, np.float64)
        w = np.asarray(w, np.float64)
        n, C, H, W = x.shape
        oc, ic, ky, kx = w.shape
        oy, ox = outd["y"], outd["x"]
        full = np.zeros((n, oc, (H - 1) * sy + ky, (W - 1) * sx + kx))
        for yy in range(ky):
            for xx in range(kx):
                full[:, :, yy:yy + (H - 1) * sy + 1:sy,
                     xx:xx + (W - 1) * sx + 1:sx] += \
                    np.einsum("nihw,oi->nohw", x, w[:, :, yy, xx],
                              optimize=True)
        out = full[:, :, py:py + oy, px:px + ox]
        if b is not None:
            out = out + np.asarray(b, np.float64)[None, :, None, None]
        if relu:
            out = np.maximum(out, 0)
        return out

    @classmethod
    def build(cls, rfs: OpBase):
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        ky, kx = fd["y"], fd["x"]
        want = ((ind["y"] - 1) * sy + ky - 2 * py,
                (ind["x"] - 1) * sx + kx - 2 * px)
        if (outd["y"], outd["x"]) != want:
            raise RtErr(f"deconv: out {outd} is not (in - 1) * stride + "
                        f"kernel - 2 * pad = {want}")
        io_nhwc, _ = storage_io(rfs)
        odt = store_dtype(rfs)
        conv = vendor_conv((sy, sx), (py, px), compute_dtype(rfs), io_nhwc,
                           transposed=True)

        def fn(x, w, b=None):
            return vendor_store(conv(x, w.transpose(0, 1), b), relu, odt,
                                io_nhwc)
        fn.route = "vendor"
        return fn


def make_deconv_op(n: int, cin: int, h: int, w: int, cout: int, ky: int,
                   kx: int, sy: int = 1, sx: int = 1, py: int = 0,
                   px: int = 0, relu: bool = False,
                   bias: bool = True) -> OpBase:
    """Helper: construct a Deconvolution op sig in the pipe convention."""
    oy = (h - 1) * sy + ky - 2 * py
    ox = (w - 1) * sx + kx - 2 * px
    op = OpBase({"type": "Deconvolution", "func_name": "deconv"})
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
