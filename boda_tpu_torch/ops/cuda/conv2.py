"""xla_conv2: horizontally-fused sibling convolutions on the vendor conv.

Port of boda_tpu/ops/pallas/conv2.py (XlaConv2). Convolutions that share
one input and one stride (the branch1 projection and the branch2a reduce at
every ResNet stage boundary, inception 1x1 trios, squeezenet fire
expand1x1 + expand3x3 pairs) run as ONE conv whose filters are concatenated
on out_chan, then split; kernel sizes may differ where (2*pad - kern)
matches per axis: the smaller kernel is zero-padded to the center of the
group's largest (exact: a 1x1 pad-0 conv IS a 3x3 pad-1 conv with one live
tap). Each member keeps its own ReLU flag and stored dtype. The
`fuse_siblings` lowering pass (engine/lower.py) emits the steps, gated by
OpTune(fuse_siblings=1).

A vendor role in both packages (XLA's conv there; here kernel B7 under
prec=bf16 with NHWC storage on inference, one launch that writes each
member's output, else cuDNN's through ops/cuda/conv.vendor_conv, which says
which arithmetic runs and where it rounds; conv.takes_b7 gives the rule),
not a port of a TPU kernel. The declared args, reduced-signature keys,
flops and the float64 reference are the JAX template's (conv2.py:35-108),
so reduced sigs and wisdom keys stay string-equal. The int8 forms (quant8,
with prequantized weights or the weight quantize in the step;
conv2.py:139-193) run as one int8 conv on kernel B6 (conv.int8_conv) over
the concatenated int8 filters, into f32, and are split per member as the
float form is; the int8 center-embed pads zero taps. Under autograd the
float form carries ops/mxu_grad's VJP over the concatenated filter, whose
gradient autograd splits back per member (conv2.py:130, :200); with every
member grad_q8 (the lowering sets it only so), its weight gradient is the
int8 one on B6.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.error import RtErr
from ..mxu_grad import grad_q8_site
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .bconv import FilterCache, Member, bconv, ohwi_bf16, records_grad
from .conv import SIBS, _ConvBase, _bias_b7, _scale_of, int8_conv, \
    takes_b7, vendor_conv, vendor_store
from .util import compute_dtype, storage_io, torch_dtype


@template
class XlaConv2(KernelTemplate):
    """Sibling convs as one vendor conv over the concatenated filters."""

    name = "xla_conv2"
    nhwc_ok = True
    args = [adecl("in", IN, "img chan y x"),
            adecl("filts_a", IN, "out_chan in_chan y x"),
            adecl("biases_a", IN, "out_chan", opt=True),
            # *_scale: per-out_chan dequant scales set by the weight-
            # prequantization pass (engine/lower.py): filts arrive int8
            adecl("filts_a_scale", IN, "out_chan", opt=True),
            adecl("filts_b", IN, "out_chan in_chan y x"),
            adecl("biases_b", IN, "out_chan", opt=True),
            adecl("filts_b_scale", IN, "out_chan", opt=True),
            adecl("filts_c", IN, "out_chan in_chan y x", opt=True),
            adecl("biases_c", IN, "out_chan", opt=True),
            adecl("filts_c_scale", IN, "out_chan", opt=True),
            adecl("filts_d", IN, "out_chan in_chan y x", opt=True),
            adecl("biases_d", IN, "out_chan", opt=True),
            adecl("filts_d_scale", IN, "out_chan", opt=True),
            adecl("out_a", OUT, "img chan y x"),
            adecl("out_b", OUT, "img chan y x"),
            adecl("out_c", OUT, "img chan y x", opt=True),
            adecl("out_d", OUT, "img chan y x", opt=True)]
    sig_nda_keys = ["in_pad", "stride", "kern_sz", "relu_a", "relu_b",
                    "relu_c", "relu_d", "quant8", "act_scale", "prequant_w",
                    "grad_q8"]
    sig_str_keys = ["prec", "layout"]

    @classmethod
    def _sibs(cls, rfs: OpBase):
        return [s for s in SIBS if f"filts_{s}" in rfs.nda_vals]

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        tot = 0
        for s in cls._sibs(rfs):
            f = rfs.get_dims(f"filts_{s}")
            tot += 2 * rfs.get_dims(f"out_{s}").sz() * f["in_chan"] \
                * f["y"] * f["x"]
        return tot

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, *wbs):
        sibs = cls._sibs(rfs)
        if rfs.get_u32_or("prequant_w", 0):
            # (w, b, scale) triplets: dequantize back to float pairs
            ws = [np.asarray(wbs[3 * i], np.float64)
                  * np.asarray(wbs[3 * i + 2], np.float64
                               ).reshape(-1, 1, 1, 1)
                  for i in range(len(sibs))]
            wbs = [v for i in range(len(sibs))
                   for v in (ws[i], wbs[3 * i + 1])]
        fds = [rfs.get_dims(f"filts_{s}") for s in sibs]
        ky_f = max(d["y"] for d in fds)
        kx_f = max(d["x"] for d in fds)
        pd = rfs.get_dims_or_none("in_pad")
        py_f, px_f = (pd["y"], pd["x"]) if pd is not None else (0, 0)
        outs = []
        for i, s in enumerate(sibs):
            sr = OpBase({"type": "Convolution"})
            sr.nda_vals["in"] = rfs.nda_vals["in"]
            sr.nda_vals["filts"] = rfs.nda_vals[f"filts_{s}"]
            sr.nda_vals["out"] = rfs.nda_vals[f"out_{s}"]
            if "stride" in rfs.nda_vals:
                sr.nda_vals["stride"] = rfs.nda_vals["stride"]
            # per-sibling pad: fused pad minus this kernel's embed margin
            py_i = py_f - (ky_f - fds[i]["y"]) // 2
            px_i = px_f - (kx_f - fds[i]["x"]) // 2
            if py_i or px_i:
                sr.set_null_dims("in_pad", y=py_i, x=px_i)
            if rfs.get_u32_or(f"relu_{s}", 0):
                sr.set_u32("conv_has_relu", 1)
            outs.append(_ConvBase.ref_impl(sr, x, wbs[2 * i], wbs[2 * i + 1]))
        return tuple(outs)

    @classmethod
    def build(cls, rfs: OpBase):
        quant8 = rfs.get_u32_or("quant8", 0) == 1
        prequant = rfs.get_u32_or("prequant_w", 0) == 1
        if prequant and not quant8:
            raise RtErr("xla_conv2: prequant_w needs quant8")
        sibs = cls._sibs(rfs)
        st = rfs.get_dims_or_none("stride")
        pad = rfs.get_dims_or_none("in_pad")
        stride = (st["y"], st["x"]) if st else (1, 1)
        padding = (pad["y"], pad["x"]) if pad else (0, 0)
        fds = [rfs.get_dims(f"filts_{s}") for s in sibs]
        ky_f = max(d["y"] for d in fds)
        kx_f = max(d["x"] for d in fds)
        embeds = [((ky_f - d["y"]) // 2, (kx_f - d["x"]) // 2) for d in fds]
        ns = [d["out_chan"] for d in fds]
        relus = [rfs.get_u32_or(f"relu_{s}", 0) == 1 for s in sibs]
        has_bias = [f"biases_{s}" in rfs.nda_vals for s in sibs]
        io_nhwc, edt = storage_io(rfs)
        out_dts = [(edt if io_nhwc and edt is not None else
                    torch_dtype(rfs.get_dims(f"out_{s}").dtype)) for s in sibs]
        cdt = compute_dtype(rfs)
        b7 = not quant8 and takes_b7(cdt, io_nhwc)
        if quant8:
            # one int8 conv over all members, stored f32 before ReLU: each
            # member's ReLU and store follow, as in the float form
            q = int8_conv(stride, padding, False, torch.float32, io_nhwc,
                          prequant, _scale_of(rfs, "act_scale"), False)

            def conv(x, w, b, sws, amax=None):
                y = q(x, w, sws, b, amax=amax) if prequant \
                    else q(x, w, b, amax=amax)
                return y.permute(0, 3, 1, 2) if io_nhwc else y
        else:
            vconv = vendor_conv(stride, padding, cdt, io_nhwc,
                                q8=grad_q8_site(rfs, True))

            def conv(x, w, b, _sws):
                return vconv(x, w, b)

        def embed(ws):
            # mixed kernel sizes: center-embed the smaller kernel in the
            # group's largest with zero taps (exact, int8 or float)
            return [F.pad(w, (dx, dx, dy, dy)) if (dy or dx) else w
                    for w, (dy, dx) in zip(ws, embeds)]
        # B7: every member in one launch, each into its own output
        members = tuple(Member(n_i, relu_i, dt_i)
                        for n_i, relu_i, dt_i in zip(ns, relus, out_dts))
        filt = FilterCache(lambda *ws: ohwi_bf16(torch.cat(embed(ws), dim=0)))

        def fn(x, *wbs, **kw):
            # the members' operands in declared order: filts, biases where
            # the member has them, and the int8 filters' scales
            it = iter(wbs)
            ws, bs, ss = [], [], []
            for hb in has_bias:
                ws.append(next(it))
                bs.append(next(it) if hb else None)
                if prequant:
                    ss.append(next(it))
            if b7 and not records_grad(x, *ws, *bs):
                return bconv(x.to(torch.bfloat16).contiguous(), filt(*ws),
                             tuple(_bias_b7(b) for b in bs), members, stride,
                             padding)
            bs = [torch.zeros(n_i, device=x.device) if b is None
                  else b.float() for b, n_i in zip(bs, ns)]
            y = conv(x, torch.cat(embed(ws), dim=0), torch.cat(bs, dim=0),
                     torch.cat(ss, dim=0) if prequant else None, **kw)
            outs, off = [], 0
            for n_i, relu_i, dt_i in zip(ns, relus, out_dts):
                outs.append(vendor_store(y[:, off:off + n_i], relu_i, dt_i,
                                         io_nhwc))
                off += n_i
            return tuple(outs)
        if quant8 and hasattr(q, "slot_absmax"):
            # a dynamic scale: fn(x, ..., amax=m) as int8_conv's conv
            fn.slot_absmax = q.slot_absmax
        fn.route = "b6" if quant8 else ("b7" if b7 else "vendor")
        return fn
