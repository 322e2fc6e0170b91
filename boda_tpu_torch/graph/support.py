"""Receptive-field / support-geometry math.

Capability parity with the reference's conv_common.{H,cc} — the image-space
↔ feature-space box mapping used by dense/sliding-window equivalence tests,
pyramid packing, and prediction-region geometry. The semantics (valid /
any_valid / core_valid modes, closed→half-open conversion, core shifted
+.5 on odd/even mismatch) are ported exactly; the golden tests pin them
(reference: test_dense.cc asserts MRD ≤ 5e-5 on features aligned via these
functions).

Conventions: points are (y, x); `in_box` is a half-open pixel box in input
image space; `out_box` is half-open in output feature space.

The port's copy of boda_tpu/graph/support.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.error import RtErr
from ..core.geom import Box, Pt

CM_VALID = "valid"
CM_ANY_VALID = "any_valid"
CM_CORE_VALID = "core_valid"


@dataclass
class SupportInfo:
    """Per-node receptive-field info (reference: conv_support_info_t):
    support_sz — input pixels covered by one output pixel (0,0 = global);
    support_stride — input pixels between adjacent outputs;
    eff_tot_pad — accumulated effective input padding."""

    support_sz: Pt = field(default_factory=Pt)
    support_stride: Pt = field(default_factory=Pt)
    eff_tot_pad: Pt = field(default_factory=Pt)

    def valid(self) -> bool:
        return not self.support_stride.is_zeros()

    def init_as_source(self) -> None:
        assert not self.valid()
        self.support_sz = Pt(1, 1)
        self.support_stride = Pt(1, 1)


def conv_in_sz_to_out_sz(in_sz: Pt, in_pad: Pt, stride: Pt, kern_sz: Pt) -> Pt:
    """Conv output size: floor((in + 2*pad - kern)/stride) + 1; zero if the
    (padded) input doesn't cover the kernel (conv_util.cc:167)."""
    if not kern_sz.both_nonzero():
        raise RtErr("conv_in_sz_to_out_sz: kernel size is zero")
    pad_in = in_sz + in_pad + in_pad
    if not pad_in.both_ge(kern_sz):
        return Pt(0, 0)
    return (pad_in - kern_sz).floor_div(stride) + Pt(1, 1)


def conv_out_sz_to_in_sz(out_sz: Pt, in_pad: Pt, stride: Pt, kern_sz: Pt) -> Pt:
    """Nominal input size for a conv output size (conv_util.cc:175)."""
    if not out_sz.both_nonzero():
        raise RtErr("conv_out_sz_to_in_sz: output size is zero")
    no_pad_in = kern_sz + (out_sz - Pt(1, 1)) * stride
    tot_pad = in_pad + in_pad
    if not no_pad_in.both_ge(tot_pad):
        raise RtErr("conv_out_sz_to_in_sz: padding exceeds input requirement")
    return no_pad_in - tot_pad


def pool_in_sz_to_out_sz(in_sz: Pt, in_pad: Pt, stride: Pt, kern_sz: Pt) -> Pt:
    """Caffe pooling convention: partial windows produce an output pixel
    (ceil; conv_util.cc:196-204)."""
    pad_in = in_sz + in_pad + in_pad
    if not pad_in.both_ge(kern_sz):
        return Pt(1, 1)
    return (pad_in - kern_sz).ceil_div(stride) + Pt(1, 1)


def get_base_out_support(csi: SupportInfo, core_only: bool) -> Box:
    """Support of the 'first' output pixel; core is centered, of size
    support_stride, shifted +.5 on odd/even mismatch (conv_common.cc:54)."""
    assert csi.support_sz.both_nonzero()
    if not core_only:
        return Box(Pt(0, 0), csi.support_sz)
    ub = Pt((csi.support_sz.y + csi.support_stride.y + 1) >> 1,
            (csi.support_sz.x + csi.support_stride.x + 1) >> 1)
    return Box(ub - csi.support_stride, ub)


def in_box_to_out_box(in_box: Box, mode: str, csi: SupportInfo) -> Box:
    """Map an input-image box to the output-feature box computed (per mode)
    from it (conv_common.cc:64-107). Returned box is half-open; it may be
    non-normalized (no valid outputs) or extend outside the output space."""
    in_pel = in_box + csi.eff_tot_pad
    if not in_pel.is_strictly_normalized():
        raise RtErr("in_box_to_out_box: input box not strictly normalized")
    if mode == CM_ANY_VALID:
        support = get_base_out_support(csi, False)
        p0 = (in_pel.p0 + Pt(1, 1) - support.p1).ceil_div(csi.support_stride)
        p1 = (in_pel.p1 - Pt(1, 1) - support.p0).floor_div(csi.support_stride)
        out_box = Box(p0, p1)
    elif mode in (CM_VALID, CM_CORE_VALID):
        support = get_base_out_support(csi, mode == CM_CORE_VALID)
        shrunk = in_pel - support
        out_box = Box(shrunk.p0.ceil_div(csi.support_stride),
                      shrunk.p1.floor_div(csi.support_stride))  # closed box
    else:
        raise RtErr(f"in_box_to_out_box: unknown mode '{mode}'")
    # closed → half-open
    return Box(out_box.p0, out_box.p1 + Pt(1, 1))


def unchecked_out_box_to_in_box(out_box: Box, mode: str, csi: SupportInfo) -> Box:
    """Input-space support of an output box; no clipping (conv_common.cc:110+)."""
    if not out_box.is_strictly_normalized():
        raise RtErr("out_box_to_in_box: output box not strictly normalized")
    assert not csi.support_sz.is_zeros()
    closed = Box(out_box.p0, out_box.p1 - Pt(1, 1))
    if mode == CM_ANY_VALID:
        # minimal box: any smaller box maps to a smaller out_box
        support = get_base_out_support(csi, False)
        p0 = closed.p1 * csi.support_stride + support.p0  # uses only last pixel's support start
        p1 = closed.p0 * csi.support_stride + support.p1
        in_box = Box(p0, p1)
    elif mode in (CM_VALID, CM_CORE_VALID):
        support = get_base_out_support(csi, mode == CM_CORE_VALID)
        in_box = Box(closed.p0 * csi.support_stride + support.p0,
                     closed.p1 * csi.support_stride + support.p1)
    else:
        raise RtErr(f"out_box_to_in_box: unknown mode '{mode}'")
    return in_box - csi.eff_tot_pad
