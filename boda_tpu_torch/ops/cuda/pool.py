"""The `pool` template: max and average pooling, caffe semantics, and their
backward.

Port of boda_tpu/ops/pallas/pool.py, which computes pooling outside Pallas
too. Caffe's ceil-mode output size can put a last window partly outside
the padded input; torch's own ceil_mode drops a window that would start
in the right-hand padding, so the input is padded explicitly instead (with
-inf for max, 0 for sums) and the valid windows are cropped to (oy, ox).
Average pooling divides by caffe's clipped window count, and under NHWC
storage it sums in f32 and returns the edge dtype (pool.py:165-213).

Backward: autograd's, through the pad, the pool and the crop.
torch's max-pool backward sends each window's cotangent to its first
maximum in row-major window order (the kernels keep a candidate only where
it is strictly greater), caffe's semantics and XLA SelectAndScatter's
GE-select, which the JAX package's default backward is; the -inf padding
never wins a window that holds an input, and the crop drops what falls on
the padding. It is the one backward: the JAX package's pool_bwd=gather
(pool.py:18-134) computes the same first-argmax gradient in another form,
chosen there to avoid XLA's scatter, so the key changes no values here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template


def _params(rfs: OpBase):
    ind = rfs.get_dims("in")
    outd = rfs.get_dims("out")
    ks = rfs.get_dims_or_none("kern_sz")
    st = rfs.get_dims_or_none("stride")
    pad = rfs.get_dims_or_none("in_pad")
    ky, kx = (ks["y"], ks["x"]) if ks else (ind["y"], ind["x"])
    if ky == 0 or kx == 0:  # global pooling: kernel covers the whole input
        ky, kx = ind["y"], ind["x"]
    sy, sx = (st["y"], st["x"]) if st else (1, 1)
    py, px = (pad["y"], pad["x"]) if pad else (0, 0)
    avg = rfs.str_vals.get("avg_pool", "0") == "1"
    return ind, outd, ky, kx, sy, sx, py, px, avg


@template
class Pool(KernelTemplate):
    """Max / average pooling over NCHW or NHWC storage tensors. The
    pool_bwd and (non-storage) layout keys change only the JAX program's
    backward form and transposes, not values, so they are not read."""

    name = "pool"
    args = [adecl("in", IN, "img chan y x"), adecl("out", OUT, "img chan y x")]
    sig_nda_keys = ["kern_sz", "stride", "in_pad"]
    sig_str_keys = ["avg_pool", "layout", "pool_bwd"]
    nhwc_ok = True

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        ind, outd, ky, kx, sy, sx, py, px, avg = _params(rfs)
        x = np.asarray(x)
        n, c, H, W = x.shape
        oy, ox = outd["y"], outd["x"]
        out = np.zeros((n, c, oy, ox), dtype=x.dtype)
        for yy in range(oy):
            for xx in range(ox):
                y0, x0 = yy * sy - py, xx * sx - px
                y1, x1 = min(y0 + ky, H), min(x0 + kx, W)
                y0c, x0c = max(y0, 0), max(x0, 0)
                win = x[:, :, y0c:y1, x0c:x1]
                if avg:
                    # caffe: divide by clipped-to-padded-image window size
                    cnt = (min(y0 + ky, H + py) - y0) * (min(x0 + kx, W + px) - x0)
                    out[:, :, yy, xx] = win.sum(axis=(2, 3)) / max(cnt, 1)
                else:
                    out[:, :, yy, xx] = win.max(axis=(2, 3)) if win.size else 0
        return out

    @classmethod
    def build(cls, rfs: OpBase):
        ind, outd, ky, kx, sy, sx, py, px, avg = _params(rfs)
        oy, ox = outd["y"], outd["x"]
        extra_y = max(0, (oy - 1) * sy + ky - (ind["y"] + 2 * py))
        extra_x = max(0, (ox - 1) * sx + kx - (ind["x"] + 2 * px))
        pads = (px, px + extra_x, py, py + extra_y)
        nhwc = rfs.str_vals.get("io_layout") == "nhwc"
        if avg:
            # caffe divisor: the window clipped to the padded image at the
            # high edge only
            H, W = ind["y"], ind["x"]
            cy = np.array([min(y * sy - py + ky, H + py) - (y * sy - py)
                           for y in range(oy)])
            cx = np.array([min(x * sx - px + kx, W + px) - (x * sx - px)
                           for x in range(ox)])
            cnt_np = np.maximum(cy[:, None] * cx[None, :], 1).astype(np.float32)
            cnt_by_dev: dict = {}

        def pool_nchw(x):
            if avg:
                cnt = cnt_by_dev.get(x.device)
                if cnt is None:
                    cnt = cnt_by_dev[x.device] = torch.from_numpy(cnt_np).to(
                        x.device)
                s = F.avg_pool2d(F.pad(x, pads), (ky, kx), (sy, sx),
                                 divisor_override=1)
                return s[:, :, :oy, :ox] / cnt
            m = F.max_pool2d(F.pad(x, pads, value=float("-inf")), (ky, kx),
                             (sy, sx))
            return m[:, :, :oy, :ox]

        if not nhwc:
            return pool_nchw

        def pool_nhwc(xh):
            x = xh.permute(0, 3, 1, 2)
            y = pool_nchw(x.float()).to(xh.dtype) if avg else pool_nchw(x)
            return y.permute(0, 2, 3, 1).contiguous()
        return pool_nhwc
