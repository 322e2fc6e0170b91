"""Local response normalization across channels (caffe's LRN,
ACROSS_CHANNELS): out = in * (k + alpha/n * sum of in^2 over an n-channel
window centred on each channel)^-beta.

Port of boda_tpu/ops/pallas/lrn.py, which computes it in plain jnp. Here
it is torch ops on the tensor's device, in f32, cast to the storage dtype
at the end as the JAX body does. The window runs over the channels (the
last dim under NHWC storage, dim 1 otherwise) with the half-window padding
(n//2, n-1-n//2), summed in one reduction over a size-n window of the
padded squares (an unfold view, no copy): a prefix sum would cancel in
f32. `emit_out_scale_base` stays in the reduced sig, as in the JAX
template; training's bck_lrn (ops/cuda/bck.py) differentiates this
function.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template


def _params(rfs: OpBase):
    n = rfs.get_u32_or("local_size", 5)

    def fval(k, d):
        v = rfs.nda_vals.get(k)
        return float(v.item()) if v is not None and v.v is not None else d
    return n, fval("alpha", 1.0), fval("beta", 0.75), fval("k", 1.0)


@template
class Lrn(KernelTemplate):
    name = "lrn"
    nhwc_ok = True
    args = [adecl("in", IN, "img chan y x"), adecl("out", OUT, "img chan y x")]
    sig_nda_keys = ["local_size", "alpha", "beta", "k"]
    sig_str_keys = ["emit_out_scale_base"]

    @classmethod
    def build(cls, rfs: OpBase):
        n, alpha, beta, k = _params(rfs)
        pre = n // 2
        nhwc = rfs.str_vals.get("io_layout") == "nhwc"

        # F.pad's (before, after) pairs run from the last dim back
        cpad = (pre, n - 1 - pre) if nhwc else (0, 0, 0, 0, pre, n - 1 - pre)
        cdim = 3 if nhwc else 1

        def fn(x):
            xf = x.float()
            ssum = F.pad(xf * xf, cpad).unfold(cdim, n, 1).sum(-1)
            scale = k + (alpha / n) * ssum
            return (xf * torch.pow(scale, -beta)).to(x.dtype)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        x = np.asarray(x, np.float64)
        n, alpha, beta, k = _params(rfs)
        pre = n // 2
        C = x.shape[1]
        sq = x * x
        out = np.empty_like(x)
        for c in range(C):
            c0, c1 = max(0, c - pre), min(C, c - pre + n)
            scale = k + (alpha / n) * sq[:, c0:c1].sum(axis=1)
            out[:, c] = x[:, c] * np.power(scale, -beta)
        return out.astype(np.asarray(x).dtype)
