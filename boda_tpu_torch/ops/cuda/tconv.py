"""tconv (kernel B2) and the `tconv` template.

Port of boda_tpu/ops/pallas/tconv.py. `tconv` wraps the hand-written CUDA
kernel in csrc/tconv.cu, a stride-1 implicit-GEMM conv on NHWC input (see
its header for what bounds it and how it is built); `tconv_plain` is the
same function in plain PyTorch. The wrapper checks its operands, then runs
the plain version for CPU tensors and the kernel for CUDA tensors.

Unlike the Pallas version, conv padding is a masked load in the kernel:
no padded copy of x (tconv.py:193-196) and no channel padding to 128.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from boda_tpu.core.error import RtErr
from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.pallas import tconv as jtconv
from boda_tpu.ops.pallas.conv import conv_params

from ..registry import template
from .build import check_launch, load_kernels
from .util import check_operand, compute_dtype, full_fp32, \
    storage_io, store_dtype, use_kernel


def _check(x, w, bias, pad, out_dtype):
    check_operand(x, "tconv x", 4)
    check_operand(w, "tconv w", 4)
    if w.dtype != x.dtype:
        raise RtErr(f"tconv: x is {x.dtype} but w is {w.dtype}")
    n, H, W, C = x.shape
    oc, wc, ky, kx = w.shape
    if wc != C:
        raise RtErr(f"tconv: x has {C} channels, w {tuple(w.shape)} has {wc}")
    py, px = pad
    oy, ox = H + 2 * py - ky + 1, W + 2 * px - kx + 1
    if min(n, C, oc, oy, ox) < 1 or py < 0 or px < 0:
        raise RtErr(f"tconv: empty output for x {tuple(x.shape)}, "
                    f"w {tuple(w.shape)}, pad {pad}")
    if max(x.numel(), w.numel(), n * oy * ox * oc) >= 2 ** 31:
        raise RtErr("tconv: extent over int32")
    if bias is not None:
        check_operand(bias, "tconv bias", 1, (torch.float32,))
        if bias.shape[0] != oc:
            raise RtErr(f"tconv: bias length {bias.shape[0]} != oc={oc}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise RtErr(f"tconv: output dtype {out_dtype} not f32/bf16")
    return n, H, W, C, oc, ky, kx, oy, ox


def tconv_plain(x, w, bias=None, pad=(0, 0), relu=False,
                out_dtype=torch.float32):
    """Plain PyTorch tconv: F.conv2d of the f32-cast operands in full FP32,
    + bias in f32, ReLU, one cast; NHWC in and out."""
    with full_fp32():
        y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), padding=pad)
    if bias is not None:
        y = y + bias[None, :, None, None]
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def tconv(x, w, bias=None, pad=(0, 0), relu=False, out_dtype=torch.float32):
    """Stride-1 conv: out[n,oy,ox,oc] = relu?(sum x[n,..,C] * w[oc,C,ky,kx]
    + bias[oc]), accumulated in f32.

    x: contiguous NHWC; w: contiguous OIHW of x's dtype (f32 or bf16);
    bias: contiguous f32 [oc] or None; pad: (py, px). Returns a new NHWC
    tensor of out_dtype (f32 or bf16).

    On CUDA tensors the launch is asynchronous on the current stream; an
    input freed after the call is reused only in that stream's order by
    torch's caching allocator, so no synchronisation is needed."""
    n, H, W, C, oc, ky, kx, oy, ox = _check(x, w, bias, pad, out_dtype)
    if not use_kernel(x, w, bias):
        return tconv_plain(x, w, bias, pad, relu, out_dtype)
    out = torch.empty((n, oy, ox, oc), dtype=out_dtype, device=x.device)
    rc = load_kernels().boda_tconv(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        n, H, W, C, oc, ky, kx, pad[0], pad[1],
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(bool(relu)), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(rc, "tconv")
    tconv.launches += 1
    return out


tconv.launches = 0


@template
class TConv(jtconv.TConv):
    """Stride-1 direct conv on kernel B2 (JAX: Pallas tconv)."""

    @classmethod
    def build(cls, rfs: OpBase):
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        if (sy, sx) != (1, 1):
            raise RtErr(f"tconv: needs stride 1, got ({sy}, {sx})")
        io_nhwc, _ = storage_io(rfs)
        cdt, odt = compute_dtype(rfs), store_dtype(rfs)

        def fn(x, w, b=None):
            xh = x.to(cdt)
            if not io_nhwc:
                xh = xh.permute(0, 2, 3, 1)
            # the Pallas kernel adds the bias rounded to the compute dtype
            # (tconv.py:199), unlike build_matmul_ext's f32 bias
            bias = None if b is None else b.to(cdt).float().contiguous()
            y = tconv(xh.contiguous(), w.to(cdt).contiguous(), bias, (py, px),
                      relu, odt)
            return y if io_nhwc else y.permute(0, 3, 1, 2).contiguous()
        return fn
