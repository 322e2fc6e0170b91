"""tconv (kernel B2), its planner and the `tconv` template.

Port of boda_tpu/ops/pallas/tconv.py. `tconv` wraps the hand-written CUDA
kernel in csrc/tconv.cu, a stride-1 implicit-GEMM conv on NHWC input with
the filter in OHWI order (see its header for what bounds it and how it is
built): bf16 on the tensor cores, f32 in full FP32 on FFMA. `tconv_plan`
picks its tile and its K split; `tconv_plain` is the same function in
plain PyTorch. The wrapper checks its operands, then runs the plain
version for CPU tensors and the kernel for CUDA tensors.

Unlike the Pallas version, conv padding is a masked load in the kernel:
no padded copy of x (tconv.py:193-196) and no channel padding to 128.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import template
from .build import check_launch, load_kernels
from .conv import _ConvBase, conv_params
from .util import GemmPlan, check_operand, compute_dtype, cuda_stream, \
    full_fp32, gemm_plan, sm_count, storage_io, store_dtype, use_kernel

TILE_N = 128                 # block tile: 128 pixels x 128 output channels
# Split-K, by route, as util.gemm_plan reads it: (split grids of fewer than
# this many output tiles per SM, least split count, blocks per SM a split
# grid reaches, least K chunks a split sums). From the kernel timed alone
# by split count at the ResNet-50 3x3 shapes (the `tconv splits` lines of
# chip_smoke.py; PERF.md), where this rule picks the fastest count timed
# or one within noise of it: the bf16 kernel is short
# enough that the partial sums' round trip through the workspace costs
# more than an idle quarter of the card (res4b b32, 98 tiles: 0.038 ms
# unsplit, 0.042 in 2 splits), so it splits only grids under half the
# SMs; the f32 kernel is fastest in 4 splits at res3, res4b and res5 at
# batch 32 (res4b: 0.298 unsplit, 0.268 in 2, 0.241 in 4, 0.251 in 8).
SPLIT = {torch.bfloat16: (0.5, 1, 1.5, 2), torch.float32: (2, 4, 1.5, 2)}


@functools.lru_cache(maxsize=4096)
def tconv_plan(n: int, H: int, W: int, C: int, oc: int, ky: int, kx: int,
               dtype: torch.dtype, pad: tuple[int, int],
               sms: int) -> GemmPlan:
    """The kernel's plan for x [n, H, W, C] (dtype) and an [oc, ky, kx, C]
    filter at padding `pad`, on a card with `sms` SMs: the implicit GEMM
    of n*oy*ox pixels by oc channels over ky*kx*C, on 128 x 128 tiles,
    with operands in 16-byte loads where C allows, and K split as the
    route's SPLIT rule says (util.gemm_plan)."""
    M = n * (H + 2 * pad[0] - ky + 1) * (W + 2 * pad[1] - kx + 1)
    return gemm_plan("tconv_plan", M, oc, ky * kx * C, C, TILE_N, dtype,
                     sms, SPLIT)


def _check(x, w, bias, pad, out_dtype):
    check_operand(x, "tconv x", 4)
    check_operand(w, "tconv w", 4)
    if w.dtype != x.dtype:
        raise RtErr(f"tconv: x is {x.dtype} but w is {w.dtype}")
    n, H, W, C = x.shape
    oc, ky, kx, wc = w.shape
    if wc != C:
        raise RtErr(f"tconv: x has {C} channels, w {tuple(w.shape)} (OHWI) "
                    f"has {wc}")
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
    + bias in f32, ReLU, one cast; NHWC in and out, the filter OHWI."""
    with full_fp32():
        y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                     w.permute(0, 3, 1, 2).float(), padding=pad)
    if bias is not None:
        y = y + bias[None, :, None, None]
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def tconv(x, w, bias=None, pad=(0, 0), relu=False, out_dtype=torch.float32):
    """Stride-1 conv: out[n,oy,ox,oc] = relu?(sum x[n,..,C] * w[oc,..,C]
    + bias[oc]), accumulated in f32.

    x: contiguous NHWC; w: contiguous OHWI [oc, ky, kx, C] of x's dtype (f32
    or bf16); bias: contiguous f32 [oc] or None; pad: (py, px). Returns a
    new NHWC tensor of out_dtype (f32 or bf16). A split-K plan adds an f32
    workspace of splits x (n*oy*ox) x oc for the partial sums.

    On CUDA tensors the launch is asynchronous on the current stream; an
    input (or the workspace) freed after the call is reused only in that
    stream's order by torch's caching allocator, so no synchronisation is
    needed."""
    n, H, W, C, oc, ky, kx, oy, ox = _check(x, w, bias, pad, out_dtype)
    if not use_kernel(x, w, bias):
        return tconv_plain(x, w, bias, pad, relu, out_dtype)
    plan = tconv_plan(n, H, W, C, oc, ky, kx, x.dtype, pad,
                      sm_count(x.device.index))
    # torch allocations are 256-byte aligned; a view into one may not be
    vec = plan.vec and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    out = torch.empty((n, oy, ox, oc), dtype=out_dtype, device=x.device)
    ws = torch.empty((plan.splits, n * oy * ox, oc), dtype=torch.float32,
                     device=x.device) if plan.splits > 1 else None
    rc = load_kernels().boda_tconv(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        n, H, W, C, oc, ky, kx, pad[0], pad[1],
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(bool(relu)), plan.splits, int(vec),
        cuda_stream(x.device))
    check_launch(rc, "tconv")
    tconv.launches += 1
    return out


tconv.launches = 0


@template
class TConv(_ConvBase):
    """Stride-1 direct conv on kernel B2 (JAX: Pallas tconv)."""

    name = "tconv"

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
            # the kernel reads the filter K-contiguous: OIHW -> OHWI
            wh = w.to(cdt).permute(0, 2, 3, 1).contiguous()
            y = tconv(xh.contiguous(), wh, bias, (py, px), relu, odt)
            return y if io_nhwc else y.permute(0, 3, 1, 2).contiguous()
        return fn
