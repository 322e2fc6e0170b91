"""gconv (kernel B8): the grouped conv under prec=bf16 with NHWC storage,
on inference (the route ops/cuda/conv.takes_b8 gives).

Replaces no TPU kernel: the JAX package has no grouped conv. It is the bf16
vendor conv's function in g groups, each output channel summing over its
group's in / g input channels alone (csrc/gconv.cu; its header gives what
bounds it and what the design does about that):

    y[n,oy,ox,o] = bf16(relu?(f32(sum over the window and the channels of
                   o's group of x * w[o]) + bias[o]))

bf16 operands, f32 sums, the bias added in f32, one rounding to bf16. B7
(bconv.py) cannot take it: its N and K tiles (64+ columns, 64-value chunks)
are built for the ungrouped convs' widths, and a group of ResNeXt-101
(64x4d) has 4 to 32 channels.

`gconv_plain` is the function in plain PyTorch, with the vendor conv's
arithmetic (ops/mxu_grad._conv_fwd in groups: full FP32 on the rounded
operands, channels_last, then conv.vendor_store), so a CPU tensor, which
takes it, gives what the vendor path gave. `gconv_plan` is the kernel's
tile: a block computes TY x TX output pixels of one image over a slab of 64
channels (`SLAB`), from a halo of the input staged once in shared memory.
`gconv_fits` says which convs the kernel has an instance for: groups of
equal width in and out (4, 8, 16, 32 or 64 channels), an input that splits
into whole slabs, and a filter of at most 3x3 taps (a slab's filter then
fits beside the halo).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ...core.error import RtErr
from ..mxu_grad import _conv_fwd
from .build import check_launch, load_kernels
from .util import check_operand, cuda_stream, use_kernel

GROUP_WIDTHS = (4, 8, 16, 32, 64)
SLAB = 64           # input (and output) channels of a block
TILE_PIXELS = 128   # output pixels a block aims at
HALO_BYTES = 80 * 1024  # the most shared memory a block's input halo takes
# shared memory words of a staged pixel of the slab: 64 bf16 and 16 bytes
# of padding, so that the 8 rows of an mma fragment fall in other banks
PIXEL_WORDS = SLAB // 2 + 4


def gconv_fits(cin: int, cout: int, groups: int, taps: int) -> bool:
    """Whether B8 has an instance for a conv of cin inputs and cout outputs
    in `groups` groups with a filter of `taps` (ky * kx) taps: equal group
    widths in and out, one of GROUP_WIDTHS, cin a whole number of slabs,
    at most 9 taps."""
    if groups < 2 or cin % groups or cout % groups:
        return False
    cg = cin // groups
    return cout // groups == cg and cg in GROUP_WIDTHS \
        and cin % SLAB == 0 and taps <= 9


@dataclass(frozen=True)
class GconvPlan:
    """A block's tile: ty x tx output pixels of one image (tiles_y x
    tiles_x of them cover the output), from an hy x hx input halo."""
    ty: int
    tx: int
    tiles_y: int
    tiles_x: int
    hy: int
    hx: int


@functools.lru_cache(maxsize=1024)
def gconv_plan(oy: int, ox: int, ky: int, kx: int,
               stride: tuple[int, int]) -> GconvPlan:
    """The tile for an oy x ox output of a ky x kx conv: at most 32 columns
    wide (the output's width in equal parts), as many rows as make about
    TILE_PIXELS pixels (in equal parts of oy), fewer where the halo would
    pass HALO_BYTES (a stride-2 conv reads four times the pixels). A block
    then takes at most 80 KB of halo, 75 KB of a 3x3 filter slab (groups of
    64) and 18 KB of staged output: within the 227 KB of an SM."""
    sy, sx = stride
    tiles_x = math.ceil(ox / 32)
    tx = math.ceil(ox / tiles_x)
    ty = max(1, min(oy, TILE_PIXELS // tx))
    while ty > 1 and ((ty - 1) * sy + ky) * ((tx - 1) * sx + kx) \
            * PIXEL_WORDS * 4 > HALO_BYTES:
        ty -= 1
    tiles_y = math.ceil(oy / ty)
    ty = math.ceil(oy / tiles_y)
    return GconvPlan(ty, tx, tiles_y, tiles_x, (ty - 1) * sy + ky,
                     (tx - 1) * sx + kx)


def _check(x, w, bias, groups, stride, pad):
    check_operand(x, "gconv x", 4, (torch.bfloat16,))
    check_operand(w, "gconv w", 4, (torch.bfloat16,))
    n, H, W, C = x.shape
    oc, ky, kx, cg = w.shape
    if not gconv_fits(C, oc, groups, ky * kx) or C // groups != cg:
        raise RtErr(f"gconv: x {tuple(x.shape)} and w {tuple(w.shape)} "
                    f"(OHWI) in {groups} groups: B8 takes groups of "
                    f"{GROUP_WIDTHS} channels in and out, C a multiple of "
                    f"{SLAB}, at most 3x3 taps")
    if bias is not None:
        check_operand(bias, "gconv bias", 1, (torch.float32,))
        if bias.shape[0] != oc:
            raise RtErr(f"gconv: a bias of {bias.shape[0]} for {oc} outputs")
    (sy, sx), (py, px) = stride, pad
    if min(sy, sx) < 1 or min(py, px) < 0:
        raise RtErr(f"gconv: stride {stride}, pad {pad}")
    oy, ox = (H + 2 * py - ky) // sy + 1, (W + 2 * px - kx) // sx + 1
    if min(n, oy, ox) < 1 or H + 2 * py < ky or W + 2 * px < kx:
        raise RtErr(f"gconv: empty output for x {tuple(x.shape)}, w "
                    f"{tuple(w.shape)}, stride {stride}, pad {pad}")
    if max(x.numel(), n * oy * ox * oc) >= 2 ** 31:
        raise RtErr("gconv: extent over int32")
    return n, H, W, C, oc, ky, kx, oy, ox


def gconv_plain(x, w, bias, groups, stride=(1, 1), pad=(0, 0),
                relu=False):
    """Plain PyTorch gconv: the vendor conv's arithmetic, the f32 conv in
    `groups` groups in full FP32 of the bf16 operands (channels_last, as
    the vendor path runs it), then the bias in f32, the ReLU and one
    rounding to bf16 (conv.vendor_store)."""
    from .conv import vendor_store
    _check(x, w, bias, groups, stride, pad)
    y = _conv_fwd(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2),
                  tuple(stride), tuple(pad), False, True, groups)
    if bias is not None:
        y = y + bias[None, :, None, None]
    return vendor_store(y, relu, torch.bfloat16, True)


def gconv(x, w, bias, groups, stride=(1, 1), pad=(0, 0), relu=False):
    """y[n,oy,ox,o] = bf16(relu?(f32(sum over the window and o's group of
    x * w[o]) + bias[o])), the sum over bf16 operands in f32.

    x: contiguous bf16 NHWC [n, H, W, C]; w: contiguous bf16 OHWI [oc, ky,
    kx, C / groups], output block j of oc / groups channels reading input
    block j alone (gconv_fits: equal widths of GROUP_WIDTHS, C a multiple
    of SLAB, at most 9 taps); bias: contiguous f32 [oc] or None; stride (sy, sx), pad (py,
    px). Returns a new bf16 NHWC [n, oy, ox, oc].

    On CUDA tensors one asynchronous launch on the current stream, counted
    in gconv.launches; CPU tensors take gconv_plain. The checks and the plan
    are worked out once per shape."""
    if not use_kernel(x, w, bias):
        return gconv_plain(x, w, bias, groups, stride, pad, relu)
    key = (x.shape, w.shape, groups, tuple(stride), tuple(pad),
           bias is None, x.dtype, w.dtype,
           None if bias is None else bias.dtype)
    ln = _LAUNCHES.get(key)
    if ln is None or not (x.is_contiguous() and w.is_contiguous() and (
            bias is None or bias.is_contiguous())):
        dims = _check(x, w, bias, groups, stride, pad)
        n, H, W, C, oc, ky, kx, oy, ox = dims
        plan = gconv_plan(oy, ox, ky, kx, tuple(stride))
        if len(_LAUNCHES) >= 4096:
            _LAUNCHES.clear()
        ln = _LAUNCHES[key] = ((n, oy, ox, oc), (n, H, W, C, oc, groups, ky,
                                                 kx) + tuple(stride)
                               + tuple(pad) + (plan.ty, plan.tx))
    shape, args = ln
    y = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    rc = load_kernels().boda_gconv(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), *args, int(relu), cuda_stream(x.device))
    check_launch(rc, "gconv")
    gconv.launches += 1
    return y


gconv.launches = 0
_LAUNCHES: dict = {}
