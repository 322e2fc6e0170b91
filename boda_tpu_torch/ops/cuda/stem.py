"""fused_stem (kernel B4) and the `fused_stem` template.

Port of boda_tpu/ops/pallas/stem.py. `fused_stem` wraps the hand-written
CUDA kernel in csrc/stem.cu: conv + bias + ReLU + ceil-mode max-pool in one
launch, the conv activation kept in shared memory (see its header for what
bounds it). `fused_stem_plain` is the same function in plain PyTorch. The
wrapper checks its operands, then runs the plain version for CPU tensors
and the kernel for CUDA tensors.

The Pallas version splits the input into 4x4 phase planes and pads lanes
so that Mosaic sees only contiguous slices (stem.py:107-152, :192-208);
the CUDA kernel indexes the strided input directly, so none of that is
ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.dims import Dims
from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import IN, OUT, adecl, template
from .build import check_launch, load_kernels
from .conv import _ConvBase
from .util import check_operand, compute_dtype, full_fp32, storage_io, \
    store_dtype, use_kernel


def _stem_params(rfs: OpBase):
    ind = rfs.get_dims("in")
    outd = rfs.get_dims("out")
    fd = rfs.get_dims("filts")
    st = rfs.get_dims_or_none("stride")
    pad = rfs.get_dims_or_none("in_pad")
    pk = rfs.get_dims("pool_kern")
    ps = rfs.get_dims("pool_stride")
    pp = rfs.get_dims_or_none("pool_pad")
    return (ind, outd, fd,
            (st["y"], st["x"]) if st else (1, 1),
            (pad["y"], pad["x"]) if pad else (0, 0),
            (pk["y"], pk["x"]), (ps["y"], ps["x"]),
            (pp["y"], pp["x"]) if pp else (0, 0))


def make_stem_op(n: int, cin: int, h: int, w: int, cout: int,
                 k: int = 7, s: int = 2, p: int = 3,
                 pool_k: int = 3, pool_s: int = 2,
                 bias: bool = True) -> OpBase:
    """The fused_stem op sig of a k x k / s conv (pad p, ReLU) and a
    ceil-mode pool_k / pool_s max pool (boda_tpu/ops/pallas/stem.py:277)."""
    cy = (h + 2 * p - k) // s + 1
    cx = (w + 2 * p - k) // s + 1
    oy = -(-(cy - pool_k) // pool_s) + 1
    ox = -(-(cx - pool_k) // pool_s) + 1
    op = OpBase({"type": "fused_stem", "func_name": "fused_stem"})
    op.set_dims("in", Dims.make(img=n, chan=cin, y=h, x=w))
    op.set_dims("filts", Dims.make(out_chan=cout, in_chan=cin, y=k, x=k))
    if bias:
        op.set_dims("biases", Dims.make(out_chan=cout))
    op.set_dims("out", Dims.make(img=n, chan=cout, y=oy, x=ox))
    op.set_null_dims("in_pad", y=p, x=p)
    op.set_null_dims("stride", y=s, x=s)
    op.set_null_dims("kern_sz", y=k, x=k)
    op.set_null_dims("pool_kern", y=pool_k, x=pool_k)
    op.set_null_dims("pool_stride", y=pool_s, x=pool_s)
    op.set_null_dims("pool_pad", y=0, x=0)
    op.set_u32("conv_has_relu", 1)
    return op


# conv positions a block of the kernel computes at most (csrc/stem.cu kMaxPos)
MAX_CONV_TILE = 160


def pooled_extent(conv: int, kern: int, stride: int) -> int:
    """Ceil-mode pooled extent of a conv output extent (pool padding 0)."""
    return -(-(conv - kern) // stride) + 1


def stem_tile(pool_kern, pool_stride) -> tuple[int, int]:
    """Pooled rows x cols per block: 4 x 8 (a 9 x 17 conv tile under a
    3x3/s2 pool), halved, cols first, until the conv tile that the pool
    windows cover fits the kernel's MAX_CONV_TILE positions."""
    (pky, pkx), (psy, psx) = pool_kern, pool_stride
    ty, tx = 4, 8
    while ((ty - 1) * psy + pky) * ((tx - 1) * psx + pkx) > MAX_CONV_TILE:
        if tx == ty == 1:
            raise RtErr(f"fused_stem: a {pky}x{pkx} pool window covers more "
                        f"than {MAX_CONV_TILE} conv positions")
        if tx > 1:
            tx //= 2
        else:
            ty //= 2
    return ty, tx


def _check(x, w, bias, stride, pad, pool, out_dtype):
    check_operand(x, "fused_stem x", 4)
    check_operand(w, "fused_stem w", 4)
    if w.dtype != x.dtype:
        raise RtErr(f"fused_stem: x is {x.dtype} but w is {w.dtype}")
    n, H, W, C = x.shape
    oc, wc, ky, kx = w.shape
    if wc != C:
        raise RtErr(f"fused_stem: x has {C} channels, w {tuple(w.shape)} "
                    f"has {wc}")
    (sy, sx), (py, px) = stride, pad
    (pky, pkx), (psy, psx) = pool
    if min(sy, sx, pky, pkx, psy, psx) < 1 or min(py, px) < 0:
        raise RtErr(f"fused_stem: bad stride {stride}, pad {pad} or pool "
                    f"{pool}")
    if psy > pky or psx > pkx:
        raise RtErr(f"fused_stem: pool stride {pool[1]} over its window "
                    f"{pool[0]} leaves ceil-mode windows empty")
    cy, cx = (H + 2 * py - ky) // sy + 1, (W + 2 * px - kx) // sx + 1
    if min(n, C, oc) < 1 or cy < pky or cx < pkx:
        raise RtErr(f"fused_stem: empty output for x {tuple(x.shape)}, "
                    f"w {tuple(w.shape)}, pad {pad}, pool {pool}")
    oy, ox = pooled_extent(cy, pky, psy), pooled_extent(cx, pkx, psx)
    if max(x.numel(), w.numel(), n * oy * ox * oc) >= 2 ** 31:
        raise RtErr("fused_stem: extent over int32")
    if bias is not None:
        check_operand(bias, "fused_stem bias", 1, (torch.float32,))
        if bias.shape[0] != oc:
            raise RtErr(f"fused_stem: bias length {bias.shape[0]} != oc={oc}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise RtErr(f"fused_stem: output dtype {out_dtype} not f32/bf16")
    return n, H, W, C, oc, ky, kx, oy, ox


def fused_stem_plain(x, w, bias=None, pad=(3, 3), pool=((3, 3), (2, 2)),
                     relu=True, out_dtype=torch.float32, stride=(2, 2)):
    """Plain PyTorch fused_stem: F.conv2d of the f32-cast operands in full
    FP32, + bias in f32, ReLU, ceil-mode max-pool, one cast; NHWC in and
    out."""
    with full_fp32():
        y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), stride=stride,
                     padding=pad)
    if bias is not None:
        y = y + bias[None, :, None, None]
    if relu:
        y = torch.relu(y)
    y = F.max_pool2d(y, pool[0], pool[1], ceil_mode=True)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def fused_stem(x, w, bias=None, pad=(3, 3), pool=((3, 3), (2, 2)),
               relu=True, out_dtype=torch.float32, stride=(2, 2)):
    """out[n,j,i,oc] = max over the ceil-mode pool window (pool = (kernel,
    stride), padding 0) of relu?(conv(x, w, stride, pad) + bias[oc]), the
    conv accumulated in f32.

    x: contiguous NHWC; w: contiguous OIHW of x's dtype (f32 or bf16);
    bias: contiguous f32 [oc] or None. Returns a new NHWC tensor of
    out_dtype (f32 or bf16).

    On CUDA tensors the launch is asynchronous on the current stream; an
    input freed after the call is reused only in that stream's order by
    torch's caching allocator, so no synchronisation is needed."""
    n, H, W, C, oc, ky, kx, oy, ox = _check(x, w, bias, stride, pad, pool,
                                            out_dtype)
    if not use_kernel(x, w, bias):
        return fused_stem_plain(x, w, bias, pad, pool, relu, out_dtype,
                                stride)
    (pky, pkx), (psy, psx) = pool
    ty, tx = stem_tile(*pool)
    out = torch.empty((n, oy, ox, oc), dtype=out_dtype, device=x.device)
    rc = load_kernels().boda_fused_stem(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        n, H, W, C, oc, ky, kx, stride[0], stride[1], pad[0], pad[1],
        pky, pkx, psy, psx, oy, ox, ty, tx,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(bool(relu)), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(rc, "fused_stem")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0


@template
class FusedStem(_ConvBase):
    """conv + bias + ReLU + max-pool on kernel B4 (JAX: Pallas fused_stem)."""

    name = "fused_stem"
    args = [adecl("in", IN, "img chan y x"),
            adecl("filts", IN, "out_chan in_chan y x"),
            adecl("biases", IN, "out_chan", opt=True),
            adecl("out", OUT, "img chan y x")]
    sig_nda_keys = ["in_pad", "stride", "kern_sz", "conv_has_relu",
                    "pool_kern", "pool_stride", "pool_pad"]
    sig_str_keys = ["prec", "layout"]

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        ind, _outd, fd, (sy, sx), (py, px), _pk, _ps, _pp = _stem_params(rfs)
        cy = (ind["y"] + 2 * py - fd["y"]) // sy + 1
        cx = (ind["x"] + 2 * px - fd["x"]) // sx + 1
        return 2 * ind["img"] * cy * cx * fd["out_chan"] * \
            fd["in_chan"] * fd["y"] * fd["x"]

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, w, b=None):
        from .pool import Pool
        ind, outd, fd, (sy, sx), (py, px), (pky, pkx), (psy, psx), \
            (ppy, ppx) = _stem_params(rfs)
        cy = (ind["y"] + 2 * py - fd["y"]) // sy + 1
        cx = (ind["x"] + 2 * px - fd["x"]) // sx + 1
        crfs = rfs.copy()
        crfs.set_dims("out", Dims.make(tn=outd.tn, img=ind["img"],
                                       chan=fd["out_chan"], y=cy, x=cx))
        conv = _ConvBase.ref_impl(crfs, x, w, b)  # includes bias+relu
        prfs = OpBase({"type": "Pooling"})
        prfs.set_dims("in", Dims.make(tn=outd.tn, img=ind["img"],
                                      chan=fd["out_chan"], y=cy, x=cx))
        prfs.set_dims("out", outd)
        prfs.set_null_dims("kern_sz", y=pky, x=pkx)
        prfs.set_null_dims("stride", y=psy, x=psx)
        prfs.set_null_dims("in_pad", y=ppy, x=ppx)
        return Pool.ref_impl(prfs, conv)

    @classmethod
    def build(cls, rfs: OpBase):
        ind, outd, fd, stride, pad, pk, ps, pp = _stem_params(rfs)
        # the Pallas kernel's own preconditions (stem.py:64-65,75)
        if pp != (0, 0):
            raise RtErr(f"fused_stem: pool pad 0 only, got {pp}")
        if rfs.get_u32_or("conv_has_relu", 0) != 1:
            raise RtErr("fused_stem folds ReLU; conv_has_relu must be 1")
        cy = (ind["y"] + 2 * pad[0] - fd["y"]) // stride[0] + 1
        cx = (ind["x"] + 2 * pad[1] - fd["x"]) // stride[1] + 1
        pooled = (pooled_extent(cy, pk[0], ps[0]), pooled_extent(cx, pk[1], ps[1]))
        if pooled != (outd["y"], outd["x"]):
            raise RtErr(f"fused_stem: out dims {outd} != the ceil-mode pool "
                        f"of a {cy}x{cx} conv: {pooled}")
        io_nhwc, _ = storage_io(rfs)
        cdt, odt = compute_dtype(rfs), store_dtype(rfs)

        def fn(x, w, b=None):
            xh = x.to(cdt)
            if not io_nhwc:
                xh = xh.permute(0, 2, 3, 1)
            # the Pallas kernel adds the bias in f32, unrounded (stem.py:174)
            bias = None if b is None else b.float().contiguous()
            y = fused_stem(xh.contiguous(), w.to(cdt).contiguous(), bias, pad,
                           (pk, ps), True, odt, stride)
            return y if io_nhwc else y.permute(0, 3, 1, 2).contiguous()
        return fn
