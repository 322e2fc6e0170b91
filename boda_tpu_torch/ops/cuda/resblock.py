"""resblock (kernel B5) and the `resblock` template.

Port of boda_tpu/ops/pallas/resblock.py. `resblock` wraps the hand-written
CUDA kernel in csrc/resblock.cu: the identity bottleneck (1x1 + ReLU, 3x3 +
ReLU, 1x1 + shortcut + ReLU) in one launch, with both intermediate
activations kept in shared memory (see its header for what bounds it).
`resblock_plain` is the same function in plain PyTorch. The wrapper checks
its operands, then runs the plain version for CPU tensors and the kernel
for CUDA tensors.

Both follow the roundings of the Pallas kernel body (resblock.py:98-135,
:163-177), not those of its `fallback` (:47-70): the biases are rounded to
the compute dtype like the weights, and h1 and h2 are stored in it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .build import check_launch, load_kernels
from .util import check_operand, compute_dtype, full_fp32, storage_io, \
    torch_dtype, use_kernel

H100_SMS = 132
SMEM_PER_SM = 228 * 1024      # shared memory of one SM, bytes
SMEM_RESERVED = 1024          # what the runtime reserves per block
TILE_ROWS = (64, 16)          # tile shapes of the core: 64 x 64, 16 x 256


def _tile_smem(bm: int) -> int:
    """Static shared memory of the tile core's K-chunk buffers (gemm_tile.cuh
    Tile<bm>::Smem: 16 x (bm + 4) + 16 x (4096 / bm + 4) floats)."""
    return 16 * ((bm + 4) + (4096 // bm + 4)) * 4


def resblock_plan(n, H, W, C, Cm, elem_bytes) -> dict:
    """The kernel's band rows `ty` and tile rows `bm` for one shape.

    A block holds h1 over (ty+2) x (W+2) pixels and h2 over ty x W pixels,
    Cm channels each, in dynamic shared memory (csrc/resblock.cu). Of the
    (ty, bm) pairs for which two blocks fit in one SM's shared memory (so
    that one block's loads overlap the other's FFMA) and the grid has a
    block for each of the 132 SMs (or one per image row, when the batch
    has fewer), this picks the one with the least tile work per SM: the
    work of one block, in 64*64-FMA tile steps, times the blocks each SM
    runs; ties go to the larger grid. A shape whose h1 and h2 do not fit
    twice even at ty = 1 runs one block per SM."""
    def cdiv(a, b):
        return -(-a // b)

    min_blocks = min(H100_SMS, n * H)
    best = None
    for per_sm in (2, 1):
        for bm in TILE_ROWS:
            bn = 4096 // bm
            for ty in range(1, H + 1):
                smem = ((ty + 2) * (W + 2) + ty * W) * Cm * elem_bytes
                if per_sm * (smem + _tile_smem(bm) + SMEM_RESERVED) \
                        > SMEM_PER_SM:
                    break
                blocks = n * cdiv(H, ty)
                if blocks < min_blocks:
                    break
                rows1, rows2 = (ty + 2) * (W + 2), ty * W
                work = (cdiv(rows1, bm) * cdiv(Cm, bn) * C
                        + cdiv(rows2, bm) * cdiv(Cm, bn) * 9 * Cm
                        + cdiv(rows2, bm) * cdiv(C, bn) * Cm)
                key = (cdiv(blocks, H100_SMS) * work, -blocks)
                if best is None or key < best[0]:
                    best = (key, dict(ty=ty, bm=bm, smem=smem, blocks=blocks))
        if best is not None:
            return best[1]
    raise RtErr(f"resblock: h1 and h2 of one band row (W={W}, Cm={Cm}) do not "
                f"fit in one SM's shared memory")


def _w1x1(w, name, out_c, in_c):
    """A 1x1 conv weight given as (out, in, 1, 1) or (out, in), as (out, in)."""
    check_operand(w, f"resblock {name}", 4 if w.dim() == 4 else 2)
    if w.dim() == 4 and tuple(w.shape[2:]) == (1, 1):
        w = w.view(w.shape[0], w.shape[1])
    if tuple(w.shape) != (out_c, in_c):
        raise RtErr(f"resblock: {name} is {tuple(w.shape)}, expected "
                    f"({out_c}, {in_c}) or ({out_c}, {in_c}, 1, 1)")
    return w


def _check(x, w1, b1, w2, b2, w3, b3, out_dtype):
    check_operand(x, "resblock x", 4)
    check_operand(w2, "resblock w2", 4)
    n, H, W, C = x.shape
    Cm = w2.shape[0]
    if tuple(w2.shape) != (Cm, Cm, 3, 3):
        raise RtErr(f"resblock: w2 is {tuple(w2.shape)}, expected "
                    f"({Cm}, {Cm}, 3, 3)")
    w1 = _w1x1(w1, "w1", Cm, C)
    w3 = _w1x1(w3, "w3", C, Cm)
    for name, b, length in (("b1", b1, Cm), ("b2", b2, Cm), ("b3", b3, C)):
        check_operand(b, f"resblock {name}", 1)
        if b.shape[0] != length:
            raise RtErr(f"resblock: {name} length {b.shape[0]} != {length}")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
                    ("w3", w3), ("b3", b3)):
        if t.dtype != x.dtype:
            raise RtErr(f"resblock: x is {x.dtype} but {name} is {t.dtype}")
    if min(n, H, W, C, Cm) < 1:
        raise RtErr(f"resblock: empty x {tuple(x.shape)} or Cm={Cm}")
    if max(x.numel(), w2.numel()) >= 2 ** 31:
        raise RtErr("resblock: extent over int32")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise RtErr(f"resblock: output dtype {out_dtype} not f32/bf16")
    return w1, w3


def resblock_plain(x, w1, b1, w2, b2, w3, b3, relu_out=True,
                   out_dtype=torch.float32):
    """Plain PyTorch resblock: three F.conv2d in full FP32 on the f32-cast
    operands, with the kernel's roundings (h1 and h2 stored in x's dtype);
    NHWC in and out."""
    Cm, C = w2.shape[0], x.shape[3]
    dt = x.dtype
    xf = x.permute(0, 3, 1, 2).float()

    def bias(b):
        return b.float()[None, :, None, None]
    with full_fp32():
        h = F.conv2d(xf, w1.float().reshape(Cm, C, 1, 1)) + bias(b1)
        h = torch.relu(h).to(dt).float()
        h = F.conv2d(h, w2.float(), padding=1) + bias(b2)
        h = torch.relu(h).to(dt).float()
        y = F.conv2d(h, w3.float().reshape(C, Cm, 1, 1)) + bias(b3) + xf
    if relu_out:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def resblock(x, w1, b1, w2, b2, w3, b3, relu_out=True,
             out_dtype=torch.float32):
    """The identity bottleneck on NHWC x [n, H, W, C]:
    h1 = relu(x . w1 + b1), h2 = relu(conv3x3_pad1(h1) + b2), both stored
    in x's dtype; y = relu?(h2 . w3 + b3 + x), accumulated in f32.

    x, w1 [Cm, C] (or [Cm, C, 1, 1]), b1 [Cm], w2 OIHW [Cm, Cm, 3, 3], b2
    [Cm], w3 [C, Cm] (or [C, Cm, 1, 1]) and b3 [C]: contiguous, all f32 or
    all bf16. Returns a new NHWC tensor of out_dtype (f32 or bf16).

    On CUDA tensors the launch is asynchronous on the current stream; an
    input freed after the call is reused only in that stream's order by
    torch's caching allocator, so no synchronisation is needed."""
    w1, w3 = _check(x, w1, b1, w2, b2, w3, b3, out_dtype)
    if not use_kernel(x, w1, b1, w2, b2, w3, b3):
        return resblock_plain(x, w1, b1, w2, b2, w3, b3, relu_out, out_dtype)
    n, H, W, C = x.shape
    Cm = w2.shape[0]
    plan = resblock_plan(n, H, W, C, Cm, x.element_size())
    out = torch.empty_like(x, dtype=out_dtype)
    # the kernel reads the 3x3 filter with its input channels innermost
    # (OHWI), so that its K runs are contiguous: a copy of up to 9.4 MB
    w2 = w2.permute(0, 2, 3, 1).contiguous()
    rc = load_kernels().boda_resblock(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        n, H, W, C, Cm, plan["ty"], plan["bm"],
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(bool(relu_out)), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(rc, "resblock")
    resblock.launches += 1
    return out


resblock.launches = 0


@template
class ResBlock(KernelTemplate):
    """The fused identity bottleneck on kernel B5 (JAX: Pallas resblock)."""

    name = "resblock"
    nhwc_ok = True
    args = [adecl("in", IN, "img chan y x"),
            adecl("w1", IN, "out_chan in_chan y x"),
            adecl("b1", IN, "out_chan"),
            adecl("w2", IN, "out_chan in_chan y x"),
            adecl("b2", IN, "out_chan"),
            adecl("w3", IN, "out_chan in_chan y x"),
            adecl("b3", IN, "out_chan"),
            adecl("out", OUT, "img chan y x")]
    sig_str_keys = ["prec"]
    sig_nda_keys = ["relu_out"]

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        xd = rfs.get_dims("in")
        Cm = rfs.get_dims("w2")["out_chan"]
        C = xd["chan"]
        return 2 * xd["img"] * xd["y"] * xd["x"] * (C * Cm + 9 * Cm * Cm + Cm * C)

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, w1, b1, w2, b2, w3, b3):
        from .conv import Conv, make_conv_op
        relu_out = rfs.get_u32_or("relu_out", 1) == 1

        def conv_ref(v, w, b, relu, pad):
            n_, c_, h_, w_sz = v.shape
            k = w.shape[2]
            op = make_conv_op(n_, c_, h_, w_sz, w.shape[0], k, k, py=pad,
                              px=pad, relu=relu)
            return Conv.ref_impl(Conv.check_args(op), v, w, b)

        h = conv_ref(np.asarray(x), np.asarray(w1), np.asarray(b1), True, 0)
        h = conv_ref(h, np.asarray(w2), np.asarray(b2), True, 1)
        y = conv_ref(h, np.asarray(w3), np.asarray(b3), False, 0)
        y = y + np.asarray(x, y.dtype)
        if relu_out:
            y = np.maximum(y, 0)
        return y.astype(np.asarray(x).dtype)

    @classmethod
    def build(cls, rfs: OpBase):
        relu_out = rfs.get_u32_or("relu_out", 1) == 1
        cdt = compute_dtype(rfs)
        io_nhwc, edt = storage_io(rfs)
        xdt = torch_dtype(rfs.get_dims("in").dtype)
        odt = (edt or xdt) if io_nhwc else xdt

        def fn(x, w1, b1, w2, b2, w3, b3):
            xh = x.to(cdt)
            if not io_nhwc:
                xh = xh.permute(0, 2, 3, 1)
            # the Pallas kernel rounds the biases to the compute dtype too
            # (resblock.py:171-177)
            ops = [t.to(cdt).contiguous() for t in (w1, b1, w2, b2, w3, b3)]
            y = resblock(xh.contiguous(), *ops, relu_out, odt)
            return y if io_nhwc else y.permute(0, 3, 1, 2).contiguous()
        return fn
