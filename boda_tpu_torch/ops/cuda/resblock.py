"""resblock (kernel B5) and the `resblock` template.

Port of boda_tpu/ops/pallas/resblock.py. `resblock` wraps the hand-written
CUDA kernel in csrc/resblock.cu: the identity bottleneck (1x1 + ReLU, 3x3 +
ReLU, 1x1 + shortcut + ReLU) in one launch, with both intermediate
activations kept in shared memory (see its header for what bounds it).
`resblock_plain` is the same function in plain PyTorch. The wrapper checks
its operands, then runs the plain version for CPU tensors and the kernel
for CUDA tensors. `resblock_plan` picks the kernel's route, band, cluster
and tile from the shape and the card's SM count.

Both follow the roundings of the Pallas kernel body (resblock.py:98-135,
:163-177), not those of its `fallback` (:47-70): the biases are rounded to
the compute dtype like the weights, and h1 and h2 are stored in it. Both
take the 3x3 filter in OHWI order, [Cm, 3, 3, Cm], as tconv does.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .build import check_launch, load_kernels
from .util import check_operand, compute_dtype, cuda_stream, full_fp32, \
    sm_count, storage_io, torch_dtype, use_kernel

SMEM_MAX = 232448             # shared memory one block can use (227 KB)
CLUSTERS = (1, 2, 4, 8)       # blocks that may share one image band
RING_STAGES = 3               # csrc/hopper_gemm.cuh kStages
# Constants of the plan's time estimate, read off the smoke's `resblock
# plan` sweep on an H100 SXM (PERF.md), per SM and microsecond. Tensor-core
# route: a step of the ring (one 64-value K chunk of one tile) costs STEP_US
# whatever it moves, or the bytes it stages from L2 over L2_RATE, or its
# multiply-adds over MMA_RATE; a tile costs TILE_US more (its epilogue).
# FFMA route: multiply-adds of the 128- and 64-wide tile; two blocks on one
# SM hide each other's load latency (TWO_PER_SM: their joint rate over one
# block's). An element stored into another block of the cluster costs
# REMOTE_US.
STEP_US = 0.45
L2_RATE = 5.0e4
MMA_RATE = 1.7e6
FFMA_RATE = {128: 1.0e5, 64: 0.8e5}
TWO_PER_SM = 1.35
TILE_US = {"mma": 1.5, "ffma": 2.0}
REMOTE_US = 2.0e-4


@dataclass(frozen=True)
class ResblockPlan:
    """How csrc/resblock.cu runs one shape: its route ("mma": bf16 on the
    tensor cores; "ffma": the CUDA cores), the output rows `ty` of an image
    band, the `cluster` of blocks that share a band and split each phase's
    output channels, the block tile (tile_m rows of pixels by tile_n
    channels), whether the FFMA route loads four elements at once, the
    dynamic shared memory of a block and the blocks of the grid."""
    route: str
    ty: int
    cluster: int
    tile_m: int
    tile_n: int
    vec: bool
    smem: int
    blocks: int


def ffma_static_smem(tile_n: int) -> int:
    """Static shared memory of the core's FFMA staging buffers
    (hopper_gemm.cuh ffma_product: 2 x 8 x (128 + 4 + tile_n + 4) floats)."""
    return 2 * 8 * (128 + 4 + tile_n + 4) * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _clusters_at_once(sms: int, per_sm: int, cs: int) -> int:
    """Clusters of cs blocks the card holds at once: clusters of 4 or 8 do
    not span its GPCs, which costs about a tenth of the SMs (an H100 SXM
    holds 66, 30 and 15 clusters of 2, 4 and 8 one-per-SM blocks)."""
    slots = (sms * per_sm) // cs
    return max(1, slots if cs <= 2 else slots * 9 // 10)


def plan_route(C, Cm, es) -> tuple[str, bool]:
    """(route, vec) of a shape: bf16 with channels in whole 64-value K
    chunks runs on the tensor cores ("mma"), anything else on the CUDA cores
    ("ffma"), f32 with 16-byte loads where the channels allow."""
    if es == 2 and C % 64 == 0 and Cm % 64 == 0:
        return "mma", False
    return "ffma", es == 4 and C % 4 == 0 and Cm % 4 == 0


def plan_candidate(n, H, W, C, Cm, es, sms, ty, cs, tile_m, tile_n):
    """(estimated microseconds, plan) of one way to run the shape (band rows
    ty, cluster cs, block tile), or None where its h1 and h2 do not fit a
    block's shared memory. The smoke's `resblock plan` sweep times each
    candidate beside this estimate."""
    route, vec = plan_route(C, Cm, es)
    rows1, rows2 = (ty + 2) * (W + 2), ty * W
    t1, t2 = _cdiv(rows1, tile_m), _cdiv(rows2, tile_m)     # row tiles
    tn_m, tn_c = _cdiv(Cm // cs, tile_n), _cdiv(C // cs, tile_n)
    tiles = t1 * tn_m + t2 * (tn_m + tn_c)
    if route == "mma":
        smem = 1024 + RING_STAGES * (tile_m + tile_n) * 128 \
            + (Cm // 64) * (rows1 + t2 * tile_m) * 128
        static, per_sm = 0, 1
        b_rows = min(tile_n, Cm // cs)   # rows of a weight tile that exist

        def steps(count, rows):          # `count` ring steps staging `rows`
            return count * max(STEP_US, rows * 128 / L2_RATE,
                               tile_m * tile_n * 64 / MMA_RATE)
        work_us = steps(t1 * tn_m * (C // 64), tile_m + b_rows) \
            + steps(t2 * tn_m * (9 * Cm // 64), b_rows) \
            + steps(t2 * tn_c * (Cm // 64), min(tile_n, C // cs))
    else:
        smem = (rows1 + rows2) * Cm * es
        static = ffma_static_smem(tile_n)
        per_sm = 2 if 2 * (smem + static + 1024) <= 228 * 1024 else 1

        def eff(rows):   # a warp owns 8 rows of each half of a 128-row tile
            full, tail = divmod(rows, 128)
            return full * 128 + min(128, 16 * _cdiv(min(tail, 64), 8))
        macs = eff(rows1) * tn_m * tile_n * C \
            + eff(rows2) * (tn_m * 9 * Cm + tn_c * Cm) * tile_n
        work_us = macs / (FFMA_RATE[tile_n]
                          * (TWO_PER_SM / 2 if per_sm == 2 else 1))
    if smem + static > SMEM_MAX:
        return None
    remote = (cs - 1) * (rows1 + rows2) * (Cm // cs)
    block_us = work_us + tiles * TILE_US[route] + remote * REMOTE_US
    bands = n * _cdiv(H, ty)
    waves = _cdiv(bands, _clusters_at_once(sms, per_sm, cs))
    plan = ResblockPlan(route, ty, cs, tile_m, tile_n, vec, smem, bands * cs)
    return waves * block_us, plan


def plan_tiles(C, Cm, es, cs) -> list[tuple[int, int]]:
    """The block tiles (rows, channels) the kernel has for a shape and a
    cluster size: on the tensor cores 128 x 128 or 64 x 128 (128 x 64 where
    Cm is 64), on the CUDA cores 128 rows by 128 or 64 channels."""
    if plan_route(C, Cm, es)[0] == "mma":
        return [(128, 128), (64, 128)] if Cm >= 128 else [(128, 64)]
    return [(128, 128 if Cm // cs > 64 else 64)]


@functools.lru_cache(maxsize=None)
def _plan(n, H, W, C, Cm, es, sms) -> ResblockPlan:
    mma = plan_route(C, Cm, es)[0] == "mma"
    best = None
    for cs in CLUSTERS:
        if C % cs or Cm % cs or (mma and (Cm // cs) % 2):
            continue
        for tile_m, tile_n in plan_tiles(C, Cm, es, cs):
            for ty in range(1, H + 1):
                cand = plan_candidate(n, H, W, C, Cm, es, sms, ty, cs,
                                      tile_m, tile_n)
                if cand is None:
                    break
                key = (cand[0], -cand[1].blocks)
                if best is None or key < best[0]:
                    best = (key, cand[1])
    if best is None:
        raise RtErr(f"resblock: h1 and h2 of one band row (W={W}, Cm={Cm}) do "
                    f"not fit in a block's shared memory")
    return best[1]


def resblock_plan(n, H, W, C, Cm, elem_bytes, sms=None) -> ResblockPlan:
    """The kernel's plan for x [n, H, W, C] with Cm bottleneck channels in
    elements of `elem_bytes` (4: f32, 2: bf16) on a card with `sms` SMs
    (default: the current CUDA device's).

    bf16 with C and Cm multiples of 64 takes the tensor-core route, anything
    else the FFMA route (16-byte loads in f32 where C and Cm are multiples
    of 4, else element staging). A cluster of `cluster` blocks holds h1 over
    (ty+2) x (W+2) pixels and h2 over ty x W pixels of one image band in
    each block's shared memory and splits the output channels of every
    phase. Of the (ty, cluster, tile) whose h1 and h2 fit beside the route's
    staging buffers, this picks the least estimated time: the waves of
    clusters over the card times one block's time (plan_candidate: its ring
    steps or its multiply-adds, with the pixels padded to whole tiles and
    phase 1 over the haloed band, plus a cost per tile and per element
    stored into the cluster's other blocks); ties go to the larger grid."""
    if sms is None:
        sms = sm_count(torch.cuda.current_device())
    return _plan(n, H, W, C, Cm, elem_bytes, sms)


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
    if tuple(w2.shape) != (Cm, 3, 3, Cm):
        raise RtErr(f"resblock: w2 is {tuple(w2.shape)}, expected OHWI "
                    f"({Cm}, 3, 3, {Cm})")
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
    NHWC in and out, w2 in OHWI order."""
    Cm, C = w2.shape[0], x.shape[3]
    dt = x.dtype
    xf = x.permute(0, 3, 1, 2).float()

    def bias(b):
        return b.float()[None, :, None, None]
    with full_fp32():
        h = F.conv2d(xf, w1.float().reshape(Cm, C, 1, 1)) + bias(b1)
        h = torch.relu(h).to(dt).float()
        h = F.conv2d(h, w2.float().permute(0, 3, 1, 2), padding=1) + bias(b2)
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

    x, w1 [Cm, C] (or [Cm, C, 1, 1]), b1 [Cm], w2 OHWI [Cm, 3, 3, Cm], b2
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
    plan = resblock_plan(n, H, W, C, Cm, x.element_size(),
                         sm_count(x.device.index))
    out = torch.empty_like(x, dtype=out_dtype)
    rc = load_kernels().boda_resblock(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        n, H, W, C, Cm, plan.ty, plan.cluster, int(plan.route == "mma"),
        plan.tile_m, plan.tile_n, int(plan.vec),
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(bool(relu_out)), cuda_stream(x.device))
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
            # (resblock.py:171-177); the kernel reads the 3x3 filter with
            # its input channels innermost (OHWI): a copy of up to 9.4 MB
            # per step
            ops = [t.to(cdt).contiguous() for t in
                   (w1, b1, w2.permute(0, 2, 3, 1), b2, w3, b3)]
            y = resblock(xh.contiguous(), *ops, relu_out, odt)
            return y if io_nhwc else y.permute(0, 3, 1, 2).contiguous()
        return fn
