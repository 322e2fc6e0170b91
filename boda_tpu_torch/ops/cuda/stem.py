"""fused_stem (kernel B4) and the `fused_stem` template.

Port of boda_tpu/ops/pallas/stem.py. `fused_stem` wraps the hand-written
CUDA kernel in csrc/stem.cu: conv + bias + ReLU + ceil-mode max-pool in one
launch, the conv activation kept in shared memory (see its header for what
bounds it). `fused_stem_plain` is the same function in plain PyTorch. The
wrapper checks its operands, then runs the plain version for CPU tensors
and the kernel for CUDA tensors. `stem_plan` picks the kernel's route (bf16
on the tensor cores, f32 on the FFMA tile), tile and grid from the shape
and the card's SM count; `stem_filter` is the layout in which the kernel
keeps the filter resident in shared memory (the plain version of the
reorder that the launch does first).

The Pallas version splits the input into 4x4 phase planes and pads lanes
so that Mosaic sees only contiguous slices (stem.py:107-152, :192-208);
the CUDA kernel indexes the strided input directly, so none of that is
ported.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...core.dims import Dims
from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import IN, OUT, adecl, template
from .build import check_launch, load_kernels
from .conv import _ConvBase
from .util import check_operand, compute_dtype, cuda_stream, full_fp32, \
    sm_count, storage_io, store_dtype, use_kernel


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


def pooled_extent(conv: int, kern: int, stride: int) -> int:
    """Ceil-mode pooled extent of a conv output extent (pool padding 0)."""
    return -(-(conv - kern) // stride) + 1


SMEM_MAX = 232448             # shared memory one block can use (227 KB)
SM_SMEM = 233472              # shared memory of an SM (228 KB), 1 KB a block
BLOCKS_PER_SM = 2             # csrc/stem.cu __launch_bounds__(256, 2)
OCB = 64                      # output channels per block
FFMA_STATIC = 2 * 8 * (128 + 4 + OCB + 4) * 4   # ffma_product's buffers
STEM_TYS = tuple(range(1, 9))  # pooled rows of a tile
STEM_TXS = (4, 8, 16)          # pooled cols of a tile
# Constants of the plan's time estimate, fitted to the smoke's `stem plan`
# sweep on an H100 SXM (PERF.md), in microseconds of one block alone on an
# SM. Tensor-core route: a wgmma k-step of a 64-row group with its four
# fragment loads. FFMA route: an 8-deep K chunk of a 128 x 64 tile. Both: a
# pooled output of 64 channels, a patch row copied (by input element bytes),
# a tile's barriers and index arithmetic. Two blocks on an SM run under each
# other's pool and copies: together SHARE_2 of their sum.
MMA_STEP_US = 0.021
FFMA_CHUNK_US = 0.65
POOL_US = 0.057
ROW_US = {2: 0.044, 4: 0.0875}
TILE_US = {"mma": 1.76, "ffma": 0.2}
SHARE_2 = 0.68


@dataclass(frozen=True)
class StemPlan:
    """How csrc/stem.cu runs one shape: its route ("mma": the conv on the
    tensor cores, bf16 only; "ffma": the CUDA cores) and, where bf16 could
    not take the tensor cores, why; the pooled rows and cols of a tile;
    whether the patch moves in 16-byte copies; the layout of the reordered
    filter (stem_filter: zeros before a filter row, K of a padded filter
    row, K of the whole); the dynamic plus static shared memory of a block,
    the blocks an SM holds, and the persistent blocks per 64 output
    channels."""
    route: str
    why: str
    ty: int
    tx: int
    vec: bool
    lead: int
    KR: int
    Kp: int
    smem: int
    per_sm: int
    blocks: int


def _ru(v: int, m: int) -> int:
    return -(-v // m) * m


def stem_route(C: int, sx: int, elem_bytes: int) -> tuple[str, str]:
    """(route, why): bf16 runs on the tensor cores where a conv position's K
    values start at a whole 4-byte word for every position (sx * C even);
    f32, and bf16 otherwise, on the FFMA route."""
    if elem_bytes != 2:
        return "ffma", ""
    if (sx * C) % 2:
        return "ffma", f"stride {sx} x {C} channels is odd: a position's " \
                       f"K values are not 4-byte aligned for wgmma's A"
    return "mma", ""


def filter_layout(route: str, C: int, ky: int, kx: int, px: int):
    """(lead, KR, Kp) of the reordered filter (stem_filter): K runs in (yy,
    xx, c) order. mma: each filter row's kx * C values follow `lead` zeros
    (1 where (px * C) is odd, so that the kernel's 4-byte fragment loads are
    aligned) and are padded to a multiple of 16, the whole to a multiple of
    64 (a 128-byte chunk). ffma: rows unpadded, the whole padded to 8."""
    if route == "mma":
        lead = (px * C) & 1
        KR = _ru(lead + kx * C, 16)
        return lead, KR, _ru(ky * KR, 64)
    return 0, kx * C, _ru(ky * kx * C, 8)


def stem_filter(w: torch.Tensor, lead: int, KR: int, Kp: int) -> torch.Tensor:
    """The OIHW filter as csrc/stem.cu reads it: [oc, Kp], row o holding
    w[o, c, yy, xx] at yy * KR + lead + xx * C + c and zeros elsewhere. The
    plain version of the kernel's own reorder (stem_filter_kernel, launched
    by boda_fused_stem before the stem kernel)."""
    oc, C, ky, kx = w.shape
    wk = w.new_zeros((oc, Kp))
    rows = wk[:, :ky * KR].view(oc, ky, KR)[:, :, lead:lead + kx * C]
    rows.unflatten(2, (kx, C)).copy_(w.permute(0, 2, 3, 1))
    return wk


def plan_candidate(n, H, W, C, oc, es, sms, kern, stride, pad, pool, os_,
                   ty, tx):
    """(estimated microseconds, plan) of one way to run the shape (a tile
    of ty x tx pooled outputs), or None where the tile does not fit a
    block's shared memory. The smoke's `stem plan` sweep times each
    candidate beside this estimate and holds the shared-memory sum (that of
    csrc/stem.cu configure) and the blocks per SM to the kernel's own."""
    (ky, kx), (sy, sx), (py, px) = kern, stride, pad
    (pky, pkx), (psy, psx) = pool
    cy, cx = (H + 2 * py - ky) // sy + 1, (W + 2 * px - kx) // sx + 1
    oy, ox = pooled_extent(cy, pky, psy), pooled_extent(cx, pkx, psx)
    route, why = stem_route(C, sx, es)
    lead, KR, Kp = filter_layout(route, C, ky, kx, px)
    cty, ctx = (ty - 1) * psy + pky, (tx - 1) * psx + pkx
    npos = cty * ctx
    pr, pc = (cty - 1) * sy + ky, (ctx - 1) * sx + kx
    ct_pitch = OCB * os_ + (32 if os_ == 4 else 16)
    if route == "mma":
        pitch = _ru(16 + ((ctx - 1) * sx * C + KR) * 2, 16)
        smem = 1024 + Kp * 128
        work_us = -(-(-(-npos // 64)) // 2) * ky * (KR // 16) * MMA_STEP_US
    else:
        pitch = _ru(16 + pc * C * es, 16)
        smem = OCB * Kp * es + Kp * 4 + FFMA_STATIC
        work_us = -(-npos // 128) * (Kp // 8) * FFMA_CHUNK_US
    smem += pr * pitch + npos * ct_pitch
    if smem > SMEM_MAX:
        return None
    per_sm = max(1, min(BLOCKS_PER_SM, SM_SMEM // (smem + 1024)))
    nocb = -(-oc // OCB)
    ntiles = n * -(-oy // ty) * -(-ox // tx)
    blocks = max(1, min(ntiles, sms * per_sm // nocb))
    tile_us = work_us + ty * tx * POOL_US + pr * ROW_US[es] + TILE_US[route]
    share = SHARE_2 if per_sm == 2 else 1.0
    est = -(-ntiles // blocks) * tile_us * per_sm * share
    vec = (W * C * es) % 16 == 0
    return est, StemPlan(route, why, ty, tx, vec, lead, KR, Kp, smem, per_sm,
                         blocks)


@functools.lru_cache(maxsize=None)
def _plan(n, H, W, C, oc, es, sms, kern, stride, pad, pool, os_) -> StemPlan:
    best = None
    for ty in STEM_TYS:
        for tx in STEM_TXS:
            cand = plan_candidate(n, H, W, C, oc, es, sms, kern, stride, pad,
                                  pool, os_, ty, tx)
            if cand is None:
                continue
            key = (cand[0], cand[1].smem)
            if best is None or key < best[0]:
                best = (key, cand[1])
    if best is None:
        raise RtErr(f"fused_stem: the patch and conv tile of a "
                    f"{pool[0][0]}x{pool[0][1]} pool window over a "
                    f"{kern[0]}x{kern[1]} conv of {C} channels do not fit a "
                    f"block's shared memory")
    return best[1]


def stem_plan(n, H, W, C, oc, elem_bytes, sms=None, kern=(7, 7),
              stride=(2, 2), pad=(3, 3), pool=((3, 3), (2, 2)),
              out_bytes=None) -> StemPlan:
    """The kernel's plan for x [n, H, W, C] and oc output channels in
    elements of `elem_bytes` (4: f32, 2: bf16; the output in `out_bytes`,
    default the same) on a card with `sms` SMs (default: the current CUDA
    device's).

    bf16 takes the tensor-core route where stem_route allows, anything else
    the FFMA route. Of the tiles (STEM_TYS x STEM_TXS pooled outputs) whose
    filter, patch and conv tile fit a block's shared memory, this picks the
    least estimated time (plan_candidate: the tiles each persistent block
    walks, times a tile's product over its conv positions padded to whole
    64-row groups or 128-row tiles, its pool, its patch rows and its
    barriers; two blocks on an SM overlap); ties go to the smaller
    block."""
    if sms is None:
        sms = sm_count(torch.cuda.current_device())
    return _plan(n, H, W, C, oc, elem_bytes, sms, tuple(kern), tuple(stride),
                 tuple(pad), (tuple(pool[0]), tuple(pool[1])),
                 out_bytes or elem_bytes)


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
    plan = stem_plan(n, H, W, C, oc, x.element_size(),
                     sm_count(x.device.index), (ky, kx), stride, pad, pool,
                     2 if out_dtype == torch.bfloat16 else 4)
    # room for the filter in the kernel's layout, which a first small launch
    # fills on every call (weights that do not change could be prepared once)
    wk = torch.empty((oc, plan.Kp), dtype=w.dtype, device=x.device)
    out = torch.empty((n, oy, ox, oc), dtype=out_dtype, device=x.device)
    rc = load_kernels().boda_fused_stem(
        x.data_ptr(), w.data_ptr(), wk.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        n, H, W, C, oc, ky, kx, stride[0], stride[1], pad[0], pad[1],
        pky, pkx, psy, psx, oy, ox, plan.ty, plan.tx,
        int(plan.route == "mma"),
        int(plan.vec and x.data_ptr() % 16 == 0), plan.Kp, plan.blocks,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(bool(relu)), cuda_stream(x.device))
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
