"""gconv (kernel B8): the grouped conv under prec=bf16 with NHWC storage,
on inference (the route ops/cuda/conv.conv_route gives).

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

What bounds B8 is its bytes (4.5 og flops a byte of input and output, far
under the card's ridge), so the kernel streams x in and y out and hides the
rest under that stream:
- persistence and the filter held: `gconv_plan` launches one or two blocks
  an SM, each pinned to a slab of 64 channels and walking that slab's tiles
  (image, tile row, tile column) in a static stride; a block loads its
  slab's filter once, into its warps' registers (from cg 32 up into shared
  memory, filter_smem), from `pack_filter`'s layout, which the conv step
  makes once per weight (conv.FilterCache);
- the ring: the producer warp keeps up to `MAX_STAGES` tile halos in
  flight, each one TMA load of x's NHWC tensor map that zero-fills the
  padding;
- ldmatrix without a tap table: the consumer warps read the staged halo by
  ldmatrix, each lane addressing its own pixel row at the tap, with the
  taps' offsets in registers and the k loop unrolled at compile time;
- the TMA store: each tile is staged in one of two buffers and stored by
  TMA, started by the producer warp, while the next tile is computed.

`gconv_plain` is the function in plain PyTorch, with the vendor conv's
arithmetic (ops/mxu_grad._conv_fwd in groups: full FP32 on the rounded
operands, channels_last, then conv.vendor_store), so a CPU tensor, which
takes it, gives what the vendor path gave. `gconv_plan` is the kernel's
plan: the tile (about TILE_PIXELS output pixels of one image, from a halo
of at most HALO_BYTES), the ring's depth, the blocks an SM holds and the
grid. `gconv_fits` says which convs the kernel has an instance for: groups
of equal width in and out (4, 8, 16, 32 or 64 channels), an input that
splits into whole slabs, and a filter of at most 3x3 taps.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ...core.error import RtErr
from ..mxu_grad import _conv_fwd
from .build import check_launch, load_kernels
from .util import check_operand, cuda_stream, sm_count, use_kernel

GROUP_WIDTHS = (4, 8, 16, 32, 64)
SLAB = 64           # input (and output) channels of a block
MAX_TAPS = 9
TILE_PIXELS = 128   # output pixels a tile aims at
# a pixel's slab in shared memory: 64 bf16, one row of TMA's 128-byte swizzle
PIXEL_BYTES = 2 * SLAB
HALO_BYTES = 24 * 1024  # the most a tile's input halo takes (a ring stage)
MAX_STAGES = 4      # halos in the ring
MIN_STAGES = 2
SM_SMEM = 233472    # shared memory of an SM, 1 KB of it kept for each block
BLOCK_SMEM = 232448  # the most one block may take (227 KB)
BLOCKS_PER_SM = 2   # what the kernel's registers allow (__launch_bounds__)


def gconv_fits(cin: int, cout: int, groups: int, taps: int) -> bool:
    """Whether B8 has an instance for a conv of cin inputs and cout outputs
    in `groups` groups with a filter of `taps` (ky * kx) taps: equal group
    widths in and out, one of GROUP_WIDTHS, cin a whole number of slabs,
    at most 9 taps."""
    if groups < 2 or cin % groups or cout % groups:
        return False
    cg = cin // groups
    return cout // groups == cg and cg in GROUP_WIDTHS \
        and cin % SLAB == 0 and taps <= MAX_TAPS


def unit_width(cg: int) -> int:
    """The channels of a unit, in and out: groups of 4 go in pairs, whose
    block-diagonal product is one GEMM of 8 outputs."""
    return max(cg, 8)


def filter_steps(cg: int) -> int:
    """The k16 steps of a unit's product over 9 taps: the packed filter's
    depth and the kernel's unrolled k loop (zero past a smaller filter)."""
    return math.ceil(MAX_TAPS * unit_width(cg) / 16)


def filter_smem(cg: int) -> int:
    """Shared memory of a slab's filter: none up to cg 16, whose consumer
    warps hold their columns' filter in registers (10 or 36 of them); from
    cg 32 up, where that would take 72 and keep an SM to one block, the
    slab's whole packed filter (csrc/gconv.cu Inst::kFilterBytes)."""
    return 0 if cg <= 16 else 8 * filter_steps(cg) * 32 * 8


def _kb(nbytes: int) -> int:
    return -(-nbytes // 1024) * 1024


@dataclass(frozen=True)
class GconvPlan:
    """A tile of ty x tx output pixels of one image (tiles_y x tiles_x of
    them cover the output) from an hy x hx box of the input (the halo,
    widened past the image where that keeps ldmatrix off bank conflicts);
    a ring of `stages` halos; per_sm blocks an SM; per_slab blocks for each
    of the `slabs` slabs, block b taking slab b % slabs and the tiles
    b // slabs, b // slabs + per_slab, ... of the slab's `tiles`; `smem`
    bytes of shared memory a block."""
    ty: int
    tx: int
    tiles_y: int
    tiles_x: int
    hy: int
    hx: int
    stages: int
    per_sm: int
    slabs: int
    tiles: int
    per_slab: int
    smem: int

    @property
    def grid(self) -> int:
        return self.slabs * self.per_slab

    def walk(self, block: int):
        """The (slab, image, tile row, tile column) block `block` computes,
        in its order (the kernel's producer and consumers walk the same)."""
        slab = block % self.slabs
        for t in range(block // self.slabs, self.tiles, self.per_slab):
            r, txi = divmod(t, self.tiles_x)
            img, tyi = divmod(r, self.tiles_y)
            yield slab, img, tyi, txi


def block_smem(hy: int, hx: int, ty: int, tx: int, stages: int,
               cg: int) -> int:
    """A block's shared memory, as csrc/gconv.cu lays it out: 1 KB to align
    it, the ring, the two staging tiles (each stage and tile on a 1 KB
    boundary, the swizzle's repeat), the slab's filter (filter_smem), the
    fragment rows' table and the ring's barriers."""
    pairs = math.ceil(ty * tx / 32)
    return 1024 + stages * _kb(hy * hx * PIXEL_BYTES) \
        + 2 * _kb(ty * tx * PIXEL_BYTES) + filter_smem(cg) + 128 * pairs \
        + 16 * stages


@functools.lru_cache(maxsize=1024)
def gconv_plan(n: int, oy: int, ox: int, C: int, cg: int, ky: int, kx: int,
               stride: tuple[int, int], sms: int) -> GconvPlan:
    """The plan of an oy x ox output of n images, C channels in groups of
    cg, a ky x kx filter, on a card of `sms` SMs.

    The tile: at most 32 columns wide (the output's width in equal parts,
    narrower where a stride would make the halo's row pass HALO_BYTES), as
    many rows as make about TILE_PIXELS pixels (in equal parts of oy), fewer
    where the halo would pass HALO_BYTES (a stride-2 conv reads four times
    the pixels). The box: the halo, at stride 1 across the whole width
    widened to tx modulo 8. Blocks an SM: BLOCKS_PER_SM, one where two
    would leave the ring under MIN_STAGES. The ring: as many halos as fit
    beside the staging and the filter, up to MAX_STAGES. The grid: each
    slab's blocks the most that stay resident at once (sms x per_sm over
    the slabs), no more than its tiles, and as few as take the same number
    of turns."""
    sy, sx = stride
    most_tx = max(1, (HALO_BYTES // PIXEL_BYTES // ky - kx) // sx + 1)
    tiles_x = math.ceil(ox / min(32, most_tx))
    tx = math.ceil(ox / tiles_x)
    ty = max(1, min(oy, TILE_PIXELS // tx))
    while ty > 1 and ((ty - 1) * sy + ky) * ((tx - 1) * sx + kx) \
            * PIXEL_BYTES > HALO_BYTES:
        ty -= 1
    tiles_y = math.ceil(oy / ty)
    ty = math.ceil(oy / tiles_y)
    hy, hx = (ty - 1) * sy + ky, (tx - 1) * sx + kx
    if sx == 1 and tiles_x == 1:
        # rows of the box as many as the tile's modulo 8, so that the 8 rows
        # of an ldmatrix that cross a tile row's end fall in other banks; the
        # extra columns lie past the image (zero fill, no reads)
        hx += (tx - hx) % 8
    fixed = block_smem(hy, hx, ty, tx, 0, cg)
    stage = _kb(hy * hx * PIXEL_BYTES) + 16  # and its two barriers
    per_sm = BLOCKS_PER_SM
    stages = 0
    while per_sm:
        room = min(BLOCK_SMEM, SM_SMEM // per_sm - 1024) - fixed
        stages = min(MAX_STAGES, room // stage)
        if stages >= MIN_STAGES or per_sm == 1:
            break
        per_sm -= 1
    slabs = C // SLAB
    tiles = n * tiles_y * tiles_x
    most = max(1, min(tiles, sms * per_sm // slabs))
    per_slab = math.ceil(tiles / math.ceil(tiles / most))
    return GconvPlan(ty, tx, tiles_y, tiles_x, hy, hx, stages, per_sm, slabs,
                     tiles, per_slab, block_smem(hy, hx, ty, tx, stages, cg))


def pack_filter(w: torch.Tensor, groups: int) -> torch.Tensor:
    """B8's filter of a bf16 OHWI filter [C, ky, kx, cg]: for each slab,
    n8 fragment of its 64 outputs, k16 step and lane, the mma B fragment
    that lane holds, as the kernel's warps load it into registers, bf16
    [C / 64, 8, filter_steps(cg), 32, 4].

    Output o's row of the unit GEMM runs over k = tap * cp + c, the unit's
    cp channels at each of 9 taps: its own group's cg channels carry w[o],
    the other group of a pair (cg = 4) and the taps past ky * kx zero. The
    lane g * 4 + q of fragment nf holds, of output 64 s + 8 nf + g, the k
    16 ks + 2q, +1 (b0) and 16 ks + 8 + 2q, +1 (b1). Plain PyTorch ops, so
    the CPU tests check it; made once per weight on the main path."""
    C, ky, kx, cg = w.shape
    cp, ks = unit_width(cg), filter_steps(cg)
    p, taps, kt = cp // cg, ky * kx, ks * 16 // cp
    dense = w.new_zeros(C // cp, p, cg, kt, p, cg)
    wg = w.reshape(C // cp, p, cg, taps, cg)
    for j in range(p):
        dense[:, j, :, :taps, j] = wg[:, j]
    k = dense.reshape(C // SLAB, 8, 8, ks, 2, 4, 2)  # slab nf g | ks half q e
    return k.permute(0, 1, 3, 2, 5, 4, 6).reshape(C // SLAB, 8, ks, 32, 4) \
        .contiguous()


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


def gconv(x, w, bias, groups, stride=(1, 1), pad=(0, 0), relu=False,
          wp=None):
    """y[n,oy,ox,o] = bf16(relu?(f32(sum over the window and o's group of
    x * w[o]) + bias[o])), the sum over bf16 operands in f32.

    x: contiguous bf16 NHWC [n, H, W, C]; w: contiguous bf16 OHWI [oc, ky,
    kx, C / groups], output block j of oc / groups channels reading input
    block j alone (gconv_fits: equal widths of GROUP_WIDTHS, C a multiple
    of SLAB, at most 9 taps); bias: contiguous f32 [oc] or None; stride
    (sy, sx), pad (py, px); wp: pack_filter(w, groups), which a caller that
    runs the same weights again keeps (the conv step does, once per
    weight), or None to pack it here. Returns a new bf16 NHWC [n, oy, ox,
    oc].

    On CUDA tensors one asynchronous launch on the current stream (and the
    packing's, where wp is None), counted in gconv.launches; CPU tensors
    take gconv_plain. The checks and the plan are worked out once per
    shape."""
    if not use_kernel(x, w, bias, wp):
        return gconv_plain(x, w, bias, groups, stride, pad, relu)
    key = (x.shape, w.shape, groups, tuple(stride), tuple(pad),
           bias is None, x.dtype, w.dtype, x.device,
           None if bias is None else bias.dtype)
    ln = _LAUNCHES.get(key)
    if ln is None or not (x.is_contiguous() and w.is_contiguous() and (
            bias is None or bias.is_contiguous())):
        dims = _check(x, w, bias, groups, stride, pad)
        n, H, W, C, oc, ky, kx, oy, ox = dims
        cg = C // groups
        p = gconv_plan(n, oy, ox, C, cg, ky, kx, tuple(stride),
                       sm_count(x.device.index))
        if len(_LAUNCHES) >= 4096:
            _LAUNCHES.clear()
        ln = _LAUNCHES[key] = (
            (n, oy, ox, oc), (C // SLAB, 8, filter_steps(cg), 32, 4),
            (n, H, W, C, groups, ky, kx) + tuple(stride) + tuple(pad)
            + (p.ty, p.tx, p.hx, p.stages, p.per_slab))
    shape, wp_shape, args = ln
    if wp is None:
        wp = pack_filter(w, groups)
    elif wp.shape != wp_shape or wp.dtype != torch.bfloat16 \
            or not wp.is_contiguous():
        raise RtErr(f"gconv: a packed filter {wp.dtype} "
                    f"{tuple(wp.shape)} for {tuple(w.shape)} in {groups} "
                    f"groups (pack_filter gives bf16 {wp_shape})")
    y = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    rc = load_kernels().boda_gconv(
        x.data_ptr(), wp.data_ptr(), None if bias is None else
        bias.data_ptr(), y.data_ptr(), *args, int(relu),
        cuda_stream(x.device))
    check_launch(rc, "gconv")
    gconv.launches += 1
    return y


gconv.launches = 0
_LAUNCHES: dict = {}
