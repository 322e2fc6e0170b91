"""bconv (kernel B7), the bf16 form of the vendor conv: xla_conv, xla_conv2
and s2d_conv under prec=bf16 with NHWC storage, on inference.

Replaces no TPU kernel. In the JAX package these steps are XLA convs on bf16
operands with an f32 result (boda_tpu/ops/pallas/conv.py XlaConv.build
:206-233, conv2.py XlaConv2), and torch has no conv of that function on
CUDA: its bf16 conv rounds the sum before the bias (ops/cuda/conv.
vendor_conv says why that misses the gate). B7 computes it on the card as
an implicit GEMM on bf16 `wgmma` with f32 sums, the bias, ReLU and store
fused into its epilogue (csrc/bconv.cu, on B6's ring, csrc/conv_ring.cuh;
its header gives what bounds it and what the design does about that):

    y[n,oy,ox,o] = store(relu?(f32(sum x[n,..,c] * w[o,..,c]) + bias[o]))

with store = f32, bf16 (round to nearest even), or an int8 edge at
clamp(rint(v * float32(127 / out_absmax)), -127, 127). One launch computes
every member of a sibling group (xla_conv2), their filters concatenated on
out_chan, and writes each member's columns into its own NHWC output with its
own bias, ReLU and stored dtype; a second launch adds split-K partial sums
in a fixed order where the plan splits K.

`bconv_plain` is the function in plain PyTorch, with the vendor conv's
arithmetic exactly (ops/mxu_grad._conv_fwd: full FP32 on the rounded
operands, channels_last, then conv.vendor_store per member), so a CPU
tensor, which takes it, gives what the vendor path gave. `bconv_plan` is the
kernel's plan: the N tile width from oc (64 where the whole N fits one
64-wide tile, else 128), split-K and the grid on util.gemm_plan and
qconv.ring_walk as B6's, the copy widths from C and K. `FilterCache` holds a
conv step's filter in its kernel's form (ops/cuda/conv.conv_step) once per
set of weight tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...core.error import RtErr
from ..mxu_grad import _conv_fwd
from .build import check_launch, load_kernels
from .qconv import out_q_scale, ring_walk
from .util import GEMM_TILE_M, check_operand, copy_width, cuda_stream, \
    gemm_plan, sm_count, use_kernel

# split-K as util.gemm_plan reads it (below, least, fill, min_chunks), the
# rule B6's plan measured (qconv.SPLIT), K in chunks of 64 bf16 values
SPLIT = {torch.bfloat16: (1, 2, 1, 4)}
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
COPY_WIDTHS = (16, 8, 4, 2)   # bytes; 2: element by element
MAX_MEMBERS = 4


@dataclass(frozen=True)
class Member:
    """One conv of a B7 launch or of a conv step: its oc output channels
    (the next oc rows of the concatenated filter), its ReLU, its stored
    dtype (f32, bf16, or int8 stored at out_absmax), and the (y, x) zero
    taps that center-embed its filter in a sibling group's larger kernel
    (ops/cuda/conv.conv_step; B7 takes the filter embedded)."""
    oc: int
    relu: bool = False
    dtype: torch.dtype = torch.bfloat16
    out_absmax: float = 0.0
    embed: tuple[int, int] = (0, 0)


@dataclass(frozen=True)
class BconvPlan:
    """How B7 runs one conv: 128 x tile_n output tiles ("blocks" of them)
    over `chunks` K chunks of 64 bf16 values, the first `full` whole and the
    rest in `splits` K ranges each (splits 1: none split; else f32 partials
    and a reduce for the split tiles), walked by `grid` persistent blocks;
    A (the window) staged in copies of `copy` bytes (16, 8, 4, or 2:
    element by element), or by TMA where the conv is 1x1 with stride 1 and
    no padding and `copy` is 16 (`tma_a`); B by TMA where its rows are whole
    16-byte runs (`copy_b` 16), else in copies of `copy_b` bytes."""
    tile_n: int
    copy: int
    copy_b: int
    tma_a: bool
    blocks: int
    chunks: int
    full: int
    splits: int
    grid: int

    @property
    def tma_b(self) -> bool:
        return self.copy_b == 16


def tile_width(oc: int) -> int:
    """The N tile: 64 where all oc columns fit one 64-wide tile, else 128.
    A wider N is never cut into 64-wide tiles: each N tile stages A again,
    and staging A is what paces the ring."""
    return 64 if oc <= 64 else 128


def thin_pad(C: int) -> int:
    """The zero channels B7's wrapper adds on the card to an input of C < 16
    channels, C % 4 != 0 (ResNet's and GoogLeNet's conv1 at C = 3), so that
    its window moves by copies of 8 bytes: element by element, conv1 at b128
    took 2.17 ms on an H100, as long as cuDNN's FP32 conv. Costs a pass over
    x and over w (two launches); wider inputs are left as they are."""
    return -C % 4 if C < 16 else 0


@functools.lru_cache(maxsize=4096)
def bconv_plan(n: int, H: int, W: int, C: int, oc: int, ky: int, kx: int,
               stride: tuple[int, int], pad: tuple[int, int],
               sms: int) -> BconvPlan:
    """The kernel's plan for x [n, H, W, C] and an [oc, ky, kx, C] filter:
    the implicit GEMM of n*oy*ox pixels by oc channels over ky*kx*C on 128
    x tile_width(oc) tiles, K split where the tiles do not fill the card
    (SPLIT, qconv.ring_walk), copies as wide as C (A) and K (B) allow for
    16-byte aligned operands."""
    oy = (H + 2 * pad[0] - ky) // stride[0] + 1
    ox = (W + 2 * pad[1] - kx) // stride[1] + 1
    K = ky * kx * C
    tn = tile_width(oc)
    g = gemm_plan("bconv_plan", n * oy * ox, oc, K, C, tn, torch.bfloat16,
                  sms, SPLIT)
    chunks = math.ceil(K / g.bk)
    full, splits, grid = ring_walk(g, math.ceil(oc / tn), chunks,
                                   SPLIT[torch.bfloat16][3], sms)
    copy = copy_width(2 * C, 0, COPY_WIDTHS)
    copy_b = copy_width(2 * K, 0, COPY_WIDTHS)
    tma_a = copy == 16 and (ky, kx) == (1, 1) and tuple(stride) == (1, 1) \
        and tuple(pad) == (0, 0)
    return BconvPlan(tn, copy, copy_b, tma_a, g.blocks, chunks, full, splits,
                     grid)


def _check(x, w, biases, members, stride, pad):
    check_operand(x, "bconv x", 4, (torch.bfloat16,))
    check_operand(w, "bconv w", 4, (torch.bfloat16,))
    n, H, W, C = x.shape
    N, ky, kx, wc = w.shape
    if wc != C:
        raise RtErr(f"bconv: x has {C} channels, w {tuple(w.shape)} (OHWI) "
                    f"has {wc}")
    members, biases = tuple(members), tuple(biases)
    if not 1 <= len(members) <= MAX_MEMBERS or len(biases) != len(members):
        raise RtErr(f"bconv: {len(members)} members and {len(biases)} "
                    f"biases (1 to {MAX_MEMBERS} members, a bias or None "
                    f"each)")
    if sum(m.oc for m in members) != N or min(m.oc for m in members) < 1:
        raise RtErr(f"bconv: members of {[m.oc for m in members]} channels "
                    f"for a filter of {N}")
    for m, b in zip(members, biases):
        if m.dtype not in OUT_DTYPES:
            raise RtErr(f"bconv: output dtype {m.dtype} not f32/bf16/int8")
        if m.dtype == torch.int8 and not m.out_absmax > 0:
            raise RtErr(f"bconv: an int8 output needs out_absmax > 0, got "
                        f"{m.out_absmax}")
        if b is not None:
            check_operand(b, "bconv bias", 1, (torch.float32,))
            if b.shape[0] != m.oc:
                raise RtErr(f"bconv: a bias of {b.shape[0]} for a member of "
                            f"{m.oc} channels")
    (sy, sx), (py, px) = stride, pad
    if min(sy, sx) < 1 or min(py, px) < 0:
        raise RtErr(f"bconv: stride {stride}, pad {pad}")
    oy, ox = (H + 2 * py - ky) // sy + 1, (W + 2 * px - kx) // sx + 1
    if min(n, C, oy, ox) < 1 or H + 2 * py < ky or W + 2 * px < kx:
        raise RtErr(f"bconv: empty output for x {tuple(x.shape)}, w "
                    f"{tuple(w.shape)}, stride {stride}, pad {pad}")
    if max(x.numel(), w.numel(), n * oy * ox * N) >= 2 ** 31:
        raise RtErr("bconv: extent over int32")
    return n, H, W, C, N, ky, kx, oy, ox


def bconv_plain(x, w, biases, members, stride=(1, 1), pad=(0, 0)):
    """Plain PyTorch bconv: the vendor conv's arithmetic exactly, the f32
    conv in full FP32 of the bf16 operands (channels_last, as the vendor
    path runs it), then per member its columns, its bias in f32, its ReLU
    and its one rounding to the stored dtype (conv.vendor_store)."""
    from .conv import vendor_store
    _check(x, w, biases, members, stride, pad)
    y = _conv_fwd(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2),
                  tuple(stride), tuple(pad), False, True)
    outs, off = [], 0
    for m, b in zip(members, biases):
        yi = y[:, off:off + m.oc]
        if b is not None:
            yi = yi + b[None, :, None, None]
        outs.append(vendor_store(yi, m.relu, m.dtype, True, m.out_absmax))
        off += m.oc
    return tuple(outs)


def bconv(x, w, biases, members, stride=(1, 1), pad=(0, 0)):
    """out_j[n,oy,ox,o] = store_j(relu_j?(f32(sum x[n,..,C] * w[o_j + o,
    ..,C]) + bias_j[o])) for each member j, the sum over bf16 operands in
    f32.

    x: contiguous bf16 NHWC; w: contiguous bf16 OHWI [N, ky, kx, C], the
    members' filters concatenated on N; biases: per member a contiguous f32
    [oc] or None; members: 1-4 `Member`s whose oc add up to N; stride (sy,
    sx), pad (py, px). Returns a tuple of new NHWC tensors, one per member,
    of its dtype.

    On CUDA tensors the launch (two where bconv_plan splits K: the split
    products and their reduce; before it, for C < 16 not a multiple of 4,
    thin_pad's two) is asynchronous on the current stream, counted once in
    bconv.launches; CPU tensors take bconv_plain. What depends on the
    shapes alone (the checks of shapes and dtypes, the plan, the members'
    stores) is worked out once per shape (`_Launch`): a forward calls
    B7 some fifty times, and the host's time per call sets its pace where
    the kernels are short."""
    biases, members = tuple(biases), tuple(members)
    if not (isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)):
        _check(x, w, biases, members, stride, pad)
    if not use_kernel(x, w, *biases):
        return bconv_plain(x, w, biases, members, stride, pad)
    key = (x.shape, x.dtype, w.shape, w.dtype, members, tuple(stride),
           tuple(pad), x.device.index,
           tuple(None if b is None else (b.shape, b.dtype) for b in biases))
    ln = _LAUNCHES.get(key)
    if ln is None:
        _check(x, w, biases, members, stride, pad)
        if len(_LAUNCHES) >= 4096:
            _LAUNCHES.clear()
        ln = _LAUNCHES[key] = _Launch(x.shape, w.shape, members,
                                      tuple(stride), tuple(pad),
                                      sm_count(x.device.index))
    elif not (x.is_contiguous() and w.is_contiguous() and all(
            b is None or b.is_contiguous() for b in biases)):
        _check(x, w, biases, members, stride, pad)  # raises
    outs = ln(x, w, biases)
    bconv.launches += 1
    return outs


bconv.launches = 0
_LAUNCHES: dict = {}


def _stores(members, outs=None):
    """The members' stores as boda_bconv takes them: (meta, q) ctypes
    arrays, meta[4 j ..] = (oc, relu, dtype index, whether runs of 4
    results are one store: the member's first column and width multiples
    of 4 and its out aligned for them; outs None: outputs torch allocates,
    256-byte aligned)."""
    meta, q, n0 = [], [], 0
    for j, m in enumerate(members):
        vec = n0 % 4 == 0 and m.oc % 4 == 0 and (
            outs is None
            or outs[j].data_ptr() % (4 * outs[j].element_size()) == 0)
        meta += [m.oc, int(m.relu), OUT_DTYPES.index(m.dtype), int(vec)]
        q.append(out_q_scale(m.out_absmax) if m.dtype == torch.int8 else 0.0)
        n0 += m.oc
    return ((ctypes.c_int * (4 * MAX_MEMBERS))(*meta),
            (ctypes.c_float * MAX_MEMBERS)(*q))


def _run(x, w, biases, outs, dims, tile_n, full, splits, grid, stores):
    """boda_bconv on checked CUDA operands: x and w as the kernel takes
    them (C widened where thin_pad says), dims = (n, H, W, C, N, ky, kx,
    sy, sx, py, px), the copy widths from the operands' alignment (torch
    allocations are 256-byte aligned; a view into one may not be), the f32
    workspace of the split tiles' rows."""
    n, H, W, C, N, ky, kx = dims[:7]
    ws = None
    if splits > 1:
        m_split = full // math.ceil(N / tile_n) * GEMM_TILE_M
        ws = torch.empty((splits, outs[0].numel() // outs[0].shape[-1]
                          - m_split, N), dtype=torch.float32,
                         device=x.device)
    out_a = (ctypes.c_void_p * MAX_MEMBERS)(*[o.data_ptr() for o in outs])
    bias_a = (ctypes.c_void_p * MAX_MEMBERS)(
        *[None if b is None else b.data_ptr() for b in biases])
    meta_a, q_a = stores
    rc = load_kernels().boda_bconv(
        x.data_ptr(), w.data_ptr(), None if ws is None else ws.data_ptr(),
        *dims, tile_n, copy_width(2 * C, x.data_ptr(), COPY_WIDTHS),
        copy_width(2 * ky * kx * C, w.data_ptr(), COPY_WIDTHS), full, splits,
        grid, len(outs),
        ctypes.addressof(out_a), ctypes.addressof(bias_a),
        ctypes.addressof(meta_a), ctypes.addressof(q_a),
        cuda_stream(x.device))
    check_launch(rc, "bconv")


class _Launch:
    """bconv's launch at one shape: the plan (of x widened by thin_pad's
    channels), the outputs' shapes and dtypes, and the members' stores for
    outputs torch allocates (256-byte aligned)."""

    def __init__(self, x_shape, w_shape, members, stride, pad, sms):
        n, H, W, C = x_shape
        N, ky, kx, _ = w_shape
        self.extra = thin_pad(C)
        C += self.extra
        self.plan = bconv_plan(n, H, W, C, N, ky, kx, stride, pad, sms)
        oy = (H + 2 * pad[0] - ky) // stride[0] + 1
        ox = (W + 2 * pad[1] - kx) // stride[1] + 1
        self.outs = [((n, oy, ox, m.oc), m.dtype) for m in members]
        self.dims = (n, H, W, C, N, ky, kx) + stride + pad
        self.stores = _stores(members)

    def __call__(self, x, w, biases):
        if self.extra:
            # zero channels add nothing to the sums: x and w widened to C +
            # extra move by 8-byte copies in place of element stores
            x, w = F.pad(x, (0, self.extra)), F.pad(w, (0, self.extra))
        outs = tuple(torch.empty(shape, dtype=dt, device=x.device)
                     for shape, dt in self.outs)
        p = self.plan
        _run(x, w, biases, outs, self.dims, p.tile_n, p.full, p.splits,
             p.grid, self.stores)
        return outs


def launch_bconv(x, w, biases, members, outs, stride, pad, tile_n: int,
                 full: int, splits: int, grid: int) -> None:
    """The kernel on checked CUDA operands (C as they have it: no
    thin_pad) into `outs` under a given tile width, split (the first `full`
    tiles whole, the rest in `splits` K ranges) and grid (bconv's plan, or
    another for a measurement). Counts nothing."""
    dims = tuple(x.shape) + tuple(w.shape[:3]) + tuple(stride) + tuple(pad)
    _run(x, w, biases, outs, dims, tile_n, full, splits, grid,
         _stores(members, outs))


def ohwi_bf16(w: torch.Tensor) -> torch.Tensor:
    """B7's filter of a float OIHW filter: bf16 OHWI, contiguous (one cast
    and copy)."""
    return w.permute(0, 2, 3, 1).to(torch.bfloat16,
                                    memory_format=torch.contiguous_format)


class FilterCache:
    """make(*ws), a conv step's filter of its weight tensors, made once per
    set of them and kept while they stay as they were: the same tensors
    (held here, so their ids stay theirs) at the same version counters (an
    in-place update bumps them), one set per device (each slot of a mesh
    calls the step with its own). Inference tensors keep no version
    counter, so their filter is made at every call."""

    def __init__(self, make):
        self.make = make
        self.held = {}

    def __call__(self, *ws):
        if any(w.is_inference() for w in ws):
            return self.make(*ws)
        stamp = tuple((id(w), w._version) for w in ws)
        got = self.held.get(ws[0].device)
        if got is None or got[0] != stamp:
            with torch.no_grad():
                got = (stamp, ws, self.make(*ws))
            self.held[ws[0].device] = got
        return got[2]
