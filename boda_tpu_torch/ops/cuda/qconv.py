"""qconv (kernel B6), the int8 convolution of the selective-int8 preset;
act_quantize, the activation quantize that makes its input; and wgrad_q8,
training's int8 weight gradient (grad_q8) on the same two kernels.

Port of the int8 forms of the vendor conv: boda_tpu/ops/pallas/conv.py
XlaConv.build (:162-266) and boda_tpu/ops/pallas/conv2.py XlaConv2.build
(:139-193), an XLA conv_general_dilated on int8 operands with int32
results. Torch has no int8 conv on CUDA, so both wrappers launch the
hand-written kernels of csrc/qconv.cu (see its header for what bounds them
and how they are built): `qconv`, an implicit-GEMM conv on int8 `wgmma`
fed by a warp-specialized TMA / mbarrier ring, with an exact int32 K split
and its reduce where the tiles do not fill the card, and `act_quantize`,
one launch for a static scale and two for a dynamic one, which can store
its result transposed for the weight gradient. `qconv_plan` is the
kernel's plan (tiles and K splits on util.gemm_plan, the copy width).
Under a dp split the dynamic scale comes apart (engine/mesh_fwd.py):
`absmax`, the first launch and a fold of its partial maxima, gives a
slot's max|x| as a device scalar, and `act_quantize(x, amax=m)` quantizes
at the scale of a max m read from device memory, the dp group's.
`qconv_plain`, `act_quantize_plain` and `absmax_plain` are the same
functions in plain PyTorch. Each wrapper runs the plain version for CPU
tensors and the kernel for CUDA tensors.

The arithmetic is the JAX template's, operation for operation, each one f32
rounding: s_act = float32(act_absmax / 127) from the double quotient (a
static scale, conv.py:168) or max|x| / 127 + 1e-30 in f32 (a dynamic one);
xq = clamp(rint(x / s_act), -127, 127) with IEEE division; the exact int32
sum, converted to f32, times s_act * sws[o], plus the bias, ReLU, and the
store: f32, bf16, or an int8 edge at clamp(rint(v * float32(127 /
out_absmax)), -127, 127) (conv.py:173-179). So kernel, plain version and
JAX template agree bit for bit where XLA rounds the same way; a K split
adds int32 partial sums, which is the same sum.

wgrad_q8 is boda_tpu/ops/mxu_grad.py's _wgrad_q8 (:170-205) as glue around
them: the activation quantized per tensor and stored transposed, the
cotangent per output channel (quantize_filter's formula) into the filter
layout B6 takes (`cotangent_quantize`, the same kernel's per-channel form),
the batch as B6's channels, one stride-1 B6 conv per phase of a forward
stride (where JAX dilates the cotangent); wgrad_q8_plain is the same glue
on the plain versions.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...core.error import RtErr
from .build import check_launch, load_kernels
from .qsgemm import K_MAX
from .util import GEMM_TILE_M, check_operand, cuda_stream, forbid_autograd, \
    gemm_plan, sm_count, use_kernel

TILE_N = 128                 # block tile: 128 pixels x 128 output channels
# Split-K as util.gemm_plan reads it (below, least, fill, min_chunks): a
# grid of fewer tiles than SMs splits K into the smallest power of two of
# splits that gives every SM a unit, then into as many splits as keep 4 K
# chunks each; qconv_plan then caps the units at one per SM. A grid of more
# tiles than SMs runs its full waves' tiles whole and splits the tiles of
# its last wave, where they are few enough, into one wave of units of 4 K
# chunks or more. The kernel alone by split count on an H100
# (chip_smoke.py's `qconv splits` lines) ran fastest so: a second wave of
# units cost more than its shorter walk saved (res3 3x3 b32, 196 tiles:
# 0.0269 ms unsplit, 0.0305 in 2 uniform splits; res4 3x3 b32, 98 tiles:
# 0.0238, 0.0290), while one wave of split units paid (res5 3x3 b32, 52
# tiles: 0.0396 -> 0.0250 ms in 2; the res3 weight gradient, 9 tiles:
# 0.1995 -> 0.0248 ms in 12)
SPLIT = {torch.int8: (1, 2, 1, 4)}
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
COPY_WIDTHS = (16, 8, 4, 1)


def static_act_scale(act_absmax: float) -> float:
    """s_act of a calibrated act_absmax: the double quotient act_absmax /
    127 rounded once to f32, as jnp.float32(act_absmax / 127.0) gives it
    (for the f32 value a sig holds, the same as one IEEE f32 division; a
    product with the reciprocal would differ by an ulp for some values and
    move codes at the boundaries)."""
    return float(np.float32(act_absmax / 127.0))


def out_q_scale(out_absmax: float) -> float:
    """q of an int8 edge's store, float32(127 / out_absmax) from the double
    quotient."""
    return float(np.float32(127.0 / out_absmax))


def store_int8(y: torch.Tensor, out_absmax: float) -> torch.Tensor:
    """The int8 edge's store of an f32 y: clamp(rint(y * q), -127, 127)."""
    return torch.round(y * out_q_scale(out_absmax)).clamp_(-127, 127) \
        .to(torch.int8)


def quantize_filter(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(wq int8, sws f32 [oc]) of a float OIHW filter: the per-out_chan
    weight quantize of the JAX template (conv.py:60-62), in torch ops as it
    is XLA ops there: sw = max|w| over (I, ky, kx) / 127 + 1e-30, wq =
    clamp(rint(w / sw), -127, 127). The divisors are tensors: torch on a
    card multiplies by the reciprocal of a Python number."""
    wf = w.float()
    d = torch.full((), 127.0, device=w.device)
    sw = wf.abs().amax(dim=(1, 2, 3)) / d + torch.full((), 1e-30,
                                                        device=w.device)
    wq = torch.round(wf / sw[:, None, None, None]).clamp_(-127, 127) \
        .to(torch.int8)
    return wq, sw


# ---------------------------------------------------------------- quantize

def _check_x(x: torch.Tensor, transpose: bool = False) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype not in (torch.float32,
                                                          torch.bfloat16):
        raise RtErr("act_quantize: x must be an f32 or bf16 tensor")
    if not x.is_contiguous() or x.numel() < 1:
        raise RtErr(f"act_quantize: x must be contiguous and non-empty, got "
                    f"shape {tuple(x.shape)}")
    if transpose and x.dim() < 2:
        raise RtErr(f"act_quantize: a transposed store needs x of rank >= 2, "
                    f"got shape {tuple(x.shape)}")
    if x.numel() >= 2 ** 31:
        raise RtErr(f"act_quantize: {x.numel()} elements, over int32")


def _swap_ends(t: torch.Tensor) -> torch.Tensor:
    """t with its first and last dims swapped ([N, H, W, C] -> [C, H, W,
    N]), contiguous."""
    return t.transpose(0, -1).contiguous()


def _check_amax(x: torch.Tensor, act_absmax: float, amax) -> None:
    if amax is None:
        return
    if act_absmax:
        raise RtErr("act_quantize: a static act_absmax and a device amax")
    if not isinstance(amax, torch.Tensor) or amax.dtype != torch.float32 \
            or tuple(amax.shape) != (1,) or amax.device != x.device:
        raise RtErr(f"act_quantize: amax must be an f32 [1] tensor on "
                    f"{x.device}")


def _scale_of_max(m: torch.Tensor) -> torch.Tensor:
    """s_act = m / 127 + 1e-30 in f32, as an f32 [1] tensor (tensor divisors:
    IEEE division on a card too)."""
    return (m / torch.full((), 127.0, device=m.device)
            + torch.full((), 1e-30, device=m.device)).reshape(1)


def act_quantize_plain(x: torch.Tensor, act_absmax: float = 0.0,
                       transpose: bool = False, amax=None):
    """Plain PyTorch act_quantize: (xq int8 of x's shape, or of x's with its
    first and last dims swapped where transpose, s_act as an f32 [1] tensor
    on x's device)."""
    _check_x(x, transpose)
    _check_amax(x, act_absmax, amax)
    xf = x.float()
    if act_absmax:
        s = torch.full((1,), static_act_scale(act_absmax), device=x.device)
    else:
        s = _scale_of_max(xf.abs().amax() if amax is None else amax)
    xq = torch.round(xf / s).clamp_(-127, 127).to(torch.int8)
    return (_swap_ends(xq) if transpose else xq), s


def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch absmax: max|x| as an f32 [1] tensor on x's device."""
    _check_x(x)
    return x.float().abs().amax().reshape(1)


def absmax(x: torch.Tensor) -> torch.Tensor:
    """max|x| of an f32 or bf16 tensor (contiguous, any layout) as an f32
    [1] tensor on x's device, NaN where x holds one: what one slot of a dp
    split takes before the max over its dp group (parallel/mesh.pmax), whose
    result act_quantize's `amax` then reads. On CUDA tensors act_quantize's
    dynamic first launch (the partial maxima) and a one-block fold of them,
    asynchronous on the current stream (counted once in absmax.launches)."""
    _check_x(x)
    forbid_autograd("absmax", x)
    if not use_kernel(x):
        return absmax_plain(x)
    lib = load_kernels()
    ws = torch.empty(lib.boda_act_quantize_ws_floats(1, 1, x.numel(), 0),
                     dtype=torch.float32, device=x.device)
    rc = lib.boda_act_absmax(x.data_ptr(), ws.data_ptr(), x.numel(),
                             int(x.dtype == torch.bfloat16),
                             cuda_stream(x.device))
    check_launch(rc, "absmax")
    absmax.launches += 1
    return ws[:1]


absmax.launches = 0


def _ends(x: torch.Tensor) -> tuple[int, int, int]:
    """x as [A, B, Cc]: its first dim, the product of the middle ones, its
    last dim."""
    return x.shape[0], x.numel() // (x.shape[0] * x.shape[-1]), x.shape[-1]


def act_quantize(x: torch.Tensor, act_absmax: float = 0.0,
                 transpose: bool = False, amax=None):
    """xq = clamp(rint(x / s_act), -127, 127) of an f32 or bf16 tensor, any
    layout (contiguous), and s_act: float32(act_absmax / 127) where a static
    act_absmax is given, else m / 127 + 1e-30 computed on the card, m the max
    in `amax` (an f32 [1] tensor on x's device: a dp group's, see absmax)
    where given, else max|x|. Returns (xq int8, s_act as an f32 [1] tensor
    on x's device); xq has x's shape, or x's with its first and last dims
    swapped where transpose (the weight gradient's [N, H, W, I] -> [I, H,
    W, N], stored so by the same pass).

    On CUDA tensors the launches (one static or at `amax`, two dynamic;
    counted once in act_quantize.launches) are asynchronous on the current
    stream: the host never waits for a dynamic scale, which qconv reads from
    device memory. A NaN in x gives a NaN dynamic scale; an element whose
    quotient is NaN quantizes to 0."""
    _check_x(x, transpose)
    _check_amax(x, act_absmax, amax)
    forbid_autograd("act_quantize", x)
    if not use_kernel(x):
        return act_quantize_plain(x, act_absmax, transpose, amax)
    lib = load_kernels()
    a, b, c = _ends(x) if transpose else (1, 1, x.numel())
    shape = tuple(x.shape)
    if transpose:
        shape = (shape[-1],) + shape[1:-1] + (shape[0],)
    xq = torch.empty(shape, dtype=torch.int8, device=x.device)
    ws = torch.empty(lib.boda_act_quantize_ws_floats(a, b, c, 0),
                     dtype=torch.float32, device=x.device)
    rc = lib.boda_act_quantize(
        x.data_ptr(), xq.data_ptr(), ws.data_ptr(),
        None if amax is None else amax.data_ptr(), a, b, c,
        int(x.dtype == torch.bfloat16),
        static_act_scale(act_absmax) if act_absmax else 0.0,
        0 if act_absmax else (1 if amax is None else 2), int(transpose), 0,
        cuda_stream(x.device))
    check_launch(rc, "act_quantize")
    act_quantize.launches += 1
    return xq, ws[:1]


act_quantize.launches = 0


def cotangent_quantize_plain(g: torch.Tensor):
    """Plain PyTorch cotangent_quantize: quantize_filter over g with its
    first and last dims swapped."""
    _check_x(g, True)
    wq, sw = quantize_filter(g.transpose(0, -1))
    return wq.contiguous(), sw.float().contiguous()


def cotangent_quantize(g: torch.Tensor):
    """The weight gradient's per-output-channel quantize of a cotangent g,
    NHWC [N, OH, OW, O] (f32 or bf16, contiguous): (gq int8 [O, OH, OW, N],
    s_g f32 [O]) with s_g[o] = max |g[..., o]| / 127 + 1e-30 and gq =
    clamp(rint(g / s_g), -127, 127) stored transposed, quantize_filter's
    formula on g as B6's OHWI filter (the JAX _wgrad_q8's s_g over N, OH,
    OW). On CUDA tensors two launches of act_quantize's kernel in its
    per-channel form (the maxima, then the scales and the store), counted
    once in cotangent_quantize.launches."""
    _check_x(g, True)
    forbid_autograd("cotangent_quantize", g)
    if not use_kernel(g):
        return cotangent_quantize_plain(g)
    lib = load_kernels()
    a, b, c = _ends(g)
    gq = torch.empty((c,) + tuple(g.shape[1:-1]) + (a,), dtype=torch.int8,
                     device=g.device)
    ws = torch.empty(lib.boda_act_quantize_ws_floats(a, b, c, 1),
                     dtype=torch.float32, device=g.device)
    rc = lib.boda_act_quantize(
        g.data_ptr(), gq.data_ptr(), ws.data_ptr(), None, a, b, c,
        int(g.dtype == torch.bfloat16), 0.0, 1, 1, 1, cuda_stream(g.device))
    check_launch(rc, "cotangent_quantize")
    cotangent_quantize.launches += 1
    return gq, ws[:c]


cotangent_quantize.launches = 0


# ---------------------------------------------------------------- the conv

@dataclass(frozen=True)
class QconvPlan:
    """How B6 runs one conv: 128 x 128 output tiles ("blocks" of them) over
    `chunks` K chunks of 128 bytes, the first `full` whole and
    the rest in `splits` K ranges each (splits 1: none split; else int32
    partials and a reduce for the split tiles), walked by `grid` persistent
    blocks (one per SM at most); A (the window) staged in copies of `copy`
    bytes (16, 8, 4, or 1: element by element), or by TMA where the conv is
    1x1 with stride 1 and no padding and `copy` is 16 (`tma_a`: A is xq as a
    row-major [M, C] matrix); B by TMA where K allows 16-byte rows
    (`copy_b` 16), else in copies of `copy_b` bytes."""
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


def copy_width(extent: int, ptr: int = 0) -> int:
    """The widest copy (16, 8, 4 or 1 bytes) that divides a run of `extent`
    int8 values starting at address ptr."""
    return next(v for v in COPY_WIDTHS if extent % v == 0 and ptr % v == 0)


def split_ranges(chunks: int, splits: int) -> list[tuple[int, int]]:
    """Each split's K chunks [kc0, kc1), as the kernel takes them: sizes
    that differ by at most one, none empty while splits <= chunks."""
    return [(z * chunks // splits, (z + 1) * chunks // splits)
            for z in range(splits)]


@functools.lru_cache(maxsize=4096)
def qconv_plan(n: int, H: int, W: int, C: int, oc: int, ky: int, kx: int,
               stride: tuple[int, int], pad: tuple[int, int],
               sms: int) -> QconvPlan:
    """The kernel's plan for xq [n, H, W, C] and an [oc, ky, kx, C] filter:
    the implicit GEMM of n*oy*ox pixels by oc channels over ky*kx*C on 128 x
    128 tiles of the int8 route; K split (SPLIT) where the tiles are fewer
    than the SMs, into at most one unit per SM, or, past that, the last
    wave's tiles (whole rows of tiles) split where the split units fit one
    wave; copies as wide as C (A) and K (B) allow, for 16-byte aligned
    operands."""
    oy = (H + 2 * pad[0] - ky) // stride[0] + 1
    ox = (W + 2 * pad[1] - kx) // stride[1] + 1
    K = ky * kx * C
    g = gemm_plan("qconv_plan", n * oy * ox, oc, K, C, TILE_N, torch.int8,
                  sms, SPLIT)
    chunks = math.ceil(K / g.bk)
    full, splits, grid = ring_walk(g, math.ceil(oc / TILE_N), chunks,
                                   SPLIT[torch.int8][3], sms)
    copy, copy_b = copy_width(C), copy_width(K)
    tma_a = copy == 16 and (ky, kx) == (1, 1) and tuple(stride) == (1, 1) \
        and tuple(pad) == (0, 0)
    return QconvPlan(copy, copy_b, tma_a, g.blocks, chunks, full, splits,
                     grid)


def ring_walk(g, tiles_n: int, chunks: int, min_chunks: int,
              sms: int) -> tuple[int, int, int]:
    """(full, splits, grid) of the persistent walk of csrc/conv_ring.cuh
    (B6 and B7) over g.blocks tiles, tiles_n of them along N, of `chunks`
    K chunks: K split as g says where the tiles are fewer than the SMs,
    into at most one unit per SM, or, past that, the last wave's tiles
    (whole rows of tiles) split where the split units fit one wave and keep
    min_chunks chunks each; the first `full` tiles run whole; grid is the
    units, at most one block per SM."""
    if g.blocks < sms:
        splits, full = max(1, min(g.splits, sms // g.blocks)), 0
    else:
        full = g.blocks // sms * sms // tiles_n * tiles_n
        rest = g.blocks - full
        splits = min(sms // rest, chunks // min_chunks) if rest else 1
    if splits < 2:
        splits, full = 1, g.blocks
    units = full + (g.blocks - full) * splits
    return full, splits, min(units, sms)


def _check(xq, wq, s_act, sws, bias, stride, pad, out_dtype, out_absmax):
    check_operand(xq, "qconv xq", 4, (torch.int8,))
    check_operand(wq, "qconv wq", 4, (torch.int8,))
    n, H, W, C = xq.shape
    oc, ky, kx, wc = wq.shape
    if wc != C:
        raise RtErr(f"qconv: xq has {C} channels, wq {tuple(wq.shape)} (OHWI) "
                    f"has {wc}")
    (sy, sx), (py, px) = stride, pad
    if min(sy, sx) < 1 or min(py, px) < 0:
        raise RtErr(f"qconv: stride {stride}, pad {pad}")
    oy, ox = (H + 2 * py - ky) // sy + 1, (W + 2 * px - kx) // sx + 1
    if min(n, C, oc, oy, ox) < 1 or H + 2 * py < ky or W + 2 * px < kx:
        raise RtErr(f"qconv: empty output for xq {tuple(xq.shape)}, wq "
                    f"{tuple(wq.shape)}, stride {stride}, pad {pad}")
    if ky * kx * C > K_MAX:
        raise RtErr(f"qconv: K={ky * kx * C} > {K_MAX} could overflow the "
                    f"int32 accumulator")
    if max(xq.numel(), wq.numel(), n * oy * ox * oc) >= 2 ** 31:
        raise RtErr("qconv: extent over int32")
    check_operand(sws, "qconv sws", 1, (torch.float32,))
    if bias is not None:
        check_operand(bias, "qconv bias", 1, (torch.float32,))
    if sws.shape[0] != oc or (bias is not None and bias.shape[0] != oc):
        raise RtErr(f"qconv: sws / bias lengths != oc={oc}")
    check_operand(s_act, "qconv s_act", 1, (torch.float32,))
    if s_act.numel() != 1:
        raise RtErr(f"qconv: s_act of shape {tuple(s_act.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise RtErr(f"qconv: output dtype {out_dtype} not f32/bf16/int8")
    if out_dtype == torch.int8 and not out_absmax > 0:
        raise RtErr(f"qconv: an int8 output needs out_absmax > 0, got "
                    f"{out_absmax}")
    return n, H, W, C, oc, ky, kx, oy, ox


def qconv_plain(xq, wq, s_act, sws, bias=None, stride=(1, 1), pad=(0, 0),
                relu=False, out_dtype=torch.float32, out_absmax=0.0):
    """Plain PyTorch qconv: the float64 conv of the int8 values, exact since
    every |sum| <= K * 127^2 < 2^53, rounded once to f32 (as int32 -> f32
    rounds every |sum| < 2^31), then the kernel's f32 epilogue op by op."""
    _check(xq, wq, s_act, sws, bias, stride, pad, out_dtype, out_absmax)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   wq.permute(0, 3, 1, 2).double(), stride=stride,
                   padding=pad)
    return qconv_epilogue(acc.permute(0, 2, 3, 1), s_act, sws, bias, relu,
                          out_dtype, out_absmax)


def qconv_epilogue(acc, s_act, sws, bias=None, relu=False,
                   out_dtype=torch.float32, out_absmax=0.0):
    """The kernel's epilogue on exact NHWC sums `acc` (any dtype that holds
    them): f32(acc) * (s_act * sws) + bias, ReLU, the store, each step one
    f32 rounding."""
    y = acc.float() * (s_act * sws)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    y = store_int8(y, out_absmax) if out_dtype == torch.int8 \
        else y.to(out_dtype)
    return y.contiguous()


def qconv(xq, wq, s_act, sws, bias=None, stride=(1, 1), pad=(0, 0),
          relu=False, out_dtype=torch.float32, out_absmax=0.0):
    """out[n,oy,ox,o] = store(relu?(f32(sum xq[n,..,C] * wq[o,..,C]) *
    (s_act * sws[o]) + bias[o])), the sum in int32.

    xq: contiguous int8 NHWC; wq: contiguous int8 OHWI [oc, ky, kx, C]; s_act:
    an f32 [1] tensor on xq's device (act_quantize's, or a static scale for
    an input that arrives int8); sws: contiguous f32 [oc]; bias: contiguous
    f32 [oc] or None; stride (sy, sx), pad (py, px). Returns
    a new NHWC tensor of out_dtype: f32, bf16, or int8 stored at
    clamp(rint(v * float32(127 / out_absmax)), -127, 127). Raises for K over
    K_MAX, where the int32 sum could overflow.

    On CUDA tensors the launch (two where qconv_plan splits K: the split
    products and their reduce) is asynchronous on the current stream,
    counted once in qconv.launches."""
    n, H, W, C, oc, ky, kx, oy, ox = _check(xq, wq, s_act, sws, bias, stride,
                                            pad, out_dtype, out_absmax)
    forbid_autograd("qconv", s_act, sws, bias)
    if not use_kernel(xq, wq, s_act, sws, bias):
        return qconv_plain(xq, wq, s_act, sws, bias, stride, pad, relu,
                           out_dtype, out_absmax)
    plan = qconv_plan(n, H, W, C, oc, ky, kx, tuple(stride), tuple(pad),
                      sm_count(xq.device.index))
    out = torch.empty((n, oy, ox, oc), dtype=out_dtype, device=xq.device)
    launch_qconv(xq, wq, s_act, sws, bias, out, stride, pad, relu,
                 out_absmax, plan.full, plan.splits, plan.grid)
    qconv.launches += 1
    return out


qconv.launches = 0


def launch_qconv(xq, wq, s_act, sws, bias, out, stride, pad, relu,
                 out_absmax, full: int, splits: int, grid: int) -> None:
    """The kernel on checked CUDA operands into `out` under a given split
    (the first `full` tiles whole, the rest in `splits` K ranges) and grid
    (qconv's plan, or another for a measurement): the copy widths from C, K
    and the operands' alignment (torch allocations are 256-byte aligned; a
    view into one may not be), the int32 workspace of the split tiles' rows.
    Counts nothing."""
    n, H, W, C = xq.shape
    oc, ky, kx, _ = wq.shape
    m_split = full // math.ceil(oc / TILE_N) * GEMM_TILE_M
    ws = None if splits == 1 else torch.empty(
        (splits, out.numel() // oc - m_split, oc), dtype=torch.int32,
        device=xq.device)
    odt = out.dtype
    rc = load_kernels().boda_qconv(
        xq.data_ptr(), wq.data_ptr(), s_act.data_ptr(), sws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        n, H, W, C, oc, ky, kx, stride[0], stride[1], pad[0], pad[1],
        int(bool(relu)), OUT_DTYPES.index(odt),
        out_q_scale(out_absmax) if odt == torch.int8 else 0.0,
        copy_width(C, xq.data_ptr()), copy_width(ky * kx * C, wq.data_ptr()),
        full, splits, grid, cuda_stream(xq.device))
    check_launch(rc, "qconv")


# ------------------------------------------------------- the weight gradient

def _wgrad_q8(x, w, g, stride, pad, quantize, gquant, conv):
    """wgrad_q8's glue around the activation quantize, the cotangent
    quantize and the conv it is given (the kernels' wrappers, or their
    plain versions)."""
    oc, ic, ky, kx = w.shape
    n, H, W, _ = x.shape
    _, oy, ox, _ = g.shape
    # per-tensor activation scale over all of x, before any crop; stored
    # as [I, H, W, N]: B6's NHWC with the batch as its channels
    xt, s_x = quantize(x.contiguous(), 0.0, True)
    # per-O cotangent scale: quantize_filter over g as an [O, OH, OW, N]
    # "filter" (B6's OHWI), the JAX _wgrad_q8's s_g over (N, OH, OW)
    gq, s_g = gquant(g.contiguous())
    (sy, sx), (py, px) = stride, pad
    if (sy, sx) == (1, 1):
        # pad_hi of the transposed conv (mxu_grad.py:196-200): the output
        # extent is exactly (ky, kx); where it is not pad_lo, pad (or crop)
        # x explicitly (quantized zero is 0)
        hy, hx = oy - H + ky - py - 1, ox - W + kx - px - 1
        if (hy, hx) != (py, px):
            xt = F.pad(xt, (0, 0, px, hx, py, hy)).contiguous()
            py = px = 0
        dw = conv(xt, gq, s_x, s_g, None, (1, 1), (py, px), False,
                  torch.float32, 0.0)
        return dw.permute(3, 0, 1, 2)  # [I, ky, kx, O] -> OIHW
    # a forward stride: tap ky = qy*sy + ry reads x at (oy + qy)*sy + ry
    # - py, so phase (ry, rx) of the taps is a stride-1 conv of x's phase
    # xpad[ry::sy, rx::sx] with the undilated cotangent as its filter: each
    # launch sums N*OH*OW terms, the count q8_fits bounds, and none of the
    # zeros that JAX's dilated cotangent multiplies
    hp, wp = (oy - 1) * sy + ky, (ox - 1) * sx + kx  # the extent taps read
    xp = F.pad(xt, (0, 0, px, max(0, wp - W - px), py, max(0, hp - H - py)))
    dw = torch.empty((ic, ky, kx, oc), dtype=torch.float32, device=x.device)
    for ry in range(min(sy, ky)):
        ny = -(-(ky - ry) // sy)
        for rx in range(min(sx, kx)):
            nx = -(-(kx - rx) // sx)
            xs = xp[:, ry:ry + (oy + ny - 2) * sy + 1:sy,
                    rx:rx + (ox + nx - 2) * sx + 1:sx]
            dw[:, ry::sy, rx::sx] = conv(xs.contiguous(), gq, s_x, s_g,
                                         None, (1, 1), (0, 0), False,
                                         torch.float32, 0.0)
    return dw.permute(3, 0, 1, 2)


def wgrad_q8_launches(stride, kern) -> int:
    """The qconv launches of one wgrad_q8: one per phase of the forward
    stride that holds a tap."""
    return min(stride[0], kern[0]) * min(stride[1], kern[1])


def wgrad_q8_plain(x, w, g, stride=(1, 1), pad=(0, 0)):
    """Plain PyTorch wgrad_q8: the same glue on act_quantize_plain,
    cotangent_quantize_plain and qconv_plain."""
    return _wgrad_q8(x, w, g, stride, pad, act_quantize_plain,
                     cotangent_quantize_plain, qconv_plain)


def wgrad_q8(x, w, g, stride=(1, 1), pad=(0, 0)):
    """The int8 weight gradient of a conv (grad_q8; the JAX package's
    mxu_grad._wgrad_q8, :170-205) on kernel B6: dW[o, i, ky, kx] =
    sum over n, oy, ox of x[n, oy*sy+ky-py, ox*sx+kx-px, i] * g[n, oy, ox, o],
    in int32 on x quantized per tensor (dynamic, act_quantize: max|x| / 127
    + 1e-30) and g quantized per output channel (quantize_filter's formula),
    times s_x * s_g[o] in f32.

    x: the forward's input, NHWC [N, H, W, I] (f32 or bf16); w: its OIHW
    filter (read for its shape); g: the cotangent of the conv's f32 output,
    NHWC [N, OH, OW, O]. Returns dW in f32, OIHW. B6 sees the batch as its
    channels: x quantized straight into [I, H, W, N], g into an [O, OH, OW,
    N] filter, stride 1 and the forward's padding; an asymmetric padding
    pads x explicitly, and a forward stride s > 1 runs one conv per phase of
    the taps on x's phase, both exact. Raises where N*OH*OW is over qconv's
    K bound (see mxu_grad.q8_fits). On CUDA tensors: one act_quantize, one
    cotangent_quantize and wgrad_q8_launches(stride, (ky, kx)) qconv
    launches."""
    return _wgrad_q8(x, w, g, stride, pad, act_quantize, cotangent_quantize,
                     qconv)
