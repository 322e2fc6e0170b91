"""qconv (kernel B6), the int8 convolution of the selective-int8 preset;
act_quantize, the activation quantize that makes its input; and wgrad_q8,
training's int8 weight gradient (grad_q8) on the same two kernels.

Port of the int8 forms of the vendor conv: boda_tpu/ops/pallas/conv.py
XlaConv.build (:162-266) and boda_tpu/ops/pallas/conv2.py XlaConv2.build
(:139-193), an XLA conv_general_dilated on int8 operands with int32
results. Torch has no int8 conv on CUDA, so both wrappers launch the
hand-written kernels of csrc/qconv.cu (see its header for what bounds them
and how they are built): `qconv`, an implicit-GEMM conv on the int8 `wgmma`
route of the GEMM core, and `act_quantize`, one launch for a static scale and
two for a dynamic one. `qconv_plan` is the kernel's plan on util.gemm_plan;
`qconv_plain` and `act_quantize_plain` are the same functions in plain
PyTorch. Each wrapper runs the plain version for CPU tensors and the kernel
for CUDA tensors.

The arithmetic is the JAX template's, operation for operation, each one f32
rounding: s_act = float32(act_absmax / 127) from the double quotient (a
static scale, conv.py:168) or max|x| / 127 + 1e-30 in f32 (a dynamic one);
xq = clamp(rint(x / s_act), -127, 127) with IEEE division; the exact int32
sum, converted to f32, times s_act * sws[o], plus the bias, ReLU, and the
store: f32, bf16, or an int8 edge at clamp(rint(v * float32(127 /
out_absmax)), -127, 127) (conv.py:173-179). So kernel, plain version and
JAX template agree bit for bit where XLA rounds the same way.

wgrad_q8 is boda_tpu/ops/mxu_grad.py's _wgrad_q8 (:170-205) as glue around
them: the activation quantized per tensor, the cotangent per output
channel (quantize_filter's formula), the batch as B6's channels, one
stride-1 B6 conv per phase of a forward stride (where JAX dilates the
cotangent); wgrad_q8_plain is the same glue on the plain versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...core.error import RtErr
from .build import check_launch, load_kernels
from .qsgemm import K_MAX
from .util import GemmPlan, check_operand, cuda_stream, forbid_autograd, \
    gemm_plan, sm_count, use_kernel

TILE_N = 128                 # block tile: 128 pixels x 128 output channels
_N_MAX = 65535 * TILE_N      # the grid puts oc / 128 tiles on gridDim.y
# no split-K (util.gemm_plan's rule: split grids of fewer than 0 tiles)
SPLIT = {torch.int8: (0, 1, 1, 1)}
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


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

def _check_x(x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype not in (torch.float32,
                                                          torch.bfloat16):
        raise RtErr("act_quantize: x must be an f32 or bf16 tensor")
    if not x.is_contiguous() or x.numel() < 1:
        raise RtErr(f"act_quantize: x must be contiguous and non-empty, got "
                    f"shape {tuple(x.shape)}")


def act_quantize_plain(x: torch.Tensor, act_absmax: float = 0.0):
    """Plain PyTorch act_quantize: (xq int8 of x's shape, s_act as an f32 [1]
    tensor on x's device)."""
    _check_x(x)
    xf = x.float()
    if act_absmax:
        s = torch.full((1,), static_act_scale(act_absmax), device=x.device)
    else:
        s = (xf.abs().amax() / torch.full((), 127.0, device=x.device)
             + torch.full((), 1e-30, device=x.device)).reshape(1)
    return torch.round(xf / s).clamp_(-127, 127).to(torch.int8), s


def act_quantize(x: torch.Tensor, act_absmax: float = 0.0):
    """xq = clamp(rint(x / s_act), -127, 127) of an f32 or bf16 tensor, any
    layout (contiguous), and s_act: float32(act_absmax / 127) where a static
    act_absmax is given, else max|x| / 127 + 1e-30 computed on the card.
    Returns (xq int8 of x's shape, s_act as an f32 [1] tensor on x's device).

    On CUDA tensors the launches (one static, two dynamic; counted once in
    act_quantize.launches) are asynchronous on the current stream: the host
    never waits for a dynamic scale, which qconv reads from device memory. A
    NaN in x gives a NaN dynamic scale; an element whose quotient is NaN
    quantizes to 0."""
    _check_x(x)
    forbid_autograd("act_quantize", x)
    if not use_kernel(x):
        return act_quantize_plain(x, act_absmax)
    lib = load_kernels()
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    ws = torch.empty(lib.boda_act_quantize_ws_floats(), dtype=torch.float32,
                     device=x.device)
    rc = lib.boda_act_quantize(
        x.data_ptr(), xq.data_ptr(), ws.data_ptr(), x.numel(),
        int(x.dtype == torch.bfloat16),
        static_act_scale(act_absmax) if act_absmax else 0.0,
        int(not act_absmax), cuda_stream(x.device))
    check_launch(rc, "act_quantize")
    act_quantize.launches += 1
    return xq, ws[:1]


act_quantize.launches = 0


# ---------------------------------------------------------------- the conv

@functools.lru_cache(maxsize=4096)
def qconv_plan(n: int, H: int, W: int, C: int, oc: int, ky: int, kx: int,
               stride: tuple[int, int], pad: tuple[int, int],
               sms: int) -> GemmPlan:
    """The kernel's plan for xq [n, H, W, C] and an [oc, ky, kx, C] filter:
    the implicit GEMM of n*oy*ox pixels by oc channels over ky*kx*C on 128 x
    128 tiles of the int8 route, 16-channel copies where C % 16 == 0, no K
    split (util.gemm_plan)."""
    oy = (H + 2 * pad[0] - ky) // stride[0] + 1
    ox = (W + 2 * pad[1] - kx) // stride[1] + 1
    return gemm_plan("qconv_plan", n * oy * ox, oc, ky * kx * C, C, TILE_N,
                     torch.int8, sms, SPLIT)


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
    if max(xq.numel(), wq.numel(), n * oy * ox * oc) >= 2 ** 31 \
            or oc > _N_MAX:
        raise RtErr(f"qconv: extent over int32 or oc over {_N_MAX}")
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
    y = acc.float() * (s_act * sws)[None, :, None, None]
    if bias is not None:
        y = y + bias[None, :, None, None]
    if relu:
        y = torch.relu(y)
    y = y.permute(0, 2, 3, 1)
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

    On CUDA tensors the launch is asynchronous on the current stream,
    counted in qconv.launches."""
    n, H, W, C, oc, ky, kx, oy, ox = _check(xq, wq, s_act, sws, bias, stride,
                                            pad, out_dtype, out_absmax)
    forbid_autograd("qconv", s_act, sws, bias)
    if not use_kernel(xq, wq, s_act, sws, bias):
        return qconv_plain(xq, wq, s_act, sws, bias, stride, pad, relu,
                           out_dtype, out_absmax)
    plan = qconv_plan(n, H, W, C, oc, ky, kx, tuple(stride), tuple(pad),
                      sm_count(xq.device.index))
    # torch allocations are 256-byte aligned; a view into one may not be
    vec = plan.vec and xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    out = torch.empty((n, oy, ox, oc), dtype=out_dtype, device=xq.device)
    rc = load_kernels().boda_qconv(
        xq.data_ptr(), wq.data_ptr(), s_act.data_ptr(), sws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        n, H, W, C, oc, ky, kx, stride[0], stride[1], pad[0], pad[1],
        int(bool(relu)), OUT_DTYPES.index(out_dtype),
        out_q_scale(out_absmax) if out_dtype == torch.int8 else 0.0,
        int(vec), cuda_stream(xq.device))
    check_launch(rc, "qconv")
    qconv.launches += 1
    return out


qconv.launches = 0


# ------------------------------------------------------- the weight gradient

def _wgrad_q8(x, w, g, stride, pad, quantize, conv):
    """wgrad_q8's glue around the activation quantize and the conv it is
    given (the kernels' wrappers, or their plain versions)."""
    oc, ic, ky, kx = w.shape
    n, H, W, _ = x.shape
    _, oy, ox, _ = g.shape
    # per-tensor activation scale over all of x, before any crop
    xq, s_x = quantize(x.contiguous())
    # per-O cotangent scale: quantize_filter over g as an [O, OH, OW, N]
    # "filter" (B6's OHWI), the JAX _wgrad_q8's s_g over (N, OH, OW)
    gq, s_g = quantize_filter(g.permute(3, 1, 2, 0))
    gq, s_g = gq.contiguous(), s_g.float().contiguous()
    (sy, sx), (py, px) = stride, pad
    xt = xq.permute(3, 1, 2, 0)        # [I, H, W, N]: B6's NHWC, C = batch
    if (sy, sx) == (1, 1):
        # pad_hi of the transposed conv (mxu_grad.py:196-200): the output
        # extent is exactly (ky, kx); where it is not pad_lo, pad (or crop)
        # x explicitly (quantized zero is 0)
        hy, hx = oy - H + ky - py - 1, ox - W + kx - px - 1
        if (hy, hx) != (py, px):
            xt = F.pad(xt, (0, 0, px, hx, py, hy))
            py = px = 0
        dw = conv(xt.contiguous(), gq, s_x, s_g, None, (1, 1), (py, px),
                  False, torch.float32, 0.0)
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
    """Plain PyTorch wgrad_q8: the same glue on act_quantize_plain and
    qconv_plain."""
    return _wgrad_q8(x, w, g, stride, pad, act_quantize_plain, qconv_plain)


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
    channels: x as [I, H, W, N], g as an [O, OH, OW, N] filter, stride 1
    and the forward's padding; an asymmetric padding pads x explicitly, and
    a forward stride s > 1 runs one conv per phase of the taps on x's
    phase, both exact. Raises where N*OH*OW is over qconv's K bound (see
    mxu_grad.q8_fits). On CUDA tensors: one act_quantize and
    wgrad_q8_launches(stride, (ky, kx)) qconv launches."""
    return _wgrad_q8(x, w, g, stride, pad, act_quantize, qconv)
