"""The mixed-precision conv VJP and the output-mask ReLU of the vendor convs.

Port of boda_tpu/ops/mxu_grad.py. The vendor convs (xla_conv, xla_conv2,
s2d_conv, deconv: ops/cuda/conv.vendor_conv) compute the f32 conv of their
operands rounded to the compute dtype `cd`. Autograd through that forward
would run FP32 grad convs, never round the cotangent or the gradients to
bf16, and keep an f32 copy of every conv input. `MxuConv` is the counterpart
of the JAX package's `mxu_conv` custom VJP instead:

- forward: exactly vendor_conv's arithmetic (full FP32 on the rounded
  operands), so no inference number moves; it saves the `cd` operands, the
  stored bf16 edge itself where x arrives bf16;
- backward: the cotangent rounded to `cd`, then dx and dW as convs of `cd`
  operands with f32 sums and one rounding to `cd`, widened to the callers'
  dtypes (f32 master weights stay f32). `conv_backward_plain` is that
  function in full FP32 on the rounded values, rounded once; on a card
  under cd = bf16 the grad convs are torch's bf16 cuDNN
  `convolution_backward` (f32 sums, one rounding), as the JAX package
  leaves them to XLA. The bias gradient is autograd's f32 sum of g.
- grad_q8 (OpTune grad_q8): the weight gradient on kernel B6
  (ops/cuda/qconv.wgrad_q8, the JAX `_wgrad_q8`), dx stays bf16. Taken only
  where the JAX package takes it (`grad_q8_site`: a float xla_conv in NHWC
  form, xla_conv2) and where the int32 sums cannot overflow (`q8_fits`,
  mxu_grad.py:143-150); elsewhere the bf16 VJP.

`relu_store` is the output-residual ReLU of mxu_grad.py:34-79: its backward
masks g by out > 0 and keeps the stored output, not the f32 pre-activation.

`INFERENCE_ONLY` names the templates with no backward in the JAX package
(its Pallas kernels, and the int8 forward forms): `step_has_backward` is
what build_forward and the trainer check before a forward under autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.error import RtErr
from .cuda.util import full_fp32, use_kernel

# templates whose forward has no backward: the Pallas kernels B1/B2/B4/B5
# (k1conv, conv, ipconv, tconv, fused_stem, resblock, sgemm) and the int8
# sgemm; the int8 forms (quant8) of xla_conv/xla_conv2 are checked per sig
INFERENCE_ONLY = ("k1conv", "conv", "ipconv", "tconv", "fused_stem",
                  "resblock", "sgemm", "sgemm_int8")
# int32-overflow bound of the int8 weight gradient: N*OH*OW int8 x int8
# products summed per dW entry (mxu_grad.py:143-150)
Q8_SUM_MAX = 2 ** 31


def step_has_backward(sig) -> bool:
    """False for a step of an inference-only template (INFERENCE_ONLY, or an
    int8 forward form of xla_conv/xla_conv2)."""
    fn = sig.func_name
    if fn in INFERENCE_ONLY:
        return False
    return not (fn in ("xla_conv", "xla_conv2")
                and sig.get_u32_or("quant8", 0))


def check_trainable(steps, what: str) -> None:
    """Raise naming the first step (call tag and template) that has no
    backward, as the JAX package does at transpose time."""
    for s in steps:
        if not step_has_backward(s.sig):
            raise RtErr(f"{what}: step {s.call_tag} runs template "
                        f"'{s.sig.func_name}'"
                        f"{' (quant8)' if s.sig.get_u32_or('quant8', 0) else ''}"
                        f", which has no backward (inference-only in the JAX "
                        f"package too); train with a vendor tune such as "
                        f"(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,"
                        f"fuse_siblings=1)")


# ---------------------------------------------------------------- relu_store

class _ReluStore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dt):
        out = torch.relu(y.to(dt))
        ctx.save_for_backward(out)
        ctx.ydt = y.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return torch.where(out > 0, g, torch.zeros((), dtype=g.dtype,
                                                   device=g.device)) \
            .to(ctx.ydt), None


def relu_store(y: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """relu(y) rounded to dt, with an output-residual VJP: the same values
    as relu(y).to(dt) (rounding keeps the sign; relu(-0) = +0), and under
    autograd the backward keeps `out` (the stored edge) instead of torch
    relu's f32 output, masking g by out > 0."""
    if torch.is_grad_enabled() and y.requires_grad:
        return _ReluStore.apply(y, dt)
    return torch.relu(y.to(dt))


# ---------------------------------------------------------------- the conv

def _conv_fwd(xc, wc, stride, pad, transposed, nhwc, groups=1):
    """f32 conv of the rounded operands in full FP32 (vendor_conv's
    arithmetic), in `groups` groups; under NHWC storage (nhwc: x is the channels_last view of
    an NHWC tensor) the filter goes channels_last too, so the result comes
    back channels_last."""
    if nhwc:
        wc = wc.contiguous(memory_format=torch.channels_last)
    conv_fn = F.conv_transpose2d if transposed else F.conv2d
    with full_fp32():
        return conv_fn(xc.float(), wc.float(), stride=stride, padding=pad,
                       groups=groups)


def conv_backward_plain(gc, xc, wc, stride, pad, transposed, mask,
                        groups=1):
    """(dx, dW) of the conv of xc, wc (both in cd, in `groups` groups) for the cotangent gc (in
    cd): full-FP32 grad convs on the rounded values, each rounded once to
    cd; None where mask says so."""
    cd = xc.dtype
    with full_fp32():
        dx, dw, _ = torch.ops.aten.convolution_backward(
            gc.float(), xc.float(), wc.float(), None, list(stride), list(pad),
            [1, 1], transposed, [0, 0], groups, [mask[0], mask[1], False])
    return (None if dx is None else dx.to(cd),
            None if dw is None else dw.to(cd))


def conv_backward(gc, xc, wc, stride, pad, transposed, mask, groups=1):
    """conv_backward_plain's function where the tensors lie on the CPU or
    cd is f32; on the card under cd = bf16, torch's bf16 cuDNN
    convolution_backward (f32 sums, one rounding to bf16)."""
    if xc.dtype == torch.float32 or not use_kernel(gc, xc, wc):
        return conv_backward_plain(gc, xc, wc, stride, pad, transposed, mask,
                                   groups)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        gc, xc, wc, None, list(stride), list(pad), [1, 1], transposed, [0, 0],
        groups, [mask[0], mask[1], False])
    return dx, dw


def grad_q8_site(sig, nhwc: bool) -> bool:
    """Whether a vendor conv step of sig takes the int8 weight gradient: a
    grad_q8 sig of a float conv in the JAX package's NHWC form (nhwc: the
    template's conv runs on NHWC operands there; mxu_grad.py:123-130 keeps
    the bf16 VJP for every other form)."""
    return nhwc and sig.get_u32_or("grad_q8", 0) == 1 \
        and not sig.get_u32_or("quant8", 0)


def q8_fits(n: int, oy: int, ox: int) -> bool:
    """The int8 weight gradient's static overflow guard: its N*OH*OW-term
    int32 sums stay below 2^31 at the worst case 127^2 per product. Each
    B6 launch of wgrad_q8 sums exactly that many (a forward stride runs
    one launch per phase, not a dilated cotangent)."""
    return n * oy * ox * 127 * 127 < Q8_SUM_MAX


class MxuConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, pad, cd, transposed, nhwc, q8, groups):
        xc, wc = x.to(cd), w.to(cd)
        if nhwc:
            wc = wc.contiguous(memory_format=torch.channels_last)
        ctx.save_for_backward(xc, wc)
        ctx.conf = (stride, pad, transposed, q8, x.dtype, w.dtype, groups)
        return _conv_fwd(xc, wc, stride, pad, transposed, nhwc, groups)

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        stride, pad, transposed, q8, xdt, wdt, groups = ctx.conf
        need_x, need_w = ctx.needs_input_grad[:2]
        q8 = q8 and need_w and q8_fits(g.shape[0], g.shape[2], g.shape[3])
        gc = g.to(xc.dtype)
        dx, dw = conv_backward(gc, xc, wc, stride, pad, transposed,
                               (need_x, need_w and not q8), groups)
        if q8:
            from .cuda.qconv import wgrad_q8
            dw = wgrad_q8(xc.permute(0, 2, 3, 1), wc, g.permute(0, 2, 3, 1),
                          stride, pad).to(xc.dtype)
        return (None if dx is None else dx.to(xdt),
                None if dw is None else dw.to(wdt), None, None, None, None,
                None, None, None)


def mxu_conv(x, w, stride, pad, cd: torch.dtype, transposed: bool = False,
             nhwc: bool = False, q8: bool = False,
             groups: int = 1) -> torch.Tensor:
    """The f32 conv (F.conv2d in `groups` groups, or F.conv_transpose2d with an (in_chan,
    out_chan, ky, kx) filter where transposed) of x and w rounded to cd, in
    full FP32; x is a logical NCHW tensor, the channels_last view of an NHWC
    one where nhwc. Under autograd it carries MxuConv's VJP (q8: the int8
    weight gradient on B6, where the caller's conv is one the JAX package
    takes it for); otherwise it is that forward alone."""
    stride, pad = tuple(stride), tuple(pad)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MxuConv.apply(x, w, stride, pad, cd, transposed, nhwc, q8,
                             groups)
    return _conv_fwd(x.to(cd), w.to(cd), stride, pad, transposed, nhwc,
                     groups)
