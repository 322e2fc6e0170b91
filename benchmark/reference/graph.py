"""A plain PyTorch executor of a layer list: the reference that decides
`correct`, and the shapes every flop and byte count is taken from.

A net is a list of `Layer`s in execution order, each reading named
activations and writing one. The executor runs them with `torch.nn.functional`
in float32 (TF32 off, set by `run_reference`'s caller through `fp32_exact`),
holding each activation until its last reader has run. The layer semantics are
Caffe's deploy semantics:

- conv: cross-correlation with symmetric zero padding, a bias, an optional
  ReLU; in `groups` groups where the layer says (default 1): the input's
  channels and the outputs split into g equal blocks in order, output block
  j seeing input block j alone, so a filter is (out, cin / g, k, k);
- maxpool: Caffe's ceil-mode output size, padding that never wins the max;
- avgpool_global: the mean over the whole plane;
- lrn: across channels, x * (k + alpha / n * sum of x^2 over n channels
  centred on each) ^ -beta;
- concat: along channels, in the order given;
- add: the sum of the inputs, then an optional ReLU;
- dropout: the identity (inference).

The executor computes at the precision a cell declares (`prec`, the traffic's
`precision`): every activation is stored at `edges` (rounded to it once, where
the layer that makes it ends), and each float conv takes its operands at
`default`, products and sums in float32, the bias added in float32 before the
store. Without `prec` it is float32 throughout (the calibration's pass).

A conv layer may be quantized (`quant`): its stored input rounded to
`bits`-bit codes at a per-tensor scale, its float32 filter to `bits`-bit codes
at a per-output-channel scale, as symmetric integer quantization does, the
codes' sum taken in float32, then scaled and biased in float32 and stored.
This module imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

# the storage and operand types a precision names
DTYPES = {"f32": None, "bf16": torch.bfloat16}


def rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to dtype (round to nearest even) and held in float32;
    dtype None: x as it is."""
    return x if dtype is None else x.to(dtype).float()


@dataclass
class Layer:
    kind: str
    name: str
    ins: list
    out: str
    p: dict = field(default_factory=dict)


class Net:
    """A layer list with its input (C, H, W), the name of its input and of
    the logits it returns."""

    def __init__(self, layers: list, input_chw: tuple, data: str = "data",
                 logits: str = ""):
        self.layers = layers
        self.input_chw = tuple(input_chw)
        self.data = data
        self.logits = logits or layers[-1].out
        self.shapes = self._shapes()

    # ---- shapes ----
    def _shapes(self) -> dict:
        """{activation: (C, H, W)} for the input and every layer's output."""
        s = {self.data: self.input_chw}
        for L in self.layers:
            c, h, w = s[L.ins[0]]
            if L.kind == "conv":
                k, st, pd = L.p["k"], L.p["stride"], L.p["pad"]
                g = groups(L)
                if c % g or L.p["out"] % g:
                    raise ValueError(f"{L.name}: {g} groups do not divide "
                                     f"{c} inputs and {L.p['out']} outputs")
                s[L.out] = (L.p["out"], (h + 2 * pd - k) // st + 1,
                            (w + 2 * pd - k) // st + 1)
            elif L.kind == "maxpool":
                s[L.out] = (c, pool_out(h, L.p), pool_out(w, L.p))
            elif L.kind == "avgpool_global":
                s[L.out] = (c, 1, 1)
            elif L.kind == "concat":
                s[L.out] = (sum(s[i][0] for i in L.ins), h, w)
            elif L.kind in ("lrn", "add", "dropout"):
                s[L.out] = (c, h, w)
            else:
                raise ValueError(f"unknown layer kind '{L.kind}'")
        return s

    def convs(self) -> list:
        return [L for L in self.layers if L.kind == "conv"]

    def weight_shapes(self) -> list:
        """[(name, shape, fan_in)] of every filter and bias, in layer order,
        named as the deploy graph names its blobs: '<layer>_filts' (out,
        in / groups, k, k) and '<layer>_biases' (out,)."""
        out = []
        for L in self.convs():
            cin = self.shapes[L.ins[0]][0] // groups(L)
            k = L.p["k"]
            out.append((f"{L.name}_filts", (L.p["out"], cin, k, k),
                        cin * k * k))
            out.append((f"{L.name}_biases", (L.p["out"],), 0))
        return out

    # ---- forward ----
    def forward(self, x: torch.Tensor, w: dict, quant: dict | None = None,
                prec: dict | None = None, taps: set | None = None,
                tapped: dict | None = None):
        """Logits (N, classes) of the NCHW float32 input x under weights w
        ({blob: tensor}). quant: {conv name: (bits, act_absmax or None)}, the
        convs computed from integer codes (None: the scale of this input's
        own absmax). prec: the declared precision ({'default', 'edges'}),
        None for float32 throughout. taps / tapped: the absmax of the input
        of each conv named in taps is written into tapped (calibration)."""
        quant = quant or {}
        edge = DTYPES[prec["edges"]] if prec else None
        operand = DTYPES[prec["default"]] if prec else None
        last = {}
        for i, L in enumerate(self.layers):
            for n in L.ins:
                last[n] = i
        env = {self.data: rounded(x, edge)}
        for i, L in enumerate(self.layers):
            xs = [env[n] for n in L.ins]
            y = rounded(self._layer(L, xs, w, quant.get(L.name), operand),
                        edge)
            if taps is not None and L.name in taps:
                a = xs[0].abs().amax()
                tapped[L.name] = torch.maximum(tapped[L.name], a) \
                    if L.name in tapped else a
            for n in L.ins:
                if last[n] == i and n != L.out:
                    env.pop(n, None)
            env[L.out] = y
        return env[self.logits].flatten(1)

    def _layer(self, L: Layer, xs: list, w: dict, q, operand):
        x = xs[0]
        if L.kind == "conv":
            wt, b = w[f"{L.name}_filts"], w[f"{L.name}_biases"]
            st, pd, g = L.p["stride"], L.p["pad"], groups(L)
            if q is None:
                y = F.conv2d(rounded(x, operand), rounded(wt, operand), b,
                             st, pd, 1, g)
            else:
                bits, absmax = q
                xq, s_act = quantize_act(x, bits, absmax)
                wq, s_w = quantize_filter(wt, bits)
                y = F.conv2d(xq, wq, None, st, pd, 1, g) \
                    * (s_act * s_w)[None, :, None, None] \
                    + b[None, :, None, None]
            return F.relu(y) if L.p.get("relu") else y
        if L.kind == "maxpool":
            k, st, pd = L.p["k"], L.p["stride"], L.p["pad"]
            y = F.max_pool2d(x, k, st, pd, ceil_mode=True)
            want = (pool_out(x.shape[2], L.p), pool_out(x.shape[3], L.p))
            if tuple(y.shape[2:]) != want:
                raise ValueError(f"{L.name}: torch's ceil mode gives "
                                 f"{tuple(y.shape[2:])}, Caffe's {want}")
            return y
        if L.kind == "avgpool_global":
            return x.mean(dim=(2, 3), keepdim=True)
        if L.kind == "lrn":
            return F.local_response_norm(x, L.p["n"], L.p["alpha"],
                                         L.p["beta"], L.p.get("k", 1.0))
        if L.kind == "concat":
            return torch.cat(xs, dim=1)
        if L.kind == "add":
            y = xs[0]
            for t in xs[1:]:
                y = y + t
            return F.relu(y) if L.p.get("relu") else y
        if L.kind == "dropout":
            return x
        raise ValueError(f"unknown layer kind '{L.kind}'")


def groups(L: Layer) -> int:
    """The groups a conv layer's channels split into (1: ungrouped)."""
    return L.p.get("groups", 1)


def pool_out(n: int, p: dict) -> int:
    """Caffe's pooled size: ceil((n + 2 pad - k) / stride) + 1, less one
    where the last window would start in the bottom or right padding."""
    k, st, pd = p["k"], p["stride"], p["pad"]
    o = -(-(n + 2 * pd - k) // st) + 1
    if pd and (o - 1) * st >= n + pd:
        o -= 1
    return o


def quantize_act(x: torch.Tensor, bits: int, absmax):
    """(codes as float32, scale) of x at a per-tensor symmetric scale:
    s = float32(absmax / qmax) from the double quotient, codes =
    clamp(round-half-even(x / s), -qmax, qmax), with qmax = 2^(bits-1) - 1.
    absmax None: x's own absmax, s = max|x| / qmax + 1e-30 in float32. Every
    divisor is a tensor on x's device, so each quotient is one IEEE
    division."""
    qmax = float(2 ** (bits - 1) - 1)
    if absmax is None:
        s = x.abs().amax().float() / _on(qmax, x) + _on(1e-30, x)
    else:
        s = _on(float(absmax) / qmax, x)
    return torch.round(x / s).clamp_(-qmax, qmax), s


def quantize_filter(w: torch.Tensor, bits: int):
    """(codes as float32, per-output-channel scales) of an OIHW filter:
    s[o] = max |w[o]| / qmax + 1e-30, codes = clamp(round(w / s), ±qmax),
    each step in float32."""
    qmax = float(2 ** (bits - 1) - 1)
    s = w.abs().amax(dim=(1, 2, 3)) / _on(qmax, w) + _on(1e-30, w)
    return torch.round(w / s[:, None, None, None]).clamp_(-qmax, qmax), s


def _on(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as a one-element float32 tensor on like's device."""
    return torch.full((1,), v, dtype=torch.float32, device=like.device)


@contextlib.contextmanager
def fp32_exact():
    """float32 convs and matmuls in full FP32: TF32 off for cuDNN and
    cuBLAS, restored on exit."""
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = mm.allow_tf32, cd.allow_tf32
    mm.allow_tf32 = cd.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cd.allow_tf32 = prev


def run_reference(net: Net, x: torch.Tensor, w: dict, quant=None,
                  prec: dict | None = None, rows: int = 32) -> torch.Tensor:
    """net.forward over x in blocks of `rows` images (so it fits beside
    nothing else), at the declared precision `prec`, float32 with TF32 off;
    the logits on the host."""
    outs = []
    with torch.no_grad(), fp32_exact():
        for i in range(0, x.shape[0], rows):
            outs.append(net.forward(x[i:i + rows], w, quant, prec).cpu())
    return torch.cat(outs)


def conv_flops(net: Net, L: Layer) -> int:
    """Multiply-adds x 2 of one conv layer at batch 1: each output sums
    over its group's cin / groups input channels."""
    cin = net.shapes[L.ins[0]][0] // groups(L)
    c, h, w = net.shapes[L.out]
    return 2 * c * h * w * cin * L.p["k"] ** 2


def total_flops(net: Net) -> int:
    return sum(conv_flops(net, L) for L in net.convs())


def numel(shape) -> int:
    return math.prod(shape)
