#!/usr/bin/env python3
"""Kernel B6 (the int8 conv of boda_tpu_torch/csrc/qconv.cu) and the quantize
passes around it, timed on one CUDA card for the checkout at --root.

    python3 scripts/b6_times.py --root DIR [--out FILE]

Only the wrappers' public functions are called (qconv, act_quantize,
quantize_filter, wgrad_q8, and cotangent_quantize where the checkout has
it), so the same script times two checkouts of the port, e.g. a commit and
its parent, in one process each on the same card: run it for each in turns
(parent, change, change, parent) and compare within the call.

Cases, inputs from a seed on the card: the selective-int8 preset's nine
distinct ResNet-50 conv shapes at batch 32 and two at batch 128 (x bf16,
a static scale, bf16 or f32 out as the preset stores them); GoogLeNet's
five int8 shapes at batch 128; the grad_q8 preset's four weight gradients
at batch 32 (the kernel alone on B6's operands as wgrad_q8 forms them, the
passes that form them from x and the cotangent, and wgrad_q8 whole). Every
time is the card's alone: the calls captured in a CUDA graph, the graph
replayed between CUDA events, the median of three windows. Each kernel
result is checked against the checkout's plain version (bit-equal). One
JSON line per case, then one with the card's name and power limit."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (label, n, H, C, oc, k, stride, pad, relu, out)
FWD = [("res3 3x3 n=32", 32, 28, 128, 128, 3, 1, 1, True, "bf16"),
       ("res4a pair 1x1/s2 n=32", 32, 28, 512, 1280, 1, 2, 0, False, "f32"),
       ("res4 3x3 n=32", 32, 14, 256, 256, 3, 1, 1, True, "bf16"),
       ("res4 1x1 256->1024 n=32", 32, 14, 256, 1024, 1, 1, 0, False, "bf16"),
       ("res4 1x1 1024->256 n=32", 32, 14, 1024, 256, 1, 1, 0, True, "bf16"),
       ("res5a pair 1x1/s2 n=32", 32, 14, 1024, 2560, 1, 2, 0, False, "f32"),
       ("res5 3x3 n=32", 32, 7, 512, 512, 3, 1, 1, True, "bf16"),
       ("res5 1x1 512->2048 n=32", 32, 7, 512, 2048, 1, 1, 0, False, "bf16"),
       ("res5 1x1 2048->512 n=32", 32, 7, 2048, 512, 1, 1, 0, True, "bf16"),
       ("res3 3x3 n=128", 128, 28, 128, 128, 3, 1, 1, True, "bf16"),
       ("res4a pair 1x1/s2 n=128", 128, 28, 512, 1280, 1, 2, 0, False, "f32"),
       ("googlenet 3a/5x5 n=128", 128, 28, 16, 32, 5, 1, 2, True, "bf16"),
       ("googlenet 3b/5x5 n=128", 128, 28, 32, 96, 5, 1, 2, True, "bf16"),
       ("googlenet 4b/5x5 n=128", 128, 14, 24, 64, 5, 1, 2, True, "bf16"),
       ("googlenet 5b/5x5 n=128", 128, 7, 48, 128, 5, 1, 2, True, "bf16"),
       ("googlenet 3a/3x3 n=128", 128, 28, 96, 128, 3, 1, 1, True, "bf16")]
# the grad_q8 preset's weight gradients at b32: (label, n, hw, I, O, k)
WGRAD = [("wgrad res3 3x3", 32, 28, 128, 128, 3),
         ("wgrad res4 3x3", 32, 14, 256, 256, 3),
         ("wgrad res5 3x3", 32, 7, 512, 512, 3),
         ("wgrad res5 1x1 2c", 32, 7, 512, 2048, 1)]


def _timer():
    import torch

    def ms(fn, reps: int = 20) -> float:
        """The card's time of fn() alone: reps calls in one CUDA graph,
        replayed 5 times per window between events, median of 3 windows."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        times = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                g.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / (5 * reps))
        return sorted(times)[1]
    return ms


def _equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def fwd_cases(qc, ms, dev, gen) -> list[dict]:
    import torch
    odt = {"bf16": torch.bfloat16, "f32": torch.float32}
    rows = []
    for label, n, H, C, oc, k, s, p, relu, out in FWD:
        x = torch.randn(n, H, H, C, device=dev, generator=gen).bfloat16()
        absmax = 0.8 * float(x.float().abs().max())
        xq, s_act = qc.act_quantize(x, absmax)
        wq = torch.randint(-127, 128, (oc, k, k, C), device=dev,
                           generator=gen, dtype=torch.int8)
        sws = torch.rand(oc, device=dev, generator=gen) * 2e-3 + 1e-4
        bias = torch.randn(oc, device=dev, generator=gen)
        args = (xq, wq, s_act, sws, bias, (s, s), (p, p), relu, odt[out],
                0.0)
        ok = _equal(qc.qconv(*args), qc.qconv_plain(*args))
        rows.append({"case": label, "ms": ms(lambda: qc.qconv(*args)),
                     "quantize_ms": ms(lambda: qc.act_quantize(x, absmax)),
                     "bit_equal": ok})
    return rows


def wgrad_cases(qc, ms, dev, gen) -> list[dict]:
    import torch
    rows = []
    new = hasattr(qc, "cotangent_quantize")
    for label, n, hw, ci, co, k in WGRAD:
        p = k // 2
        x = torch.relu(torch.randn(n, hw, hw, ci, device=dev,
                                   generator=gen)).to(torch.bfloat16)
        g = (torch.randn(n, hw, hw, co, device=dev, generator=gen) * 1e-3) \
            .to(torch.bfloat16).float()
        w = torch.empty(co, ci, k, k, device=dev, dtype=torch.bfloat16)

        if new:
            def passes():
                xt, s_x = qc.act_quantize(x, 0.0, True)
                gq, s_g = qc.cotangent_quantize(g)
                return xt, s_x, gq, s_g
        else:
            def passes():
                xq, s_x = qc.act_quantize(x)
                gq, s_g = qc.quantize_filter(g.permute(3, 1, 2, 0))
                return (xq.permute(3, 1, 2, 0).contiguous(), s_x,
                        gq.contiguous(), s_g.float().contiguous())
        xt, s_x, gq, s_g = passes()
        args = (xt, gq, s_x, s_g, None, (1, 1), (p, p), False, torch.float32,
                0.0)
        ok = _equal(qc.qconv(*args), qc.qconv_plain(*args)) and _equal(
            qc.wgrad_q8(x, w, g, (1, 1), (p, p)),
            qc.wgrad_q8_plain(x, w, g, (1, 1), (p, p)))
        rows.append({"case": label, "ms": ms(lambda: qc.qconv(*args)),
                     "quantize_ms": ms(passes),
                     "wgrad_q8_ms": ms(lambda: qc.wgrad_q8(x, w, g, (1, 1),
                                                           (p, p))),
                     "bit_equal": ok})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="the checkout whose boda_tpu_torch is timed")
    ap.add_argument("--out", default="", help="also append the lines here")
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("b6_times: no CUDA card", file=sys.stderr)
        return 1
    from boda_tpu_torch.ops.cuda import qconv as qc
    if not Path(qc.__file__).resolve().is_relative_to(root):
        print(f"b6_times: imported {qc.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = _timer()
    lines = [{"root": str(root), "kind": "fwd", **r}
             for r in fwd_cases(qc, ms, dev, gen)]
    lines += [{"root": str(root), "kind": "wgrad", **r}
              for r in wgrad_cases(qc, ms, dev, gen)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines.append({"root": str(root), "card": smi})
    text = "\n".join(json.dumps(ln) for ln in lines)
    print(text)
    if opts.out:
        with open(opts.out, "a") as f:
            f.write(text + "\n")
    return 0 if all(ln.get("bit_equal", True) for ln in lines) else 2


if __name__ == "__main__":
    sys.exit(main())
