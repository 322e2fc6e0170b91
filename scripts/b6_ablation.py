#!/usr/bin/env python3
"""What bounds kernel B6 (boda_tpu_torch/csrc/qconv.cu) on a CUDA card:
the kernel rebuilt with one part taken out or changed at a time, each
variant timed alone at ResNet-50 shapes on the same card.

    python3 scripts/b6_ablation.py [--out FILE]

Variants (text edits of qconv.cu, each built by its own nvcc into
build/b6_ablation/; the source in the checkout is not touched):
  base      the kernel as it is
  no_mma    the consumers issue no wgmma (they still wait for each stage,
            free it and store): the time of the pipeline's copies alone
  no_a      the producers copy no A (the conv window); B still comes by
            TMA: the time without the threads' cp.async copies
  ring3     a ring of 3 stages instead of 4
  ring5     a ring of 5 stages (the epilogue staging cut to bf16 rows, so
            only unsplit bf16 cases run)
  prod128   one producer warpgroup instead of two
no_mma and no_a give wrong results (they are timings, not kernels); the
other variants are checked bit-equal against qconv_plain. Each time is the
card's alone: 20 calls in a CUDA graph, replayed between CUDA events,
median of three windows. One line per shape, then the card's name and
power limit."""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "boda_tpu_torch" / "csrc"
OUT = ROOT / "build" / "b6_ablation"
sys.path.insert(0, str(ROOT))

# variant -> [(regex in qconv.cu, replacement)]; each must match once
VARIANTS = {
    "base": [],
    "no_mma": [(r"#pragma unroll\n(\s*)for \(int ks = 0; ks < kRowBytes / 32; "
                r"\+\+ks\) wgmma\(acc, da \+ 2 \* ks, db \+ 2 \* ks\);",
                r"\1// no wgmma")],
    "no_a": [(r"case 16: stage_a<16>\(s, x, pix, tap, sa, sa_p\); break;",
              "case 16: break;")],
    "ring3": [(r"constexpr int kRing = 4;", "constexpr int kRing = 3;")],
    "ring5": [(r"constexpr int kRing = 4;", "constexpr int kRing = 5;"),
              (r"constexpr int kEpiStride = 128 \* 4 \+ 32;",
               "constexpr int kEpiStride = 128 * 2 + 16;")],
    "prod128": [(r"constexpr int kProducers = 256;",
                 "constexpr int kProducers = 128;")],
}
WRONG = ("no_mma", "no_a")          # timings only
BF16_UNSPLIT_ONLY = ("ring5",)
# (label, n, H, C, oc, k, stride, pad, splits or None for the plan's)
SHAPES = [("res3 3x3 b32", 32, 28, 128, 128, 3, 1, 1, None),
          ("res4 3x3 b32", 32, 14, 256, 256, 3, 1, 1, None),
          ("res5 3x3 b32 unsplit", 32, 7, 512, 512, 3, 1, 1, 1),
          ("res5 3x3 b32", 32, 7, 512, 512, 3, 1, 1, None),
          ("res4a pair b32", 32, 28, 512, 1280, 1, 2, 0, None),
          ("res3 3x3 b128", 128, 28, 128, 128, 3, 1, 1, None),
          ("wgrad res3 3x3", 128, 28, 32, 128, 28, 1, 1, None),
          ("wgrad res5 3x3", 512, 7, 32, 512, 7, 1, 1, None)]


def build(name: str, edits) -> Path:
    src = (CSRC / "qconv.cu").read_text()
    for pat, rep in edits:
        src, n = re.subn(pat, rep, src)
        if n != 1:
            raise SystemExit(f"b6_ablation: variant {name}: {pat!r} matched "
                             f"{n} times in qconv.cu")
    cu = OUT / f"qconv_{name}.cu"
    cu.write_text(src)
    lib = OUT / f"lib_{name}.so"
    from boda_tpu_torch.core.device import nvcc_path
    from boda_tpu_torch.ops.cuda.build import ARCH_FLAGS
    subprocess.run([nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}", "-o",
                    str(lib), str(cu)], check=True, capture_output=True)
    return lib


def graph_ms(fn, reps: int = 20) -> float:
    import torch
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also append the lines here")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("b6_ablation: no CUDA card", file=sys.stderr)
        return 1
    from boda_tpu_torch.ops.cuda.build import ENTRY_POINTS
    from boda_tpu_torch.ops.cuda.qconv import COPY_WIDTHS, qconv_plain, \
        qconv_plan
    from boda_tpu_torch.ops.cuda.util import copy_width
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        paths = dict(zip(VARIANTS, ex.map(lambda kv: build(*kv),
                                          VARIANTS.items())))
    fns = {}
    for name, path in paths.items():
        fn = ctypes.CDLL(str(path)).boda_qconv
        fn.argtypes = ENTRY_POINTS["boda_qconv"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lines, ok = [], True
    for label, n, H, C, oc, k, st, p, sp in SHAPES:
        xq = torch.randint(-127, 128, (n, H, H, C), device=dev, generator=gen,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (oc, k, k, C), device=dev,
                           generator=gen, dtype=torch.int8)
        s_act = torch.full((1,), 0.02, device=dev)
        sws = torch.rand(oc, device=dev, generator=gen) * 1e-3
        bias = torch.randn(oc, device=dev, generator=gen)
        plan = qconv_plan(n, H, H, C, oc, k, k, (st, st), (p, p), sms)
        full = plan.full if sp is None else 0
        sp = sp or plan.splits
        tiles_n = -(-oc // 128)
        m_split = full // tiles_n * 128
        oy = (H + 2 * p - k) // st + 1
        out = torch.empty(n, oy, oy, oc, device=dev, dtype=torch.bfloat16)
        ws = torch.empty(sp, n * oy * oy - m_split, oc, device=dev,
                         dtype=torch.int32)
        want = qconv_plain(xq, wq, s_act, sws, bias, (st, st), (p, p), True,
                           torch.bfloat16)
        row = {}
        for name, fn in fns.items():
            if name in BF16_UNSPLIT_ONLY and sp > 1:
                continue

            def run(fn=fn):
                rc = fn(xq.data_ptr(), wq.data_ptr(), s_act.data_ptr(),
                        sws.data_ptr(), bias.data_ptr(), out.data_ptr(),
                        ws.data_ptr(), n, H, H, C, oc, k, k, st, st, p, p, 1,
                        1, 0.0, copy_width(C, 0, COPY_WIDTHS),
                        copy_width(k * k * C, 0, COPY_WIDTHS), full,
                        sp, min(full + (plan.blocks - full) * sp, sms),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed {rc}")
            out.zero_()
            run()
            torch.cuda.synchronize()
            equal = bool((out == want).all())
            if name not in WRONG and not equal:
                ok = False
            row[name] = round(graph_ms(run), 5)
        line = f"{label}: tiles {plan.blocks} chunks {plan.chunks} splits " \
               f"{sp} past {full if sp > 1 else plan.blocks} whole; ms " \
               + " ".join(f"{k} {v:.4f}" for k, v in row.items())
        lines.append(line)
        print(line, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines.append(f"card: {smi}; checked variants bit-equal: {ok}")
    print(lines[-1])
    if opts.out:
        with open(opts.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
