#!/usr/bin/env python3
"""Smoke test of the boda_tpu_torch port on one CUDA card.

    python3 chip_smoke.py [--phases env,build,kernels,...] [--kernels fused_stem,...]

Phases, run in order, each fatal on failure (all of them by default):
  env      card name and power limit (nvidia-smi), torch / CUDA / nvcc versions
  build    nvcc builds the hand-written kernels (boda_tpu_torch/csrc) for sm_90a
  kernels  each kernel against its plain PyTorch version at the ResNet-50
           shapes of its path (timed with CUDA events) and at ragged edge
           shapes (tconv: C not a multiple of 8, M and oc not multiples of
           its 128 tile, split K), f32 (mrd <= 1e-4) and bf16 (mrd <=
           5e-3); matmul_ext's plan (route, tile, K splits) for each case,
           with edges for split-K at M=1, K not a multiple of 8 (the
           element-staging variant) and offsets past 2^31; the fused_stem
           template's NCHW f32 and NHWC-storage bf16 forms against the bare
           kernel, fused_stem's plan (route, tile, blocks) for each case, a
           bf16 output held bit-equal to the same kernel's f32 output rounded
           after, and edges for what its routes mask (oc = 8 and 72, C = 3, 4
           and 5, rows staged element by element, an image smaller than a
           tile, pooled extents no tile divides, forced 7x8 and 4x16 tiles,
           f32 out of bf16, stride 1 with bf16 on the FFMA route, a 5x5
           filter under a 2x2 pool); resblock's plan (route, band rows, cluster, tile) for
           each case, with edges on the tensor-core route (bands that do
           not divide H, no output ReLU, f32 out of bf16, a cluster with a
           ragged last band) and on the FFMA route (ragged channels);
           sgemm_int8 and its quantize kernel alone bit-equal to
           their plain versions at 1024^3 and 4096^3 (timed, with the
           quantize pass and the product alone) and at ragged shapes (K=50,
           K=3, K=4099, N=129, an all-zero A).
           Each timed case also prints its bound (the larger of its FLOPs
           over the card's peak in its precision and its bytes, each input
           read and each output written once, over HBM bandwidth;
           core/machine.card_peaks) and the time of the PyTorch call that
           computes the same function (library: torch.addmm, F.conv2d on
           channels_last, torch._int_mm + the scale), or of the sequence
           of calls where no single one does (fused_stem: conv, ReLU,
           max-pool; resblock: three convs, add, ReLU). Then the tconv
           kernel alone, timed by K split count at the ResNet-50 3x3
           shapes (what tconv_plan's split rule rests on), and the
           matmul_ext kernel alone by K split count at the fc1000 and
           res4/res5 1x1 shapes (what matmul_plan's split rule rests on),
           and the resblock kernel alone by cluster size, tile and band
           rows at the four ResNet-50 stages, each result checked against
           the plain version (what resblock_plan's estimate rests on), and
           the fused_stem kernel alone by tile at conv1 + pool1, batch 32
           and 1 (what stem_plan's estimate rests on; its shared-memory sum
           and blocks per SM must equal the kernel's own). --kernels cuts
           the phase down to the named kernels
  vendor   the vendor conv template under prec=bf16 with NHWC bf16 storage
           at the 21 ResNet-50 b32 conv sigs: its result comes back
           channels_last (no permute copy around the step) and agrees with
           the f64 conv of the rounded operands (mrd 5e-3); beside it, timed
           and used nowhere in the port, the bf16 cuDNN form that rounds the
           sum before the bias: its mrd against the template, the share of
           stored values it moves, its time
  digests  TorchFwd at batch 1 under the f32 tune, the fused f32 tune and
           the f32 twin of the headline tune (vendor convs, sibling convs
           fused into xla_conv2) against the per-node digest archives recorded on a TPU
           (tests/data/tpu_digests): resnet-50@shapes40 (trained weights,
           mrd 3e-3) and resnet-50 (zoo weights, mrd 8e-3); a fused plan is
           compared on the nodes it produces
  agree    cls_agree on 64 held-out shapes-src images with the trained
           40-class ResNet-50, against the f32 tune: the bf16+NHWC tune, the
           fused bf16+NHWC tune and the headline tune (use_culibs=1, bf16,
           NHWC, fuse_siblings=1), top-1 >= 0.90 each and top-1 agreement
           >= 0.97
  full     run_cnet on the 1000-class ResNet-50 at batch 32 under those three
           tunes' forms and the two f32 ones (five tunes): kernel launch
           counts per forward, exact and equal to what the plan's steps send
           to each hand kernel (unfused: 40 matmul_ext, 13 tconv; fused: 14
           matmul_ext, 3 tconv, 1 fused_stem, 12 resblock; headline: none,
           with 4 xla_conv2 steps; no sgemm_int8), finite softmax rows, ms
           per forward and imgs/s, the card's busy time in one more forward
           (torch.profiler) and so its idle share, and each template's
           summed step time over one more forward (CUDA events around each
           step); then one forward time of the headline tune at batch 128
  ops_prof the per-op path (mode torch_ops_prof, be=torch): the vendor
           sgemm under prec=bf16 returns the unrounded f32 product; the six
           square SGEMMs of tests/data/ops/sgemm-baseline.txt (128^3-4096^3) under
           the tunes kg (cuBLAS FP32), hand (B1) and int8 (B3, mrd 5e-2 vs
           kg), then kg and bf16 at mrd 5e-3; the 21 ResNet-50 b32 conv sigs
           of resnet50-convs.txt under kg (cuDNN FP32) and hand (B1, B2),
           then kg and bf16; no COMP_FAIL, KG_DIGEST_FAIL or ERROR, exactly
           6 x run_iter sgemm_int8 launches (and as many quantize kernel
           launches) in the int8 sweep, wisdom under
           build/ops_prof/, a table of ms, TF/s (TOPS) and % of the card's
           own-precision peak per op and tune; then torch_rtc_test

A run of every phase that passes ends with three lines: the nvidia-smi name
and power limit; a JSON object with one entry per kernel ("launches":
launches in one run of that kernel's own main path, the f32 tune's forward
for matmul_ext and tconv, the fused f32 tune's for fused_stem and resblock,
and the int8 SGEMM sweep of ops_prof for sgemm_int8, whose entry also holds
its quantize kernel's launches there ("quantize_launches");
"launches_by_tune": in each of those runs; "ms", "plain_ms", "bound_ms"
and "library_ms": summed over the timed shapes, "bound_by" that of the
case with the largest bound; "library_ms" is null for fused_stem and
resblock, which no single PyTorch call computes, and
"library_sequence_ms" holds the time of the sequence of calls that does;
"max_abs_err": over every checked shape; "cases": each timed case), the
b32 forward times (and the headline tune's at b128), the card's busy time in
a forward, the per-template step times and the vendor phase's two sums;
and {"ok": true,
"device": {...}}. Without a CUDA device, or outside a checkout of the
repo, it exits non-zero and prints no result. It imports neither jax nor
the JAX package boda_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
TRAINED = DATA / "resnet50-shapes40.boda"
# the tunes of the main paths: the engine default, the bf16 NHWC-storage
# tune, and both with the stem and the identity bottlenecks fused
FUSED = "fuse_stem=1,fuse_resblock=1"
TUNES = {"f32": "()", "bf16_nhwc": "(prec=bf16,layout=nhwc)",
         "fused_f32": f"({FUSED})",
         "fused_bf16_nhwc": f"(prec=bf16,layout=nhwc,{FUSED})",
         # the vendor tune the JAX bench times (bench.py's headline: every
         # conv on the vendor library, sibling convs fused into xla_conv2),
         # and its f32 twin, which the digest archives can be held to
         "headline": "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,"
                     "fuse_siblings=1)",
         "sib_f32": "(use_culibs=1,fuse_siblings=1,s2d=0)"}
# the tunes whose b32 forward the `full` phase runs and times
FULL_TUNES = ("f32", "bf16_nhwc", "fused_f32", "fused_bf16_nhwc", "headline")
# exact kernel launches per ResNet-50 forward under each tune
UNFUSED_LAUNCHES = {"matmul_ext": 40, "tconv": 13, "fused_stem": 0,
                    "resblock": 0, "sgemm_int8": 0, "quantize": 0}
FUSED_LAUNCHES = {"matmul_ext": 14, "tconv": 3, "fused_stem": 1,
                  "resblock": 12, "sgemm_int8": 0, "quantize": 0}
VENDOR_LAUNCHES = dict.fromkeys(UNFUSED_LAUNCHES, 0)
LAUNCHES = {"f32": UNFUSED_LAUNCHES, "bf16_nhwc": UNFUSED_LAUNCHES,
            "fused_f32": FUSED_LAUNCHES, "fused_bf16_nhwc": FUSED_LAUNCHES,
            "headline": VENDOR_LAUNCHES}
# the hand kernel each template launches once per step (the vendor
# templates xla_conv, xla_conv2, s2d_conv and the plain-torch ones launch none)
TEMPLATE_KERNEL = {"k1conv": "matmul_ext", "conv": "matmul_ext",
                   "ipconv": "matmul_ext", "tconv": "tconv",
                   "fused_stem": "fused_stem", "resblock": "resblock"}
# each kernel's own main path: the tune whose forward runs it, or the
# per-op sweep (ops_prof's int8 sgemm run) for sgemm_int8
KERNEL_PATH = {"matmul_ext": "f32", "tconv": "f32",
               "fused_stem": "fused_f32", "resblock": "fused_f32",
               "sgemm_int8": "ops_prof"}
SOURCES = {
    "matmul_ext": ("boda_tpu_torch/csrc/sgemm.cu",
                   "boda_tpu/ops/pallas/sgemm.py:114"),
    "tconv": ("boda_tpu_torch/csrc/tconv.cu", "boda_tpu/ops/pallas/tconv.py:62"),
    "fused_stem": ("boda_tpu_torch/csrc/stem.cu",
                   "boda_tpu/ops/pallas/stem.py:57"),
    "resblock": ("boda_tpu_torch/csrc/resblock.cu",
                 "boda_tpu/ops/pallas/resblock.py:31"),
    "sgemm_int8": ("boda_tpu_torch/csrc/qsgemm.cu",
                   "boda_tpu/ops/pallas/qsgemm.py:47"),
}
F32_MRD, BF16_MRD = 1e-4, 5e-3
# the per-op path: torch_ops_prof calls (op-sig file, tunes, tolerances).
# bf16 runs in calls of its own, since its tolerance is wider than the f32
# tunes' (func_mrd_toler keys by func name, and f32 and bf16 are both sgemm)
OPS_RUN_ITER = 5
OPS_PROF = [
    ("sgemm", "sgemm-baseline.txt",
     "(kg=(use_culibs=1),hand=(),int8=(prec=int8))",
     "func_mrd_toler=(sgemm_int8=5e-2)"),
    ("sgemm_bf16", "sgemm-baseline.txt", "(kg=(use_culibs=1),bf16=(prec=bf16))",
     "mrd_toler=5e-3"),
    ("rn50_convs", "resnet50-convs.txt", "(kg=(use_culibs=1),hand=())", ""),
    ("rn50_convs_bf16", "resnet50-convs.txt",
     "(kg=(use_culibs=1),bf16=(prec=bf16))", "mrd_toler=5e-3"),
]
# exact sgemm_int8 launches of the int8 sweep, and of its quantize kernel: 6
# ops x run_iter timed calls (profile_rcg_call makes no launch outside its
# timed loop)
OPS_INT8_LAUNCHES = 6 * OPS_RUN_ITER


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi_line() -> str:
    """`name, power.limit` of the card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds of fn() on the card: the median over three windows of
    the mean of `reps` back-to-back calls between two CUDA events, after
    one warm-up call. A call short enough that the host sets its pace
    varies with the host's load; the median drops the windows it slowed."""
    import statistics

    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    per = []
    for _ in range(3):
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        per.append(t0.elapsed_time(t1) / reps)
    return statistics.median(per)


def bit_equal(got, want) -> bool:
    """got and want hold the same values, NaN where the other holds NaN."""
    return got.shape == want.shape and got.dtype == want.dtype and bool(
        ((got == want) | (got.isnan() & want.isnan())).all())


def mrd(got, want) -> float:
    """max |got - want| over max |want| (both cast to f64)."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------- phases

def phase_env(ctx: dict) -> None:
    import torch
    from boda_tpu_torch.core.device import nvcc_path
    print(f"nvidia-smi: {ctx['smi']}")
    nvcc = nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{ver}'")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()}")


def phase_build(ctx: dict) -> None:
    from boda_tpu_torch.ops.cuda import build
    lib, secs, log = build.build_library()
    print(f"build: {lib.name} in {secs:.1f} s")
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln \
                or "warning" in ln.lower():
            print(f"  ptxas: {ln.strip()}")
    build.load_kernels()


def _kernel_cases():
    """(label, kernel, shape) at the shapes the ResNet-50 main paths give
    each kernel. Inputs are made on the card from a seed."""
    return [
        # res2a_branch2a: 1x1 64->64 at b32, 56^2 (k1conv)
        ("res2a_branch2a 1x1 M=100352 K=64 N=64", "matmul_ext",
         dict(M=32 * 56 * 56, K=64, N=64, relu=True)),
        # a res2 3x3 (C=64, so the im2col `conv` route) at b32
        ("res2 3x3 im2col M=100352 K=576 N=64", "matmul_ext",
         dict(M=32 * 56 * 56, K=576, N=64, relu=True)),
        ("fc1000 M=1 K=2048 N=1000", "matmul_ext",
         dict(M=1, K=2048, N=1000, relu=False)),
        ("fc1000 M=32 K=2048 N=1000", "matmul_ext",
         dict(M=32, K=2048, N=1000, relu=False)),
        # res4b_branch2b: 3x3 pad 1, C=oc=256 at 14^2, b32 (tconv)
        ("res4b_branch2b 3x3 n=32 14^2 C=256", "tconv",
         dict(n=32, H=14, W=14, C=256, oc=256, relu=True)),
        # a res5 3x3 at batch 1: C=oc=512 at 7^2 (mostly empty tiles)
        ("res5 3x3 n=1 7^2 C=512", "tconv",
         dict(n=1, H=7, W=7, C=512, oc=512, relu=True)),
        # conv1 7x7/s2/p3 + pool1 3x3/s2 ceil at b32: 224^2 -> 56^2
        ("conv1+pool1 n=32 224^2 3->64", "fused_stem",
         dict(n=32, H=224, W=224, C=3, oc=64)),
        # the fused identity bottlenecks at b32, and res5 at batch 1
        ("res2b n=32 56^2 C=256 Cm=64", "resblock",
         dict(n=32, H=56, W=56, C=256, Cm=64)),
        ("res3b n=32 28^2 C=512 Cm=128", "resblock",
         dict(n=32, H=28, W=28, C=512, Cm=128)),
        ("res4b n=32 14^2 C=1024 Cm=256", "resblock",
         dict(n=32, H=14, W=14, C=1024, Cm=256)),
        ("res5b n=32 7^2 C=2048 Cm=512", "resblock",
         dict(n=32, H=7, W=7, C=2048, Cm=512)),
        ("res5b n=1 7^2 C=2048 Cm=512", "resblock",
         dict(n=1, H=7, W=7, C=2048, Cm=512)),
    ]


def _edge_cases():
    """Ragged shapes the ResNet-50 path never gives the kernels (K and C
    not multiples of 4 or of a tile, a 5x5 filter, a stem whose pool
    windows run past the conv output, bands that do not divide H): checked,
    not timed."""
    return [
        ("edge M=77 K=50 N=33", "matmul_ext", dict(M=77, K=50, N=33, relu=True)),
        ("edge M=1 K=3 N=1", "matmul_ext", dict(M=1, K=3, N=1, relu=False)),
        # K % 8 != 0 over two row tiles: bf16 stages element by element
        ("edge M=300 K=50 N=200", "matmul_ext",
         dict(M=300, K=50, N=200, relu=True)),
        # the fc at M=1 split over K, with ragged K and an odd N
        ("edge split-K M=1 K=2050 N=1001", "matmul_ext",
         dict(M=1, K=2050, N=1001, relu=False)),
        # M*K past 2^31: 64-bit offsets into A and C
        ("edge 64-bit M=2097153 K=1024 N=64", "matmul_ext",
         dict(M=2 ** 21 + 1, K=1024, N=64, relu=False)),
        ("edge 5x5 pad 2 n=2 5x9 C=13 oc=70", "tconv",
         dict(n=2, H=5, W=9, C=13, oc=70, k=5, pad=2, relu=False)),
        ("edge 1x1 n=1 3x3 C=6 oc=5", "tconv",
         dict(n=1, H=3, W=3, C=6, oc=5, k=1, pad=0, relu=True)),
        # M = 429 and oc = 72 off the 128 tile; then a K split (18 splits
        # in bf16, 96 in f32 on 132 SMs; ops/cuda/tconv.tconv_plan)
        ("edge 3x3 n=3 13x11 C=64 oc=72", "tconv",
         dict(n=3, H=13, W=11, C=64, oc=72, relu=True)),
        ("edge split-K 3x3 n=1 7^2 C=256 oc=200", "tconv",
         dict(n=1, H=7, W=7, C=256, oc=200, relu=False)),
        # tests/test_stem.py:53-54
        ("edge stem n=2 48x40 oc=8 no bias", "fused_stem",
         dict(n=2, H=48, W=40, C=3, oc=8, bias=False)),
        ("edge stem n=1 58^2 oc=16", "fused_stem",
         dict(n=1, H=58, W=58, C=3, oc=16)),
        # what the routes mask: two blocks of output channels, the second
        # ragged; C = 5 (filter rows of 35 values, padded to 48 on the
        # tensor cores); rows that are no 16-byte multiples (patches staged
        # element by element); an image smaller than one tile; a pooled
        # extent no tile divides; f32 out of bf16 in; stride 1, which in
        # bf16 cannot take the tensor cores (the FFMA route on bf16); a 5x5
        # filter under a 2x2 pool
        ("edge stem n=2 40x36 oc=72", "fused_stem",
         dict(n=2, H=40, W=36, C=3, oc=72)),
        ("edge stem n=2 30x34 C=5 oc=24", "fused_stem",
         dict(n=2, H=30, W=34, C=5, oc=24)),
        ("edge stem n=1 21x19 oc=8", "fused_stem",
         dict(n=1, H=21, W=19, C=3, oc=8)),
        ("edge stem n=3 12^2 oc=64", "fused_stem",
         dict(n=3, H=12, W=12, C=3, oc=64)),
        ("edge stem n=2 70x94 oc=40", "fused_stem",
         dict(n=2, H=70, W=94, C=3, oc=40)),
        ("edge stem f32 out n=2 64^2 oc=64", "fused_stem",
         dict(n=2, H=64, W=64, C=3, oc=64, out_f32=True)),
        # a forced tile (ty, tx) instead of the plan's small ones
        ("edge stem tile 7x8 n=2 70x94 oc=40", "fused_stem",
         dict(n=2, H=70, W=94, C=3, oc=40, force=(7, 8))),
        ("edge stem tile 7x8 n=3 12^2 oc=64", "fused_stem",
         dict(n=3, H=12, W=12, C=3, oc=64, force=(7, 8))),
        ("edge stem tile 4x16 n=2 40x36 oc=72", "fused_stem",
         dict(n=2, H=40, W=36, C=3, oc=72, force=(4, 16))),
        ("edge stem stride 1 n=2 20x24 oc=16", "fused_stem",
         dict(n=2, H=20, W=24, C=3, oc=16, stride=1)),
        ("edge stem 5x5 pad 2 pool 2x2 n=2 32^2 C=4 oc=32", "fused_stem",
         dict(n=2, H=32, W=32, C=4, oc=32, k=5, pad=2,
              pool=((2, 2), (2, 2)))),
        # tests/test_resblock.py:150-151, and one without the output ReLU
        ("edge resblock n=1 10^2 C=16 Cm=8", "resblock",
         dict(n=1, H=10, W=10, C=16, Cm=8)),
        ("edge resblock n=2 9x7 C=32 Cm=8", "resblock",
         dict(n=2, H=9, W=7, C=32, Cm=8)),
        ("edge resblock relu_out=0 n=2 5x6 C=12 Cm=5", "resblock",
         dict(n=2, H=5, W=6, C=12, Cm=5, relu_out=False)),
        # channels in whole 64-value chunks: bf16 on the tensor-core route.
        # Bands that do not divide H; no output ReLU; f32 out of bf16 in; a
        # forced plan (ty, cluster, tile_m, tile_n): a cluster of 4 over
        # bands of 5 rows of 13, on both tiles
        ("edge resblock n=2 13x11 C=256 Cm=64", "resblock",
         dict(n=2, H=13, W=11, C=256, Cm=64)),
        ("edge resblock relu_out=0 n=1 9^2 C=128 Cm=64", "resblock",
         dict(n=1, H=9, W=9, C=128, Cm=64, relu_out=False)),
        ("edge resblock f32 out n=3 7^2 C=512 Cm=128", "resblock",
         dict(n=3, H=7, W=7, C=512, Cm=128, out_f32=True)),
        ("edge resblock cluster 4 ty 5 n=2 13x11 C=512 Cm=128", "resblock",
         dict(n=2, H=13, W=11, C=512, Cm=128, force=(5, 4, 64, 128))),
        ("edge resblock cluster 2 ty 5 n=2 13x11 C=512 Cm=128", "resblock",
         dict(n=2, H=13, W=11, C=512, Cm=128, force=(5, 2, 128, 128))),
        ("edge resblock cluster 8 ty 4 n=1 7x9 C=64 Cm=64", "resblock",
         dict(n=1, H=7, W=9, C=64, Cm=64, force=(4, 8, 128, 64))),
    ]


def _kernel_args(kname, kw, dt, dev, gen):
    """(kernel call, plain call in dt, plain call in f32) on seeded inputs
    of one case. The f32 plain result is what a bf16 output is held
    against: the kernel's one rounding to bf16 then costs at most half an
    ulp, 2^-8 of the largest value."""
    import torch
    from boda_tpu_torch.ops.cuda.resblock import resblock, resblock_plain
    from boda_tpu_torch.ops.cuda.sgemm import matmul_ext, matmul_ext_plain
    from boda_tpu_torch.ops.cuda.stem import fused_stem, fused_stem_plain
    from boda_tpu_torch.ops.cuda.tconv import tconv, tconv_plain

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(dt)

    if kname == "matmul_ext":
        M, K, N = kw["M"], kw["K"], kw["N"]
        args = (randn(M, K), randn(N, K, scale=K ** -0.5),
                torch.randn(N, device=dev, generator=gen), kw["relu"])
        fns, plain = matmul_ext, matmul_ext_plain
    elif kname == "tconv":
        n, H, W, C, oc = kw["n"], kw["H"], kw["W"], kw["C"], kw["oc"]
        k, pad = kw.get("k", 3), kw.get("pad", 1)
        # the filter in OHWI order, as the tconv template hands it over
        args = (randn(n, H, W, C), randn(oc, k, k, C, scale=(k * k * C) ** -0.5),
                torch.randn(oc, device=dev, generator=gen), (pad, pad),
                kw["relu"])
        fns, plain = tconv, tconv_plain
    elif kname == "fused_stem":
        n, H, W, C, oc = kw["n"], kw["H"], kw["W"], kw["C"], kw["oc"]
        k, pad, st = kw.get("k", 7), kw.get("pad", 3), kw.get("stride", 2)
        bias = torch.randn(oc, device=dev, generator=gen) \
            if kw.get("bias", True) else None
        args = (randn(n, H, W, C), randn(oc, C, k, k, scale=(k * k * C) ** -0.5),
                bias, (pad, pad), kw.get("pool", ((3, 3), (2, 2))), True)

        def fns(*a, **k2):
            return fused_stem(*a, stride=(st, st), **k2)

        def plain(*a, **k2):
            return fused_stem_plain(*a, stride=(st, st), **k2)
        if "force" in kw:
            def fns(*a, out_dtype):
                return _stem_forced_case(a, out_dtype, kw["force"])
    else:
        n, H, W, C, Cm = kw["n"], kw["H"], kw["W"], kw["C"], kw["Cm"]
        args = (randn(n, H, W, C), randn(Cm, C, scale=C ** -0.5),
                # the filter in OHWI order, as the template hands it over
                randn(Cm, scale=0.1), randn(Cm, 3, 3, Cm, scale=(9 * Cm) ** -0.5),
                randn(Cm, scale=0.1), randn(C, Cm, scale=Cm ** -0.5),
                randn(C, scale=0.1), kw.get("relu_out", True))
        fns, plain = resblock, resblock_plain
        if "force" in kw:
            def fns(*a, out_dtype):
                return _resblock_forced(a, out_dtype, kw["force"])
    odt = torch.float32 if kw.get("out_f32") else dt
    return (lambda: fns(*args, out_dtype=odt),
            lambda: plain(*args, out_dtype=odt),
            lambda: plain(*args)), args


def _resblock_forced(args, out_dtype, force, out=None):
    """The resblock kernel through its C entry point under a given (ty,
    cluster, tile_m, tile_n) instead of resblock_plan's choice; the route
    and the load width follow the operands as in the plan."""
    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    from boda_tpu_torch.ops.cuda.resblock import plan_route
    x, w1, b1, w2, b2, w3, b3, relu_out = args
    n, H, W, C = x.shape
    Cm = w1.shape[0]
    ty, cluster, tile_m, tile_n = force
    bf = x.dtype == torch.bfloat16
    route, vec = plan_route(C, Cm, x.element_size())
    if out is None:
        out = torch.empty_like(x, dtype=out_dtype)
    rc = load_kernels().boda_resblock(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        n, H, W, C, Cm, ty, cluster, int(route == "mma"), tile_m, tile_n,
        int(vec),
        int(bf), int(out_dtype == torch.bfloat16), int(bool(relu_out)),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc == 0, f"resblock forced plan {force}: launch failed with "
                   f"cudaError {rc}")
    return out


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None and hasattr(t, "element_size"))


def _work(kname, args, out) -> int:
    """FLOPs (OPs for sgemm_int8) of one call of a kernel case."""
    if kname in ("matmul_ext", "sgemm_int8"):
        (M, K), N = args[0].shape, out.shape[1]
        return 2 * M * N * K
    if kname == "tconv":
        _oc, ky, kx, C = args[1].shape
        return 2 * out.numel() * ky * kx * C
    if kname == "fused_stem":
        # of the timed case, ResNet's conv1: 7x7 at stride 2
        x, w = args[:2]
        n, H, W, C = x.shape
        (py, px), (sy, sx) = args[3], (2, 2)
        cy, cx = (H + 2 * py - 7) // sy + 1, (W + 2 * px - 7) // sx + 1
        return 2 * n * cy * cx * w.shape[0] * 49 * C
    x, w1 = args[:2]
    n, H, W, C = x.shape
    Cm = w1.shape[0]
    return 2 * n * H * W * (2 * C * Cm + 9 * Cm * Cm)


def bound(peaks, prec: str, work: int, nbytes: int) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for `work`
    operations in `prec` moving `nbytes`, each input read once and each
    output written once."""
    t_ops = work / peaks.flops(prec)
    t_bytes = nbytes / peaks.hbm_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _library(kname, args, dt):
    """(fn, kind) of the PyTorch yardstick of a kernel case: one call that
    computes the same function ("call"), or the sequence of calls that
    does where no single one does ("sequence"). The port never calls it."""
    import torch
    import torch.nn.functional as F
    cl = torch.channels_last
    if kname == "matmul_ext":
        a, b, bias = args[:3]
        bb = bias.to(dt)
        return (lambda: torch.addmm(bb, a, b.t())), "call"
    if kname == "tconv":
        x, w, bias, pad = args[:4]
        # the NHWC x and the OHWI filter are channels_last NCHW / OIHW views
        xc, wc, bb = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), bias.to(dt)
        return (lambda: F.conv2d(xc, wc, bb, padding=pad)), "call"
    if kname == "fused_stem":
        x, w, bias, pad, pool = args[:5]
        xc, wc = x.permute(0, 3, 1, 2), w.contiguous(memory_format=cl)
        bb = None if bias is None else bias.to(dt)
        return (lambda: F.max_pool2d(torch.relu(F.conv2d(
            xc, wc, bb, stride=2, padding=pad)), pool[0], pool[1],
            ceil_mode=True)), "sequence"
    x, w1, b1, w2, b2, w3, b3, relu_out = args
    C, Cm = x.shape[3], w1.shape[0]
    xc = x.permute(0, 3, 1, 2)
    w1c = w1.reshape(Cm, C, 1, 1).contiguous(memory_format=cl)
    w2c = w2.permute(0, 3, 1, 2)     # OHWI is channels_last OIHW
    w3c = w3.reshape(C, Cm, 1, 1).contiguous(memory_format=cl)

    def seq():
        h = torch.relu(F.conv2d(xc, w1c, b1))
        h = torch.relu(F.conv2d(h, w2c, b2, padding=1))
        y = F.conv2d(h, w3c, b3) + xc
        return torch.relu(y) if relu_out else y
    return seq, "sequence"


def _stats(name: str) -> dict:
    source, replaces = SOURCES[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": 0.0, "max_mrd": 0.0,
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None,
            "library_ms": 0.0, "cases": []}


def _add_case(s: dict, case: dict) -> None:
    """Sum a timed case into its kernel's entry. A case timed against a
    sequence of calls keeps that time as library_sequence_ms: its
    library_ms, and its kernel's, is null."""
    for k in ("ms", "plain_ms", "bound_ms"):
        s[k] += case[k]
    if case["library"] == "sequence":
        case["library_sequence_ms"] = case["library_ms"]
        case["library_ms"] = None
        s["library_sequence_ms"] = s.get("library_sequence_ms", 0.0) + \
            case["library_sequence_ms"]
    s["library_ms"] = None if s["library_ms"] is None \
        or case["library_ms"] is None else s["library_ms"] + case["library_ms"]
    if all(case["bound_ms"] >= c["bound_ms"] for c in s["cases"]):
        s["bound_by"] = case["bound_by"]
    s["cases"].append(case)


def _check_stem_template(args, kw, dt, got) -> str:
    """The fused_stem template in the form each main path runs it (f32:
    NCHW in and out; bf16: NHWC bf16-edge storage) on the same operands
    must give the bare kernel's output exactly."""
    import torch
    from boda_tpu_torch.ops.cuda.stem import make_stem_op
    from boda_tpu_torch.ops.registry import get_template
    x, w, bias = args[:3]
    n, H, W, C = x.shape
    (pk, _), (ps, _) = kw.get("pool", ((3, 3), (2, 2)))
    op = make_stem_op(n, C, H, W, w.shape[0], k=kw.get("k", 7),
                      s=kw.get("stride", 2), p=kw.get("pad", 3), pool_k=pk,
                      pool_s=ps, bias=bias is not None)
    if dt == torch.bfloat16:
        op.str_vals.update(prec="bf16", io_layout="nhwc", edge_prec="bf16")
    t = get_template("fused_stem")
    fn = t.build(t.check_args(op))
    targs = (x, w) + ((bias,) if bias is not None else ())
    if dt == torch.bfloat16:
        out, form = fn(*targs), "NHWC bf16 storage"
    else:
        out = fn(x.permute(0, 3, 1, 2).contiguous(), *targs[1:])
        out, form = out.permute(0, 2, 3, 1), "NCHW f32"
    check(torch.equal(out, got), f"fused_stem template ({form}) differs "
                                 f"from the bare kernel")
    return form


def _qsgemm_cases():
    """(label, M, K, N, operands, timed) of sgemm_int8: the square sizes
    of the per-op sweep (tests/data/ops/sgemm-baseline.txt), timed; ragged
    shapes (K not a multiple of 4 or 16), a single element, an all-zero A,
    and a NaN in A with an inf in B (a NaN scale, so NaN throughout),
    checked. operands: "randn", "zero" (A all zero) or "nan"."""
    return [("1024^3", 1024, 1024, 1024, "randn", True),
            ("4096^3", 4096, 4096, 4096, "randn", True),
            ("edge M=77 K=50 N=33", 77, 50, 33, "randn", False),
            ("edge M=1 K=3 N=1", 1, 3, 1, "randn", False),
            ("edge zero A M=130 K=96 N=70", 130, 96, 70, "zero", False),
            ("edge NaN in A, inf in B M=130 K=96 N=70", 130, 96, 70, "nan",
             False),
            ("edge M=200 K=4099 N=129", 200, 4099, 129, "randn", False),
            # ragged N on the 16-byte copies (K % 16 == 0)
            ("edge M=130 K=256 N=129", 130, 256, 129, "randn", False)]


def _check_qsgemm(stats: dict, dev, gen, peaks) -> None:
    """sgemm_int8 against its plain version on the card: bit-equal (the
    int32 sums are exact and both round the same), and so its quantize
    kernel alone against quantize_operands_plain; and its time, the plain
    version's, and those of its two parts alone: the quantize pass and the
    kernel's product."""
    import torch
    from boda_tpu_torch.ops.cuda.qsgemm import int8_product, \
        quantize_operands, quantize_operands_plain, sgemm_int8, \
        sgemm_int8_plain
    s = stats["sgemm_int8"] = _stats("sgemm_int8")
    for label, M, K, N, operands, timed in _qsgemm_cases():
        a = torch.randn(M, K, device=dev, generator=gen)
        b = torch.randn(K, N, device=dev, generator=gen)
        if operands == "zero":
            a.zero_()
        if operands == "nan":
            a[M // 2, K // 3] = float("nan")
            b[K // 2, N // 3] = float("inf")
        q_got, q_want = quantize_operands(a, b), quantize_operands_plain(a, b)
        torch.cuda.synchronize()
        check(all(bit_equal(g, w) for g, w in zip(q_got, q_want)),
              f"sgemm_int8 {label}: the quantize kernel differs from "
              f"quantize_operands_plain")
        got = sgemm_int8(a, b)
        torch.cuda.synchronize()
        want = sgemm_int8_plain(a, b)
        # NaN where both are NaN (bit_equal holds them to that) counts 0
        abs_err = float((got.double() - want.double()).abs().nan_to_num(0.0)
                        .max())
        s["max_abs_err"] = max(s["max_abs_err"], abs_err)
        print(f"kernel sgemm_int8 f32->f32 {label:36s} bit-equal="
              f"{bit_equal(got, want)} (quantize bit-equal) "
              f"max_abs={abs_err:.3e}", end="")
        check(bit_equal(got, want), f"sgemm_int8 {label}: differs from its "
                                    f"plain version (max abs {abs_err:.3e})")
        if operands == "nan":
            check(bool(got.isnan().all()), f"sgemm_int8 {label}: a NaN "
                                           f"operand left finite outputs")
        else:
            check(bool(torch.isfinite(got).all()), f"sgemm_int8 {label}: "
                                                   f"non-finite output")
        if not timed:
            print()
            continue
        ms = cuda_ms(lambda: sgemm_int8(a, b), 20)
        plain_ms = cuda_ms(lambda: sgemm_int8_plain(a, b), 20)
        quant_ms = cuda_ms(lambda: quantize_operands(a, b), 20)
        q = quantize_operands(a, b)
        prod_ms = cuda_ms(lambda: int8_product(*q), 20)
        tops = 2 * M * N * K / ms / 1e9
        bound_ms, bound_by = bound(peaks, "int8", 2 * M * N * K,
                                   _nbytes(a, b, got))
        # the yardstick: torch._int_mm on the quantized operands, then the
        # scale; n/a where its shape rules refuse the case
        qa, qbt, sc = q[0], q[1].t(), q[2]
        try:
            torch._int_mm(qa, qbt)
            lib_ms = cuda_ms(lambda: torch._int_mm(qa, qbt) * sc, 20)
        except RuntimeError:
            lib_ms = None
        print(f" kernel {ms:.4f} ms ({tops:.1f} TOPS) plain {plain_ms:.4f} ms;"
              f" quantize pass {quant_ms:.4f} ms, product alone "
              f"{prod_ms:.4f} ms ({2 * M * N * K / prod_ms / 1e9:.1f} TOPS);"
              f" bound {bound_ms:.4f} ms ({bound_by}); library _int_mm + "
              f"scale {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
        _add_case(s, {"case": label, "dtype": "float32", "mrd": 0.0,
                      "ms": ms, "plain_ms": plain_ms,
                      "quantize_ms": quant_ms, "product_ms": prod_ms,
                      "tops": tops, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": lib_ms,
                      "library": "call: torch._int_mm * scale (quantized "
                                 "operands)"})


def phase_kernels(ctx: dict) -> None:
    import torch
    from boda_tpu_torch.core.machine import card_peaks
    peaks = card_peaks(torch.cuda.get_device_name(0))
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    stats: dict[str, dict] = {}
    only = ctx.get("only_kernels")

    def wanted(kname):
        return not only or kname in only
    if wanted("sgemm_int8"):
        _check_qsgemm(stats, dev, gen, peaks)
    timed = {c[0] for c in _kernel_cases()}
    for label, kname, kw in _kernel_cases() + _edge_cases():
        if not wanted(kname):
            continue
        for dt in (torch.float32, torch.bfloat16):
            (run_k, run_p, ref), args = _kernel_args(kname, kw, dt, dev, gen)
            got = run_k()
            torch.cuda.synchronize()
            want = ref()
            err = mrd(got, want)
            abs_err = float((got.double() - want.double()).abs().max())
            check(bool(torch.isfinite(got.float()).all()),
                  f"{kname} {label} {dt}: non-finite output")
            toler = F32_MRD if dt == torch.float32 else BF16_MRD
            print(f"kernel {kname:10s} {str(dt)[6:]:8s} {label:44s} "
                  f"mrd={err:.3e} (<= {toler:g}) max_abs={abs_err:.3e}",
                  end="")
            check(err <= toler, f"{kname} {label} {dt}: mrd {err:.3e} > "
                                f"{toler:g}")
            if kname == "fused_stem":
                if not kw.get("out_f32"):
                    print(f" template "
                          f"{_check_stem_template(args, kw, dt, got)} exact",
                          end="")
                print(f" {_check_stem_rounding(args, kw, dt, got, sms)}",
                      end="")
            if kname == "matmul_ext":
                print(f" {_matmul_plan_str(args, sms)}", end="")
            if kname == "resblock":
                print(f" {_resblock_plan_str(args, sms, kw.get('force'))}",
                      end="")
            s = stats.setdefault(kname, _stats(kname))
            s["max_abs_err"] = max(s["max_abs_err"], abs_err)
            s["max_mrd"] = max(s["max_mrd"], err)
            if label not in timed:
                print()
                # the 64-bit edge holds gigabytes (the calls hold args)
                del args, got, want, run_k, run_p, ref
                continue
            ms = cuda_ms(run_k, 20)
            plain_ms = cuda_ms(run_p, 20)
            prec = "bf16" if dt == torch.bfloat16 else "f32"
            bound_ms, bound_by = bound(peaks, prec, _work(kname, args, got),
                                       _nbytes(*args, got))
            lib, lib_kind = _library(kname, args, dt)
            lib_ms = cuda_ms(lib, 20)
            print(f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
                  f"{bound_ms:.4f} ms ({bound_by}) library {lib_kind} "
                  f"{lib_ms:.4f} ms")
            case = {"case": label, "dtype": str(dt)[6:], "mrd": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms,
                    "library": lib_kind}
            if kname == "matmul_ext":
                case["plan"] = _matmul_plan_str(args, sms)
            if kname == "resblock":
                case["plan"] = _resblock_plan_str(args, sms)
            if kname == "fused_stem":
                case["plan"] = _stem_plan_str(args, kw, got.dtype, sms)
            _add_case(s, case)
            del args, got, want, lib, run_k, run_p, ref
    ctx["kernels"] = stats
    if wanted("tconv"):
        _tconv_splits(dev)
    if wanted("matmul_ext"):
        _matmul_splits(dev)
    if wanted("resblock"):
        _resblock_plans(dev, gen)
    if wanted("fused_stem"):
        _stem_plans(dev, gen)


def _stem_plan_of(args, kw, out_dtype, sms: int):
    from boda_tpu_torch.ops.cuda.stem import stem_plan
    x, w, _bias, pad, pool = args[:5]
    n, H, W, C = x.shape
    st = kw.get("stride", 2)
    return stem_plan(n, H, W, C, w.shape[0], x.element_size(), sms,
                     tuple(w.shape[2:]), (st, st), pad, pool,
                     out_dtype.itemsize)


def _stem_plan_str(args, kw, out_dtype, sms: int) -> str:
    """fused_stem's plan for a case: its route (and why bf16 left the
    tensor cores), tile, persistent blocks and blocks per SM."""
    p = _stem_plan_of(args, kw, out_dtype, sms)
    return (f"plan {p.route} tile {p.ty}x{p.tx} blocks {p.blocks} "
            f"({p.per_sm} per SM)"
            f"{'' if p.vec else ' element-staged'}"
            f"{' [' + p.why + ']' if p.why else ''}")


def _check_stem_rounding(args, kw, dt, got, sms: int) -> str:
    """The plan of a fused_stem case; and, for a bf16 output, that pooling
    the conv tile in bf16 is bit-equal to pooling it in f32 and rounding
    after: the same kernel with an f32 output, rounded to bf16."""
    import torch
    from boda_tpu_torch.ops.cuda.stem import fused_stem
    plan = _stem_plan_str(args, kw, got.dtype, sms)
    if got.dtype != torch.bfloat16:
        return plan
    st = kw.get("stride", 2)
    wide = fused_stem(*args, out_dtype=torch.float32, stride=(st, st))
    check(torch.equal(wide.bfloat16(), got),
          "fused_stem: a bf16 output pooled in bf16 differs from the f32 "
          "output rounded to bf16")
    return plan + " bf16 pool bit-equal to f32 pool + rounding"


def _resblock_plan_str(args, sms: int, force=None) -> str:
    """resblock's plan for a case: its route, the output rows of a band,
    the cluster that shares a band, the block tile and the grid."""
    from boda_tpu_torch.ops.cuda.resblock import resblock_plan
    x, w1 = args[:2]
    n, H, W, C = x.shape
    p = resblock_plan(n, H, W, C, w1.shape[0], x.element_size(), sms)
    if force is not None:
        ty, cluster, tile_m, tile_n = force
        return (f"forced {p.route} ty {ty} cluster {cluster} tile "
                f"{tile_m}x{tile_n}")
    return (f"plan {p.route} ty {p.ty} cluster {p.cluster} tile "
            f"{p.tile_m}x{p.tile_n} blocks {p.blocks}"
            f"{'' if p.vec or p.route == 'mma' else ' element-staged'}")


def _matmul_plan_str(args, sms: int) -> str:
    """matmul_ext's plan for a case: its route, block tile, K splits and
    whether its operands move in 16-byte copies."""
    from boda_tpu_torch.ops.cuda.sgemm import matmul_plan
    a, b = args[:2]
    (M, K), N = a.shape, b.shape[0]
    p = matmul_plan(M, N, K, a.dtype, sms)
    return (f"plan {p.route} tile {p.tile_m}x{p.tile_n} splits {p.splits}"
            f"{'' if p.vec else ' element-staged'}")


# (n, H = W, C = oc): the ResNet-50 3x3 convs that reach tconv
SPLIT_SHAPES = [(1, 7, 512), (32, 7, 512), (32, 14, 256), (32, 28, 128)]


def _tconv_splits(dev) -> None:
    """The tconv kernel alone, timed by K split count at the ResNet-50 3x3
    shapes, for the planner's split rule: the planned count, powers of two
    up to 16, and twice the planned count, each through the C entry point
    with its buffers allocated once."""
    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    from boda_tpu_torch.ops.cuda.tconv import tconv_plan
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, H, C in SPLIT_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(n, H, H, C, device=dev).to(dt)
            w = (torch.randn(C, 3, 3, C, device=dev) * 0.02).to(dt)
            b = torch.randn(C, device=dev)
            out = torch.empty(n, H, H, C, device=dev, dtype=dt)
            plan = tconv_plan(n, H, H, C, C, 3, 3, dt, (1, 1), sms)
            bf = int(dt == torch.bfloat16)
            row = []
            for sp in sorted({1, 2, 4, 8, 16, plan.splits, 2 * plan.splits}):
                ws = torch.empty(sp, n * H * H, C, device=dev)

                def run():
                    check(lib.boda_tconv(
                        x.data_ptr(), w.data_ptr(), b.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), n, H, H, C, C, 3, 3,
                        1, 1, bf, bf, 1, sp, int(plan.vec), stream) == 0,
                        f"tconv splits={sp}: launch failed")
                row.append(f"{sp}: {cuda_ms(run, 50):.4f}")
            print(f"tconv splits n={n} {H}^2 C={C} {str(dt)[6:]}: planned "
                  f"{plan.splits} on {sms} SMs; ms by splits "
                  + " ".join(row), flush=True)


# (M, K, N): the fc1000 at batch 1 and 32, res5a_branch2a at batch 1 and 32,
# and at batch 32 res4b_branch2a (98 tiles) and res5b_branch2c (208 tiles)
MATMUL_SPLIT_SHAPES = [(1, 2048, 1000), (32, 2048, 1000), (49, 1024, 512),
                       (1568, 1024, 512), (6272, 1024, 256),
                       (1568, 512, 2048)]


def _matmul_splits(dev) -> None:
    """The matmul_ext kernel alone, timed by K split count at small-grid
    shapes of ResNet-50, for the planner's split rule: the planned count,
    powers of two up to 64 and twice the planned count (each at most the
    chunk count), through the C entry point with its buffers allocated
    once."""
    import math

    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    from boda_tpu_torch.ops.cuda.sgemm import matmul_plan
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for M, K, N in MATMUL_SPLIT_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            a = torch.randn(M, K, device=dev).to(dt)
            b = (torch.randn(N, K, device=dev) * K ** -0.5).to(dt)
            bias = torch.randn(N, device=dev)
            c = torch.empty(M, N, device=dev, dtype=dt)
            plan = matmul_plan(M, N, K, dt, sms)
            chunks = math.ceil(K / plan.bk)
            bf = int(dt == torch.bfloat16)
            row = []
            for sp in sorted({1, 2, 4, 8, 16, 32, 64, plan.splits,
                              2 * plan.splits}):
                if sp > chunks:
                    continue
                ws = torch.empty(sp, M, N, device=dev)

                def run():
                    check(lib.boda_matmul_ext(
                        a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                        c.data_ptr(), M, N, K, bf, bf, 0, ws.data_ptr(),
                        plan.tile_n, sp, int(plan.vec), stream) == 0,
                        f"matmul_ext splits={sp}: launch failed")
                row.append(f"{sp}: {cuda_ms(run, 50):.4f}")
            print(f"matmul splits M={M} K={K} N={N} {str(dt)[6:]}: tile "
                  f"{plan.tile_m}x{plan.tile_n}, planned {plan.splits} on "
                  f"{sms} SMs; ms by splits " + " ".join(row), flush=True)


# (n, H = W, C, Cm): the identity bottlenecks of ResNet-50's four stages at
# batch 32, and res5 at batch 1
RESBLOCK_PLAN_SHAPES = [(32, 56, 256, 64), (32, 28, 512, 128),
                        (32, 14, 1024, 256), (32, 7, 2048, 512),
                        (1, 7, 2048, 512)]
RESBLOCK_PLAN_TYS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 14)


def _resblock_plans(dev, gen) -> None:
    """The resblock kernel alone by cluster size, tile and band rows at the
    ResNet-50 stages, for the planner's estimate: each (cluster, tile, ty)
    that fits runs through the C entry point, is held against the plain
    version (f32 mrd 1e-4, bf16 5e-3), and is timed beside the plan's
    estimate in microseconds and the clusters of that launch the card
    holds at once (cudaOccupancyMaxActiveClusters)."""
    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    from boda_tpu_torch.ops.cuda.resblock import CLUSTERS, plan_candidate, \
        plan_tiles, resblock_plain, resblock_plan
    lib = load_kernels()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, H, C, Cm in RESBLOCK_PLAN_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            kw = dict(n=n, H=H, W=H, C=C, Cm=Cm)
            _, args = _kernel_args("resblock", kw, dt, dev, gen)
            want = resblock_plain(*args)
            out = torch.empty_like(args[0])
            es = args[0].element_size()
            plan = resblock_plan(n, H, H, C, Cm, es, sms)
            toler = F32_MRD if dt == torch.float32 else BF16_MRD
            best = None
            for cluster in CLUSTERS:
                for tile_m, tile_n in plan_tiles(C, Cm, es, cluster):
                    row = []
                    for ty in sorted({t for t in RESBLOCK_PLAN_TYS + (H,)
                                      if t <= H} | {plan.ty}):
                        cand = plan_candidate(n, H, H, C, Cm, es, sms, ty,
                                              cluster, tile_m, tile_n)
                        if cand is None:
                            continue
                        force = (ty, cluster, tile_m, tile_n)
                        out.zero_()
                        _resblock_forced(args, dt, force, out)
                        torch.cuda.synchronize()
                        err = mrd(out, want)
                        check(err <= toler, f"resblock {kw} {dt} under "
                                            f"{force}: mrd {err:.3e} > "
                                            f"{toler:g}")
                        ms = cuda_ms(lambda: _resblock_forced(
                            args, dt, force, out), 10)
                        bf = int(dt == torch.bfloat16)
                        held = lib.boda_resblock_max_clusters(
                            H, H, C, Cm, ty, cluster,
                            int(plan.route == "mma"), tile_m, tile_n,
                            int(plan.vec), bf, bf)
                        check(held > 0, f"resblock {kw} {dt} under {force}: "
                                        f"no resident cluster ({held})")
                        row.append(f"{ty}: {ms:.4f} ({cand[0]:.0f}; {held})")
                        if best is None or ms < best[0]:
                            best = (ms, force)
                    if row:
                        print(f"resblock plan n={n} {H}^2 C={C} Cm={Cm} "
                              f"{str(dt)[6:]} {plan.route} cluster {cluster} "
                              f"tile {tile_m}x{tile_n}: ms (estimated us; "
                              f"clusters held at once) by ty "
                              + " ".join(row), flush=True)
            print(f"resblock plan n={n} {H}^2 C={C} Cm={Cm} {str(dt)[6:]}: "
                  f"planned ty {plan.ty} cluster {plan.cluster} tile "
                  f"{plan.tile_m}x{plan.tile_n} on {sms} SMs; fastest "
                  f"{best[0]:.4f} ms at ty {best[1][0]} cluster {best[1][1]} "
                  f"tile {best[1][2]}x{best[1][3]}", flush=True)
            del args, want, out


# (ty, tx): tiles of pooled outputs the `stem plan` sweep times
STEM_PLAN_TILES = [(7, 8), (4, 8), (3, 8), (2, 8), (7, 4), (4, 4), (4, 16),
                   (3, 16), (2, 16), (6, 4), (8, 8)]


def _stem_forced(args, out, plan, ty, tx, wk):
    """The fused_stem kernel through its C entry point under a given tile
    instead of stem_plan's choice, with wk as the room for the reordered
    filter; the rest follows `plan`."""
    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    x, w, bias, pad, pool = args[:5]
    n, H, W, C = x.shape
    oc, _, ky, kx = w.shape
    rc = load_kernels().boda_fused_stem(
        x.data_ptr(), w.data_ptr(), wk.data_ptr(), bias.data_ptr(),
        out.data_ptr(),
        n, H, W, C, oc, ky, kx, 2, 2, pad[0], pad[1], pool[0][0], pool[0][1],
        pool[1][0], pool[1][1], out.shape[1], out.shape[2], ty, tx,
        int(plan.route == "mma"), int(plan.vec), plan.Kp,
        plan.blocks, int(x.dtype == torch.bfloat16),
        int(out.dtype == torch.bfloat16), 1,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc == 0, f"fused_stem forced tile {ty}x{tx}: launch failed with "
                   f"cudaError {rc}")
    return out


def _stem_forced_case(args, out_dtype, force):
    """A fused_stem case (7x7/s2, 3x3/s2 pool) under a forced tile (ty,
    tx); route, copies and filter layout as the plan has them."""
    import torch
    from boda_tpu_torch.ops.cuda.stem import fused_stem_plain, plan_candidate, \
        stem_filter
    x, w = args[:2]
    n, H, W, C = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    cand = plan_candidate(n, H, W, C, w.shape[0], x.element_size(), sms,
                          (7, 7), (2, 2), (3, 3), ((3, 3), (2, 2)),
                          out_dtype.itemsize, *force)
    check(cand is not None, f"fused_stem forced {force}: does not fit")
    plan = cand[1]
    shape = fused_stem_plain(*args).shape
    out = torch.empty(shape, device=x.device, dtype=out_dtype)
    wk = torch.empty_like(stem_filter(w, plan.lead, plan.KR, plan.Kp))
    _stem_forced(args, out, plan, *force, wk)
    check(torch.equal(wk, stem_filter(w, plan.lead, plan.KR, plan.Kp)),
          f"fused_stem forced {force}: the kernel's filter reorder differs "
          f"from stem_filter")
    return out


def _stem_plans(dev, gen) -> None:
    """The fused_stem launches alone (the filter reorder and the stem
    kernel, buffers allocated once) by tile at ResNet-50's conv1 + pool1,
    batch 32 and 1,
    for the planner's estimate: each candidate that fits runs through the C
    entry point, is held against the plain version (f32 mrd 1e-4, bf16
    5e-3) and is timed beside the plan's estimate in microseconds and the
    blocks of it an SM holds (the card's occupancy query, which the plan's
    own count must equal, as its shared-memory sum must the kernel's)."""
    import torch
    from boda_tpu_torch.ops.cuda.build import load_kernels
    from boda_tpu_torch.ops.cuda.stem import fused_stem_plain, \
        plan_candidate, stem_filter, stem_plan
    lib = load_kernels()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (32, 1):
        for dt in (torch.float32, torch.bfloat16):
            kw = dict(n=n, H=224, W=224, C=3, oc=64)
            _, args = _kernel_args("fused_stem", kw, dt, dev, gen)
            x, w = args[:2]
            es = x.element_size()
            want = fused_stem_plain(*args)
            geom = ((7, 7), (2, 2), (3, 3), ((3, 3), (2, 2)), es)
            plan = stem_plan(n, 224, 224, 3, 64, es, sms)
            wk_want = stem_filter(w, plan.lead, plan.KR, plan.Kp)
            wk = torch.zeros_like(wk_want)
            out = torch.empty(n, 56, 56, 64, device=dev, dtype=dt)
            toler = F32_MRD if dt == torch.float32 else BF16_MRD
            bf = int(dt == torch.bfloat16)
            best, row = None, []
            for ty, tx in sorted(set(STEM_PLAN_TILES) | {(plan.ty, plan.tx)}):
                cand = plan_candidate(n, 224, 224, 3, 64, es, sms, *geom, ty,
                                      tx)
                if cand is None:
                    continue
                est, cp = cand
                q = (224, 224, 3, 64, 7, 7, 2, 2, 3, 3, 3, 3, 2, 2, 56, 56,
                     ty, tx, int(cp.route == "mma"), int(cp.vec), cp.Kp, bf,
                     bf)
                smem = lib.boda_fused_stem_smem(*q)
                per_sm = lib.boda_fused_stem_blocks_per_sm(*q)
                check((smem, per_sm) == (cp.smem, cp.per_sm),
                      f"fused_stem {ty}x{tx} {dt}: the plan counts {cp.smem} "
                      f"bytes and {cp.per_sm} blocks per SM, the kernel "
                      f"{smem} and {per_sm}")
                out.zero_()
                _stem_forced(args, out, cp, ty, tx, wk)
                torch.cuda.synchronize()
                err = mrd(out, want)
                check(err <= toler, f"fused_stem n={n} {dt} tile {ty}x{tx}: "
                                    f"mrd {err:.3e} > {toler:g}")
                check(torch.equal(wk, wk_want), "fused_stem: the kernel's "
                      "filter reorder differs from stem_filter")
                ms = cuda_ms(lambda: _stem_forced(args, out, cp, ty, tx, wk),
                             20)
                row.append(f"{ty}x{tx}: {ms:.4f} ({est:.0f}; {per_sm})")
                if best is None or ms < best[0]:
                    best = (ms, ty, tx)
            print(f"stem plan n={n} 224^2 3->64 {str(dt)[6:]} {plan.route}: "
                  f"ms (estimated us; blocks per SM) by tile "
                  + " ".join(row), flush=True)
            print(f"stem plan n={n} 224^2 3->64 {str(dt)[6:]}: planned "
                  f"{plan.ty}x{plan.tx} blocks {plan.blocks} on {sms} SMs; "
                  f"fastest {best[0]:.4f} ms at {best[1]}x{best[2]}",
                  flush=True)
            del args, want, out


def phase_vendor(ctx: dict) -> None:
    """The vendor conv under prec=bf16 with NHWC bf16 storage at the 21
    ResNet-50 b32 conv sigs: the template's form (F.conv2d in FP32 on the
    bf16-rounded operands, channels_last) must come back channels_last (no
    permute copy around the step) and agree with the f64 conv of the rounded
    operands after the one rounding of the store; beside it, timed here and
    used nowhere in the port, the bf16 cuDNN form that rounds the sum before
    the bias: its mrd against the template's result, the share of stored
    values it moves, and its time."""
    import torch
    import torch.nn.functional as F
    from boda_tpu_torch.ops.cuda.conv import conv_params, vendor_conv
    from boda_tpu_torch.ops.op_base import read_op_sigs
    from boda_tpu_torch.ops.registry import get_template
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    cl = torch.channels_last
    tot = {"fp32": 0.0, "bf16": 0.0}
    worst = (0.0, 0.0)
    ops = read_op_sigs(DATA / "ops" / "resnet50-convs.txt")
    for op in ops:
        ind, outd, fd, sy, sx, py, px, relu = conv_params(op)
        n, C, H, W = ind.shape
        oc, _, ky, kx = fd.shape
        x = torch.randn(n, H, W, C, device=dev, generator=gen).bfloat16()
        w = torch.randn(oc, C, ky, kx, device=dev, generator=gen) \
            * (C * ky * kx) ** -0.5
        b = torch.randn(oc, device=dev, generator=gen) * 0.5
        top = op.copy()
        top.set_func_name("xla_conv")
        top.str_vals.update(prec="bf16", io_layout="nhwc", edge_prec="bf16")
        t = get_template("xla_conv")
        fn = t.build(t.check_args(top))
        got = fn(x, w, b)
        y = vendor_conv((sy, sx), (py, px), torch.bfloat16, True)(x, w, b)
        check(y.is_contiguous(memory_format=cl) and got.is_contiguous()
              and got.dtype == torch.bfloat16,
              f"vendor {_op_label(op)}: the conv's result is not "
              f"channels_last, or the step's output not contiguous NHWC")
        xc = x.permute(0, 3, 1, 2)
        want = F.conv2d(xc.double(), w.bfloat16().double(), b.double(),
                        stride=(sy, sx), padding=(py, px))
        want = (torch.relu(want) if relu else want).permute(0, 2, 3, 1)
        err = mrd(got, want)
        check(err <= BF16_MRD, f"vendor {_op_label(op)}: mrd {err:.3e}")
        wb = w.bfloat16().contiguous(memory_format=cl)

        def bf16_form():
            z = F.conv2d(xc, wb, stride=(sy, sx), padding=(py, px)) \
                + b[None, :, None, None]
            z = torch.relu(z) if relu else z
            return z.bfloat16().permute(0, 2, 3, 1).contiguous()
        alt = bf16_form()
        alt_err = mrd(alt, got)
        moved = float((alt != got).float().mean())
        ms = cuda_ms(lambda: fn(x, w, b), 5)
        alt_ms = cuda_ms(bf16_form, 5)
        if (ky, sy, C) == (3, 1, 256):
            # the device kernels of one step (res4's 3x3), by name
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(x, w, b)
                torch.cuda.synchronize()
            profiled = _op_label(op)
        tot["fp32"] += ms
        tot["bf16"] += alt_ms
        worst = max(worst, (alt_err, moved))
        print(f"vendor {_op_label(op):34s} template (FP32 on rounded "
              f"operands, channels_last) mrd {err:.3e} vs f64, {ms:.4f} ms; "
              f"bf16 cuDNN form mrd {alt_err:.3e} vs the template, moves "
              f"{100 * moved:.1f}% of the stored values, {alt_ms:.4f} ms")
    print(f"vendor: {len(ops)} sigs; template {tot['fp32']:.3f} ms, bf16 "
          f"cuDNN form {tot['bf16']:.3f} ms; the bf16 form's largest mrd "
          f"against the template {worst[0]:.3e} (gate 5e-3), moving "
          f"{100 * worst[1]:.1f}% of the values there, on [{ctx['smi']}]")
    print(f"vendor {profiled}: device kernels of one step: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.4f} ms"
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0))
    ctx["vendor_ms"] = tot


def _nodes_to_get(pipe):
    return [n for n, nd in pipe.nodes.items()
            if nd.dims is not None and nd.top_for]


def phase_digests(ctx: dict) -> None:
    from boda_tpu_torch.apps.train import load_weights_into_pipe
    from boda_tpu_torch.core.dims import NDA
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.engine.torch_fwd import produced_nodes
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.ops.cuda.gen_data import gen_test_nda
    from boda_tpu_torch.testing.comp import comp_digests, read_digest_stream
    for archive, kw, wfn, toler in (
            ("resnet-50@shapes40", {"num_classes": 40}, TRAINED, 3e-3),
            ("resnet-50", {}, None, 8e-3)):
        kg = read_digest_stream(DATA / "tpu_digests" / archive /
                                "digest-rtc.boda")
        for tune_name in ("f32", "fused_f32", "sib_f32"):
            t0 = time.perf_counter()
            pipe = build_model("resnet-50", batch=1, **kw)
            if wfn is not None:
                load_weights_into_pipe(pipe, str(wfn))
            eng = make_engine(f"(engine=torch,device=cuda,keep_all_nodes=1,"
                              f"op_tune={TUNES[tune_name]})")
            eng.init(pipe)
            d = pipe.get_data_img_dims()
            blob = NDA(d, gen_test_nda(d, 0, 0.1))
            # a fused plan has no values for its fused ops' interior nodes
            produced = produced_nodes(eng.plan)
            outs = eng.run_fwd({pipe.data_img_node_names[0]: blob},
                               [n for n in _nodes_to_get(pipe)
                                if n in produced])
            want = {k: v for k, v in kg.items() if k in produced}
            missing = [k for k in want if k not in outs]
            check(not missing, f"digests {archive} {tune_name}: nodes "
                               f"missing: {missing[:5]}")
            check(tune_name != "f32" or len(want) == len(kg),
                  f"digests {archive}: the f32 plan lacks "
                  f"{len(kg) - len(want)} archived nodes")
            errs = comp_digests(outs, want, toler)
            print(f"digests {archive} {tune_name}: {len(want)} of {len(kg)} "
                  f"nodes vs TPU archive, mrd toler {toler:g}: {len(errs)} "
                  f"mismatches ({time.perf_counter() - t0:.1f} s)")
            for e in errs[:10]:
                print(f"  {e}")
            check(not errs, f"digests {archive} {tune_name}: {len(errs)} "
                            f"mismatches")
            del eng


def _cls_agree(tune_a: str, tune_b: str) -> dict:
    """cls_agree of engine=torch under two tunes on the 64 held-out images;
    returns its statistics, checked against the accuracy gates."""
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    src = ("(mode=shapes-src,num_imgs=64,start_ix=100000,ysz=224,xsz=224,"
           "num_classes=40,seed=1,mean=128,scale=0.015625)")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        create_and_run_has_main(
            f"(mode=cls_agree,model=resnet-50,model_opts=(num_classes=40),"
            f"batch=32,weights_fn={TRAINED},src={src},"
            f"conv_fwd=(engine=torch,op_tune={TUNES[tune_a]}),"
            f"conv_fwd_b=(engine=torch,op_tune={TUNES[tune_b]}))", {})
    out = buf.getvalue().strip()
    print(f"cls_agree (a={tune_a}, b={tune_b}, "
          f"{time.perf_counter() - t0:.1f} s): "
          f"{out.splitlines()[-1] if out else '<no output>'}")
    stats = {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)", out)}
    check(stats.get("num_test") == 64, f"cls_agree: num_test {stats}")
    check(stats["top_1_acc_a"] >= 0.90 and stats["top_1_acc_b"] >= 0.90,
          f"cls_agree {tune_a} vs {tune_b}: top-1 below 0.90: {stats}")
    check(stats["top_1_agree"] >= 0.97,
          f"cls_agree {tune_a} vs {tune_b}: agreement {stats}")
    return stats


def phase_agree(ctx: dict) -> None:
    for tune_a in ("bf16_nhwc", "fused_bf16_nhwc", "headline"):
        _cls_agree(tune_a, "f32")


def _wrappers() -> dict:
    """Each kernel's wrapper, whose `launches` counts its launches
    ("quantize": sgemm_int8's quantize kernel)."""
    from boda_tpu_torch.ops.cuda.qsgemm import quantize_operands, sgemm_int8
    from boda_tpu_torch.ops.cuda.resblock import resblock
    from boda_tpu_torch.ops.cuda.sgemm import matmul_ext
    from boda_tpu_torch.ops.cuda.stem import fused_stem
    from boda_tpu_torch.ops.cuda.tconv import tconv
    return {"matmul_ext": matmul_ext, "tconv": tconv,
            "fused_stem": fused_stem, "resblock": resblock,
            "sgemm_int8": sgemm_int8, "quantize": quantize_operands}


def _op_label(op) -> str:
    """A short name for an op sig of the per-op sweep."""
    if op.type == "sgemm":
        a, b = op.get_dims("a"), op.get_dims("b")
        return f"sgemm {a['M']}x{a['K']}x{b['N']}"
    f, i = op.get_dims("filts"), op.get_dims("in")
    st = op.get_dims("stride")
    return (f"conv {f['y']}x{f['x']}/s{st['y']} {f['in_chan']}->"
            f"{f['out_chan']} {i['y']}^2 b{i['img']}")


def _tune_specs(tunes: str) -> dict[str, str]:
    """'(kg=(use_culibs=1),hand=())' -> {'kg': '(use_culibs=1)', 'hand': '()'}"""
    return dict(re.findall(r"(\w+)=(\((?:[^()]|\([^()]*\))*\))", tunes[1:-1]))


def _ops_prof_table(text: str, tunes: str, peaks) -> list[str]:
    """One row per OP line of a torch_ops_prof run: ms, TF/s (TOPS for
    int8) and % of the card's peak in the op's own precision."""
    from boda_tpu_torch.ops.cnn_variants import add_codegen_annotations, \
        make_op_tune
    from boda_tpu_torch.ops.op_base import OpBase
    from boda_tpu_torch.tune.opinfo import op_prec
    tune_specs = _tune_specs(tunes)
    rows = []
    for m in re.finditer(r"^OP (\(.*\)) tune=(\w+) be=\w+ func=(\w+) "
                         r"secs=(\S+) GF/s=(\S+) ", text, re.M):
        op = OpBase.from_lexp(m[1])
        top = op.copy()
        tune = make_op_tune(tune_specs[m[2]])
        add_codegen_annotations(top, tune)
        prec = op_prec(top, tune.prec)
        tfs = float(m[5]) / 1e3
        rows.append(f"  {_op_label(op):34s} {m[2]:5s} {m[3]:10s} "
                    f"{float(m[4]) * 1e3:9.4f} ms {tfs:8.2f} "
                    f"{'TOPS ' if prec == 'int8' else 'TF/s '}"
                    f"{100 * tfs * 1e12 / peaks.flops(prec):6.2f}% of {prec} "
                    f"peak")
    return rows


def _check_vendor_sgemm_bf16(dev) -> None:
    """The vendor sgemm template (xla_sgemm, the kg tune's) under prec=bf16
    on the card: an f32 product of the bf16-rounded operands, not rounded
    again (within 1e-5 of the f64 product of the rounded operands, and not
    a bf16 value)."""
    import torch
    from boda_tpu_torch.ops.op_base import OpBase
    from boda_tpu_torch.ops.registry import get_template
    M, K, N = 256, 1024, 192
    op = OpBase.from_lexp(f"(type=sgemm,str_vals=(prec=bf16),dims_vals=("
                          f"a=(M={M},K={K}),b=(K={K},N={N}),c=(M={M},N={N})))")
    t = get_template("xla_sgemm")
    gen = torch.Generator(device=dev).manual_seed(2)
    a = torch.randn(M, K, device=dev, generator=gen)
    b = torch.randn(K, N, device=dev, generator=gen) * K ** -0.5
    got = t.build(t.check_args(op))(a, b)
    want = a.bfloat16().double() @ b.bfloat16().double()
    err = mrd(got, want)
    rounded = bool(torch.equal(got, got.bfloat16().float()))
    print(f"xla_sgemm prec=bf16 M={M} K={K} N={N}: {got.dtype}, mrd {err:.3e} "
          f"(<= 1e-5) against the f64 product of the bf16 operands; a bf16 "
          f"value: {rounded}")
    check(got.dtype == torch.float32 and err <= 1e-5 and not rounded,
          "xla_sgemm under prec=bf16 does not return the unrounded f32 "
          "product")


def phase_ops_prof(ctx: dict) -> None:
    """The per-op path: torch_ops_prof on be=torch over the SGEMM sizes and
    the ResNet-50 b32 conv sigs, then torch_rtc_test, each in-process
    through the mode a user runs (python -m boda_tpu_torch <mode>)."""
    import torch
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    from boda_tpu_torch.core.machine import card_peaks
    from boda_tpu_torch.tune.wisdom import read_wisdom_file
    peaks = card_peaks(torch.cuda.get_device_name(0))
    out_dir = ROOT / "build" / "ops_prof"
    wrappers = _wrappers()
    _check_vendor_sgemm_bf16(torch.device("cuda", 0))
    for name, ops_fn, tunes, tol in OPS_PROF:
        for w in wrappers.values():
            w.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                create_and_run_has_main(
                    f"(mode=torch_ops_prof,ops_fn={DATA / 'ops' / ops_fn},"
                    f"op_tunes={tunes},run_iter={OPS_RUN_ITER},"
                    f"{tol + ',' if tol else ''}boda_output_dir={out_dir},"
                    f"wisdom_out_fn={name}.wis)", {})
        finally:
            text = buf.getvalue()
            for ln in text.splitlines():
                if "COMP_FAIL" in ln or "KG_DIGEST_FAIL" in ln \
                        or "ERROR" in ln or "UNVERIFIED" in ln:
                    print(f"  {ln}")
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        n_ok = len(re.findall(r"^OP .* ok$", text, re.M))
        print(f"torch_ops_prof {name} ({ops_fn}, {tunes} {tol}): {n_ok} runs "
              f"ok, launches {counts} ({time.perf_counter() - t0:.1f} s)")
        for row in _ops_prof_table(text, tunes, peaks):
            print(row)
        n_ops = len((DATA / "ops" / ops_fn).read_text().split())  # 1 per line
        n_tunes = len(_tune_specs(tunes))
        check(n_ok == n_ops * n_tunes,
              f"torch_ops_prof {name}: {n_ok} runs ok of {n_ops * n_tunes}")
        plats = {p for w in read_wisdom_file(out_dir / f"{name}.wis")
                 for t in w.tunes.values() for p in t.runs}
        check(plats == {f"torch:cuda:{torch.cuda.get_device_name(0)}"},
              f"torch_ops_prof {name}: wisdom plat tags {plats}")
        if name == "sgemm":
            for k in ("sgemm_int8", "quantize"):
                check(counts[k] == OPS_INT8_LAUNCHES,
                      f"torch_ops_prof {name}: {counts[k]} {k} launches != "
                      f"{OPS_INT8_LAUNCHES}")
            ctx.setdefault("launches", {})["ops_prof"] = counts
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        create_and_run_has_main("(mode=torch_rtc_test,n=1048576)", {})
    line = buf.getvalue().splitlines()[0]
    print(line)
    check(line.startswith("torch_rtc_test PASSED plat=torch:cuda:"),
          f"torch_rtc_test: {line}")
    print(f"  on [{ctx['smi']}]")


def _template_ms(eng, inputs: dict, top: str) -> dict:
    """{template: (steps, summed ms)} over one forward of `eng`, each step
    between two CUDA events."""
    import torch
    events = []

    @contextlib.contextmanager
    def timed(step):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        yield
        t1.record()
        events.append((step.func_name, t0, t1))

    with torch.inference_mode():
        eng.fwd(inputs, eng.weights, step_hook=timed)[top]
    torch.cuda.synchronize()
    per: dict = {}
    for f, t0, t1 in events:
        n, t = per.get(f, (0, 0.0))
        per[f] = (n + 1, t + t0.elapsed_time(t1))
    return per


def _device_busy_ms(fn) -> float:
    """Milliseconds the card spends in kernels and copies during one call of
    fn: the sum of the device events of torch.profiler's trace (one stream,
    so they do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    check(busy > 0, "torch.profiler recorded no device time")
    return busy


def phase_full(ctx: dict) -> None:
    import torch
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    wrappers = _wrappers()
    batch = 32
    launches = ctx.setdefault("launches", {})
    for tune_name in FULL_TUNES:
        tune = TUNES[tune_name]
        buf = io.StringIO()
        for w in wrappers.values():
            w.launches = 0
        with contextlib.redirect_stdout(buf):
            hm = create_and_run_has_main(
                f"(mode=run_cnet,model=resnet-50,batch={batch},dump_top=1,"
                f"conv_fwd=(engine=torch,op_tune={tune}))", {})
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        launches[tune_name] = counts
        dig = [ln for ln in buf.getvalue().splitlines()
               if ln.startswith("digest:")]
        print(f"run_cnet resnet-50 b{batch} {tune_name} {tune}: launches "
              f"{counts}; {dig[0] if dig else '<no digest line>'}")
        check(counts == LAUNCHES[tune_name],
              f"run_cnet {tune_name}: launches {counts} != "
              f"{LAUNCHES[tune_name]}")
        eng = hm.conv_fwd
        steps = {}
        for s in eng.plan.steps:
            steps[s.func_name] = steps.get(s.func_name, 0) + 1
        print(f"  steps: {steps}")
        # what the lowering sent where: one launch per step of a template
        # that wraps a hand kernel
        planned = dict.fromkeys(counts, 0)
        for f, k in steps.items():
            if f in TEMPLATE_KERNEL:
                planned[TEMPLATE_KERNEL[f]] += k
        check(counts == planned, f"run_cnet {tune_name}: launches {counts} "
                                 f"!= the plan's steps {planned}")
        check(("xla_conv2" in steps) == ("fuse_siblings" in tune),
              f"run_cnet {tune_name}: xla_conv2 steps {steps}")
        pipe = hm.pipe
        d = pipe.get_data_img_dims()
        data = pipe.data_img_node_names[0]
        top = pipe.get_single_top_node().name
        gen = torch.Generator(device=eng.dev).manual_seed(1)
        x = torch.randn(tuple(d.shape), device=eng.dev, generator=gen)
        with torch.inference_mode():
            def fwd():
                return eng.fwd({data: x}, eng.weights)[top]
            prob = fwd()
            ms = cuda_ms(fwd, 10)
        p = prob.float()
        check(tuple(p.shape) == (batch, 1000, 1, 1),
              f"{tune_name}: prob shape {tuple(p.shape)}")
        check(bool(torch.isfinite(p).all()), f"{tune_name}: non-finite prob")
        row_err = float((p.sum(dim=1) - 1).abs().max())
        check(row_err < 1e-2, f"{tune_name}: softmax rows off by {row_err}")
        print(f"  forward (device-resident input, CUDA events, 10 reps): "
              f"{ms:.3f} ms = {batch / ms * 1e3:.1f} imgs/s on "
              f"[{ctx['smi']}]")
        ctx.setdefault("fwd_ms", {})[tune_name] = ms
        with torch.inference_mode():
            busy = _device_busy_ms(fwd)
        print(f"  device busy {busy:.3f} ms of the forward's {ms:.3f} ms "
              f"({100 * (1 - busy / ms):.1f}% idle; the kernels and copies "
              f"of one more forward in torch.profiler's device trace)")
        ctx.setdefault("busy_ms", {})[tune_name] = busy
        per = _template_ms(eng, {data: x}, top)
        print("  per template, one more forward (CUDA events per step): "
              + ", ".join(f"{f} x{n} {t:.3f} ms" for f, (n, t) in
                          sorted(per.items(), key=lambda kv: -kv[1][1]))
              + f"; sum {sum(t for _, t in per.values()):.3f} ms")
        ctx.setdefault("template_ms", {})[tune_name] = {
            f: {"steps": n, "ms": t} for f, (n, t) in per.items()}
        del hm, eng
        torch.cuda.empty_cache()
    _headline_b128(ctx)


def _headline_b128(ctx: dict) -> None:
    """One forward time of the headline tune at the JAX bench's batch, 128
    (zoo weights from a seed; CUDA events, 5 reps)."""
    import torch
    from boda_tpu_torch.engine.iface import make_engine
    from boda_tpu_torch.models.zoo import build_model
    batch = 128
    pipe = build_model("resnet-50", batch=batch)
    eng = make_engine(f"(engine=torch,op_tune={TUNES['headline']})")
    eng.init(pipe)
    data = pipe.data_img_node_names[0]
    top = pipe.get_single_top_node().name
    gen = torch.Generator(device=eng.dev).manual_seed(1)
    x = torch.randn(tuple(pipe.get_data_img_dims().shape), device=eng.dev,
                    generator=gen)
    with torch.inference_mode():
        def fwd():
            return eng.fwd({data: x}, eng.weights)[top]
        p = fwd().float()
        ms = cuda_ms(fwd, 5)
    check(tuple(p.shape) == (batch, 1000, 1, 1) and
          bool(torch.isfinite(p).all()), "headline b128: bad prob")
    print(f"run_cnet resnet-50 b{batch} headline: forward {ms:.3f} ms = "
          f"{batch / ms * 1e3:.1f} imgs/s on [{ctx['smi']}]")
    ctx["fwd_ms_b128"] = {"headline": ms}
    del eng
    torch.cuda.empty_cache()


PHASES = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
          "vendor": phase_vendor, "digests": phase_digests,
          "agree": phase_agree, "full": phase_full, "ops_prof": phase_ops_prof}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run, in order (default: "
                         "all; the result lines need all)")
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernels the kernels phase is cut "
                         "down to (matmul_ext, tconv, fused_stem, resblock, "
                         "sgemm_int8); no result lines then")
    opts = ap.parse_args()
    phases = opts.phases.split(",")
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        ap.error(f"unknown phases {unknown} (have: {','.join(PHASES)})")
    only_kernels = [k for k in opts.kernels.split(",") if k]
    unknown = [k for k in only_kernels if k not in SOURCES]
    if unknown:
        ap.error(f"unknown kernels {unknown} (have: {','.join(SOURCES)})")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no card, "
              "nothing run", file=sys.stderr)
        return 1
    if not (ROOT / "boda_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repo "
              "(boda_tpu_torch/csrc missing)", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import boda_tpu_torch.modes  # noqa: F401  (the port's modes and engine)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ctx: dict = {"smi": smi_line(), "only_kernels": only_kernels}
    for name in phases:
        t0 = time.perf_counter()
        print(f"== phase {name}", flush=True)
        PHASES[name](ctx)
        print(f"== phase {name} passed ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    for pkg in ("jax", "boda_tpu"):
        if pkg in sys.modules:
            raise SmokeFailure(f"{pkg} was imported")
    if phases != list(PHASES) or only_kernels:
        print(f"chip_smoke: phases {phases} passed"
              f"{' for kernels ' + str(only_kernels) if only_kernels else ''}"
              f"; no result without all of them")
        return 0

    kernels = []
    for name, s in ctx["kernels"].items():
        by_tune = {t: c[name] for t, c in ctx["launches"].items()}
        kernels.append({**s, "launches": by_tune[KERNEL_PATH[name]],
                        "launches_by_tune": by_tune})
        if name == "sgemm_int8":
            kernels[-1]["quantize_launches"] = \
                ctx["launches"]["ops_prof"]["quantize"]
    print(smi_line())
    print(json.dumps({"kernels": kernels,
                      "forward_ms_b32": ctx["fwd_ms"],
                      "forward_ms_b128": ctx["fwd_ms_b128"],
                      "device_busy_ms_b32": ctx["busy_ms"],
                      "template_ms_b32": ctx["template_ms"],
                      "vendor_conv_ms_b32": ctx["vendor_ms"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
