#!/usr/bin/env python3
"""Smoke test of the boda_tpu_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, run in order, each fatal on failure:
  env      card name and power limit (nvidia-smi), torch / CUDA / nvcc versions
  build    nvcc builds the hand-written kernels (boda_tpu_torch/csrc) for sm_90a
  kernels  each kernel against its plain PyTorch version at ResNet-50 shapes
           (timed with CUDA events) and at ragged edge shapes, f32 (mrd <=
           1e-4) and bf16 (mrd <= 5e-3)
  digests  TorchFwd at batch 1 against the per-node digest archives recorded
           on a TPU (tests/data/tpu_digests): resnet-50@shapes40 (trained
           weights, mrd 3e-3) and resnet-50 (zoo weights, mrd 8e-3)
  agree    cls_agree on 64 held-out shapes-src images with the trained
           40-class ResNet-50: bf16+NHWC tune vs f32 tune, top-1 >= 0.90
           each and top-1 agreement >= 0.97
  full     run_cnet on the 1000-class ResNet-50 at batch 32 under both
           tunes: kernel launch counts per forward (40 matmul_ext, 13
           tconv), finite softmax rows, ms per forward and imgs/s

A run that passes ends with three lines: the nvidia-smi name and power
limit; a JSON object with one entry per kernel ("launches": launches in
the f32 run_cnet forward, "launches_bf16_nhwc": in the bf16 one, "ms" and
"plain_ms": summed over the timed shapes, "max_abs_err": over every
checked shape) and the b32 forward times; and {"ok": true, "device":
{...}}. Without a CUDA device, or outside a checkout of the repo, it
exits non-zero and prints no result. It never imports jax.
"""

from __future__ import annotations

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
# the tunes of the main path: the engine default and the bf16 NHWC-storage one
TUNES = {"f32": "()", "bf16_nhwc": "(prec=bf16,layout=nhwc)"}
F32_MRD, BF16_MRD = 1e-4, 5e-3


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
    """Mean milliseconds of fn() on the card: CUDA events around `reps`
    back-to-back calls, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def mrd(got, want) -> float:
    """max |got - want| over max |want| (both cast to f64)."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------- phases

def phase_env(ctx: dict) -> None:
    import torch
    from boda_tpu_torch.core.device import nvcc_path
    ctx["smi"] = smi_line()
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
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"  ptxas: {ln.strip()}")
    build.load_kernels()


def _kernel_cases():
    """(name, kernel, fn kwargs builder) at the shapes the ResNet-50 main
    path gives each kernel. Inputs are made on the card from a seed."""
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
    ]


def _edge_cases():
    """Ragged shapes the ResNet-50 path never gives the kernels (K and C
    not multiples of 4 or of a tile, a 5x5 filter): checked, not timed."""
    return [
        ("edge M=77 K=50 N=33", "matmul_ext", dict(M=77, K=50, N=33, relu=True)),
        ("edge M=1 K=3 N=1", "matmul_ext", dict(M=1, K=3, N=1, relu=False)),
        ("edge 5x5 pad 2 n=2 5x9 C=13 oc=70", "tconv",
         dict(n=2, H=5, W=9, C=13, oc=70, k=5, pad=2, relu=False)),
        ("edge 1x1 n=1 3x3 C=6 oc=5", "tconv",
         dict(n=1, H=3, W=3, C=6, oc=5, k=1, pad=0, relu=True)),
    ]


def phase_kernels(ctx: dict) -> None:
    import torch
    from boda_tpu_torch.ops.cuda.sgemm import matmul_ext, matmul_ext_plain
    from boda_tpu_torch.ops.cuda.tconv import tconv, tconv_plain
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stats: dict[str, dict] = {}
    timed = {c[0] for c in _kernel_cases()}
    for label, kname, kw in _kernel_cases() + _edge_cases():
        for dt in (torch.float32, torch.bfloat16):
            if kname == "matmul_ext":
                M, K, N = kw["M"], kw["K"], kw["N"]
                a = torch.randn(M, K, device=dev, generator=gen).to(dt)
                b = (torch.randn(N, K, device=dev, generator=gen)
                     * K ** -0.5).to(dt)
                bias = torch.randn(N, device=dev, generator=gen)
                args = (a, b, bias, kw["relu"])
                run_k = lambda: matmul_ext(*args, out_dtype=dt)  # noqa: E731
                run_p = lambda: matmul_ext_plain(*args, out_dtype=dt)  # noqa: E731
                ref = lambda: matmul_ext_plain(*args)  # noqa: E731
                source, replaces = "boda_tpu_torch/csrc/sgemm.cu", \
                    "boda_tpu/ops/pallas/sgemm.py:114"
            else:
                n, H, W, C, oc = kw["n"], kw["H"], kw["W"], kw["C"], kw["oc"]
                k, pad = kw.get("k", 3), kw.get("pad", 1)
                x = torch.randn(n, H, W, C, device=dev, generator=gen).to(dt)
                w = (torch.randn(oc, C, k, k, device=dev, generator=gen)
                     * (k * k * C) ** -0.5).to(dt)
                bias = torch.randn(oc, device=dev, generator=gen)
                args = (x, w, bias, (pad, pad), kw["relu"])
                run_k = lambda: tconv(*args, out_dtype=dt)  # noqa: E731
                run_p = lambda: tconv_plain(*args, out_dtype=dt)  # noqa: E731
                ref = lambda: tconv_plain(*args)  # noqa: E731
                source, replaces = "boda_tpu_torch/csrc/tconv.cu", \
                    "boda_tpu/ops/pallas/tconv.py:62"
            got = run_k()
            torch.cuda.synchronize()
            # bf16 outputs are held against the plain version's f32 result
            # (before its own rounding): the kernel's one rounding to bf16
            # then costs at most half an ulp, 2^-8 of the largest value
            want = ref()
            err = mrd(got, want)
            abs_err = float((got.double() - want.double()).abs().max())
            check(bool(torch.isfinite(got.float()).all()),
                  f"{kname} {label} {dt}: non-finite output")
            toler = F32_MRD if dt == torch.float32 else BF16_MRD
            print(f"kernel {kname:10s} {str(dt)[6:]:8s} {label:40s} "
                  f"mrd={err:.3e} (<= {toler:g}) max_abs={abs_err:.3e}",
                  end="")
            check(err <= toler, f"{kname} {label} {dt}: mrd {err:.3e} > "
                                f"{toler:g}")
            if label not in timed:
                print()
                continue
            ms = cuda_ms(run_k, 20)
            plain_ms = cuda_ms(run_p, 20)
            print(f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            s = stats.setdefault(kname, {
                "name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": 0.0, "max_mrd": 0.0,
                "ms": 0.0, "plain_ms": 0.0, "cases": []})
            s["max_abs_err"] = max(s["max_abs_err"], abs_err)
            s["max_mrd"] = max(s["max_mrd"], err)
            s["ms"] += ms
            s["plain_ms"] += plain_ms
            s["cases"].append({"case": label, "dtype": str(dt)[6:],
                               "mrd": err, "ms": ms, "plain_ms": plain_ms})
    ctx["kernels"] = stats


def _nodes_to_get(pipe):
    return [n for n, nd in pipe.nodes.items()
            if nd.dims is not None and nd.top_for]


def phase_digests(ctx: dict) -> None:
    from boda_tpu.apps.train import load_weights_into_pipe
    from boda_tpu.core.dims import NDA
    from boda_tpu.engine.iface import make_engine
    from boda_tpu.models.zoo import build_model
    from boda_tpu.ops.pallas.gen_data import gen_test_nda
    from boda_tpu.testing.comp import comp_digests, read_digest_stream
    for archive, kw, wfn, toler in (
            ("resnet-50@shapes40", {"num_classes": 40}, TRAINED, 3e-3),
            ("resnet-50", {}, None, 8e-3)):
        t0 = time.perf_counter()
        pipe = build_model("resnet-50", batch=1, **kw)
        if wfn is not None:
            load_weights_into_pipe(pipe, str(wfn))
        eng = make_engine("(engine=torch,device=cuda,op_tune=(),"
                          "keep_all_nodes=1)")
        eng.init(pipe)
        d = pipe.get_data_img_dims()
        blob = NDA(d, gen_test_nda(d, 0, 0.1))
        outs = eng.run_fwd({pipe.data_img_node_names[0]: blob},
                           _nodes_to_get(pipe))
        kg = read_digest_stream(DATA / "tpu_digests" / archive /
                                "digest-rtc.boda")
        missing = [k for k in kg if k not in outs]
        check(not missing, f"digests {archive}: nodes missing: {missing[:5]}")
        errs = comp_digests(outs, kg, toler, ignore_missing=True)
        print(f"digests {archive}: {len(kg)} nodes vs TPU archive, "
              f"mrd toler {toler:g}: {len(errs)} mismatches "
              f"({time.perf_counter() - t0:.1f} s)")
        for e in errs[:10]:
            print(f"  {e}")
        check(not errs, f"digests {archive}: {len(errs)} mismatches")


def phase_agree(ctx: dict) -> None:
    from boda_tpu.core.has_main import create_and_run_has_main
    src = ("(mode=shapes-src,num_imgs=64,start_ix=100000,ysz=224,xsz=224,"
           "num_classes=40,seed=1,mean=128,scale=0.015625)")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        create_and_run_has_main(
            f"(mode=cls_agree,model=resnet-50,model_opts=(num_classes=40),"
            f"batch=32,weights_fn={TRAINED},src={src},"
            f"conv_fwd=(engine=torch,op_tune={TUNES['bf16_nhwc']}),"
            f"conv_fwd_b=(engine=torch,op_tune={TUNES['f32']}))", {})
    out = buf.getvalue().strip()
    print(f"cls_agree (a=bf16_nhwc, b=f32, {time.perf_counter() - t0:.1f} s):"
          f" {out.splitlines()[-1] if out else '<no output>'}")
    stats = {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)", out)}
    check(stats.get("num_test") == 64, f"cls_agree: num_test {stats}")
    check(stats["top_1_acc_a"] >= 0.90 and stats["top_1_acc_b"] >= 0.90,
          f"cls_agree: top-1 below 0.90: {stats}")
    check(stats["top_1_agree"] >= 0.97, f"cls_agree: agreement {stats}")


def phase_full(ctx: dict) -> None:
    import torch
    from boda_tpu.core.has_main import create_and_run_has_main
    from boda_tpu_torch.ops.cuda.sgemm import matmul_ext
    from boda_tpu_torch.ops.cuda.tconv import tconv
    batch = 32
    launches = {}
    for tune_name, tune in TUNES.items():
        buf = io.StringIO()
        matmul_ext.launches = tconv.launches = 0
        with contextlib.redirect_stdout(buf):
            hm = create_and_run_has_main(
                f"(mode=run_cnet,model=resnet-50,batch={batch},dump_top=1,"
                f"conv_fwd=(engine=torch,op_tune={tune}))", {})
        torch.cuda.synchronize()
        counts = {"matmul_ext": matmul_ext.launches, "tconv": tconv.launches}
        launches[tune_name] = counts
        dig = [ln for ln in buf.getvalue().splitlines()
               if ln.startswith("digest:")]
        print(f"run_cnet resnet-50 b{batch} {tune_name}: launches {counts}; "
              f"{dig[0] if dig else '<no digest line>'}")
        check(counts == {"matmul_ext": 40, "tconv": 13},
              f"run_cnet {tune_name}: launches {counts} != 40 matmul_ext, "
              f"13 tconv")
        eng = hm.conv_fwd
        steps = {}
        for s in eng.plan.steps:
            steps[s.func_name] = steps.get(s.func_name, 0) + 1
        print(f"  steps: {steps}")
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
        del hm, eng
        torch.cuda.empty_cache()
    ctx["launches"] = launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no card, "
              "nothing run", file=sys.stderr)
        return 1
    if not (ROOT / "boda_tpu_torch" / "csrc").is_dir() or \
            not (ROOT / "boda_tpu").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repo "
              "(boda_tpu_torch/csrc, boda_tpu missing)", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import boda_tpu_torch.engine.torch_fwd  # noqa: F401  (registers engine=torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ctx: dict = {}
    for name, fn in (("env", phase_env), ("build", phase_build),
                     ("kernels", phase_kernels), ("digests", phase_digests),
                     ("agree", phase_agree), ("full", phase_full)):
        t0 = time.perf_counter()
        print(f"== phase {name}", flush=True)
        fn(ctx)
        print(f"== phase {name} passed ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if "jax" in sys.modules:
        raise SmokeFailure("jax was imported")

    kernels = []
    for name, s in ctx["kernels"].items():
        kernels.append({**s, "launches": ctx["launches"]["f32"][name],
                        "launches_bf16_nhwc":
                            ctx["launches"]["bf16_nhwc"][name]})
    print(smi_line())
    print(json.dumps({"kernels": kernels,
                      "forward_ms_b32": ctx["fwd_ms"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
