"""Run one cell of the benchmark once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads the cell (`spec.py`), makes the weights,
the request pool and, for int8 sites, the static activation scales from the
seed (`weights.py`, the reference's calibration), builds the port's engine
(`program.py`), warms up the cell's one shape, then sends requests in a closed
loop with one client for `--seconds`: each request is one batch of u8 images
through `TorchFwd.run_fwd`, and ends when its logits are on the host. With
`--trace 1` a stretch of further requests runs under the profiler
(`trace.py`). Once the program is freed, the plain reference decides
`correct` over every request's logits (`check.py`). The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones, each read by
`metrics/<name>.py`), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number with its limit; the same numbers end standard
error.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), without the program, or when `jax`, `jaxlib`, `flax`
or `boda_tpu` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import random
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "boda_tpu")


@dataclass
class Run:
    """One run's record, which the metric readers read."""
    cell: object
    net: object
    batch: int
    device_kind: str
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies: list = field(default_factory=list)
    answered: int = 0
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace: object = None
    checks: dict = field(default_factory=dict)
    correct: bool = False
    phases: dict = field(default_factory=dict)
    # what the comparison read, kept for benchmark/limits.py: the pool
    # (host u8 batches), the calibrated scales, each conv's declared
    # precision, every answer [(pool index, logits)] and the reference's
    # logits of each pool batch answered
    pool: list = field(default_factory=list)
    scales: dict = field(default_factory=dict)
    sites: dict = field(default_factory=dict)
    answers: list = field(default_factory=list)
    refs: dict = field(default_factory=dict)


def request_order(seed: int, pool: int) -> list:
    """The order of the pool's batches: one permutation drawn from the
    seed, which the requests repeat, so no request repeats its
    predecessor's input."""
    perm = list(range(pool))
    random.Random(int(seed)).shuffle(perm)
    return perm


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             overrides: dict | None = None, wrap=None) -> Run:
    """One run of `cell` on `device`. overrides ({'batch', 'input_hw',
    'pool', 'trace_requests', 'min_requests'}) shrink the cell for a
    rehearsal on the CPU, whose window then also runs until it has sent
    min_requests;
    wrap(request) -> request puts a fault under the timed path (the tests'
    mutations)."""
    import torch

    from . import check, roofline
    from .program import Program
    from .reference import net_of
    from .reference.graph import fp32_exact, run_reference
    from .weights import make_images, make_weights, preprocess

    t0 = time.perf_counter() if t0 is None else t0
    ov = overrides or {}
    cfg, tr = dict(cell.config), cell.traffic
    if "input_hw" in ov:
        cfg["input_chw"] = [cfg["input_chw"][0], *ov["input_hw"]]
    batch = int(ov.get("batch", tr["batch"]))
    n_pool = int(ov.get("pool", tr["pool"]))
    n_trace = int(ov.get("trace_requests", tr["trace_requests"]))
    n_min = int(ov.get("min_requests", 1))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    net = net_of(cfg)
    hw = tuple(cfg["input_chw"][1:])
    sites = roofline.site_precisions(net, tr["precision"])
    int8_sites = sorted(n for n, p in sites.items() if p == "int8")
    run = Run(cell, net, batch, torch.cuda.get_device_name(dev)
              if on_card else "cpu")

    run.phases["start"] = time.perf_counter() - t0

    # ---- set-up: weights, the request pool, the static scales ----
    w = make_weights(net.weight_shapes(), cfg["weights"], seed, dev)
    host_w = {n: t.cpu().numpy() for n, t in w.items()}
    pool = [make_images(batch, hw, tr["image"], seed, f"pool/{k}", dev)
            .cpu().numpy() for k in range(n_pool)]
    scales = {}
    if int8_sites:
        x = preprocess(make_images(tr["int8"]["calib_batch"], hw, tr["image"],
                                   seed, tr["int8"]["calib_stream"], dev),
                       tr["preproc"])
        tapped: dict = {}
        with torch.no_grad(), fp32_exact():
            net.forward(x, w, taps=set(int8_sites), tapped=tapped)
        scales = {n: float(tapped[n]) for n in int8_sites}
        del x
    del w
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    run.phases["inputs"] = time.perf_counter() - t0
    # the engine reads the static scales at init, from a file in the
    # program's format (tune/presets.save_act_scales): one lexp a line
    with tempfile.TemporaryDirectory() as tmp:
        scales_fn = ""
        if scales:
            scales_fn = str(Path(tmp) / "act_scales.lexp")
            with open(scales_fn, "w") as f:
                for n in int8_sites:
                    f.write(f"(tag={n},act_scale={scales[n]!r})\n")
        prog = Program(cfg, tr, host_w, batch, device, scales_fn)
    run.phases["engine"] = time.perf_counter() - t0
    request = prog.request if wrap is None else wrap(prog.request)
    for i in range(int(tr["warmup_requests"])):
        request(pool[i % n_pool])
    if on_card:
        torch.cuda.synchronize(dev)
    run.setup_s = run.phases["warm"] = time.perf_counter() - t0

    # ---- the window: a closed loop, one client ----
    order = request_order(seed, n_pool)
    answers = []
    start = time.perf_counter()
    end = start
    i = 0
    while end - start < seconds or i < n_min:
        k = order[i % n_pool]
        i += 1
        t = time.perf_counter()
        try:
            out = request(pool[k])
        except RuntimeError as e:  # the program's errors (RtErr, CUDA)
            print(f"request {i} failed: {e}", file=sys.stderr)
            out = None
        end = time.perf_counter()
        run.latencies.append(end - t)
        answers.append((k, out))
    run.window_s = end - start
    run.attempted = len(answers)
    run.answered = sum(out is not None for _, out in answers)
    if on_card:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))

    # ---- the traced stretch ----
    if trace:
        from .trace import traced
        seq = iter(range(i, i + n_trace + 1))

        def one():
            k = order[next(seq) % n_pool]
            answers.append((k, request(pool[k])))
        run.trace = traced(one, n_trace, on_card)
        run.attempted = len(answers)
    run.failed = sum(out is None for _, out in answers)
    run.pool, run.scales, run.sites, run.answers = pool, scales, sites, \
        answers
    del prog, request
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- the reference, once the program is freed ----
    w = make_weights(net.weight_shapes(), cfg["weights"], seed, dev)
    quant = {n: (8, scales[n]) for n in int8_sites}
    for k in sorted({k for k, _ in answers}):
        x = preprocess(torch.from_numpy(pool[k]).to(dev), tr["preproc"])
        run.refs[k] = run_reference(net, x, w, quant,
                                    tr["precision"]).numpy()
    run.checks = {
        "logit_err": (check.worst_err(answers, run.refs),
                      float(cell.limits["logit_err"])),
        "mean_logit_err": (check.worst_mean_err(answers, run.refs),
                           float(cell.limits["mean_logit_err"])),
        "failed_requests": (run.failed, 0)}
    run.correct = bool(run.attempted > 0 and all(
        v <= lim for v, lim in run.checks.values()))
    return run


def metric_lines(run: Run, trace: bool) -> dict:
    from .spec import metric_reader
    out = {}
    for m in (run.cell.per_layer if trace else run.cell.end_to_end):
        v = metric_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else "power limit not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def result(run: Run, trace: bool, count: int) -> dict:
    res = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metric_lines(run, trace),
           "device": {"platform": "gpu" if run.device_kind != "cpu"
                      else "cpu", "kind": run.device_kind, "count": count,
                      "memory_peak_bytes": run.memory_peak_bytes}}
    if trace and run.trace is not None:
        res["device"]["busy_s"] = run.trace.busy_s()
        res["device"]["window_s"] = run.trace.window_s
        res["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    # a missing or non-finite answer reads inf, which JSON has no number
    # for: it is written as null (and the run is not correct)
    res["checks"] = {k: {"value": v if math.isfinite(v) else None,
                         "limit": lim} for k, (v, lim) in run.checks.items()}
    return res


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from .spec import SpecError, load_cell
    try:
        cell = load_cell(a.workload)
    except (SpecError, OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card (torch.cuda.is_available() is false); "
              "nothing measured", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {a.workload} needs {cell.chips} card(s), "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    from .program import ProgramMissing
    try:
        run = run_cell(cell, a.seed, a.seconds, bool(a.trace), t0=t0)
    except ProgramMissing as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)} after the "
              f"window; no result", file=sys.stderr)
        return 5
    print("set-up phases (s from the start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.phases.items()), file=sys.stderr)
    if a.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
    res = result(run, bool(a.trace), cell.chips)
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
