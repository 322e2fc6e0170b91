"""Count torch.profiler traces that hold no device event, in one process on
the card, and show where the missing events went.

Each round runs cnet_xprof (ResNet-50 b32 under (), as chip_smoke.py's
`tune` phase does), then reads one forward's device busy time with
chip_smoke._device_busy_ms twice: with the margin that tune/xprof.
traced_steps keeps by default, and with margin 0, the reading before that
margin. A read is empty where the trace holds no device event, short
where it holds less than SHORT of the median read's busy time.
--xprof-margin-s 0 sets the margin's default to 0 in the whole process
(cnet_xprof and every busy read of the smoke's phases), as before it.
--age-phases runs chip_smoke.py's phases of that list in this process
first, as the smoke does before its `tune` phase reads (a phase's check
that fails, a busy read's among them, is counted and the next phase
runs). Each
round then takes a probe trace of host and card activity around one
forward, with a second of idle time on both sides, and pairs each kernel
with its launch by correlation id: the probe prints how many launches
have no kernel, and the earliest kernel's start and the latest kernel's
end against the host's clock around the forward (time.time_ns before the
first launch and after the synchronize), in ms: a device event before
0 or after the synchronize lies where the host's clock says the card was
not running it.

Run from the repo root on a machine with a card:

    python3 scripts/profiler_empty_traces.py [--rounds N]
        [--xprof-margin-s S] [--age-phases env,build,kernels,...]

It prints one line per round and, last, one JSON object with the counts
and the card's name and power limit (nvidia-smi).
"""

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
PROBE_IDLE_S = 1.0
SHORT = 0.9


def _probe(fn) -> dict:
    """One forward under a host+card trace with PROBE_IDLE_S of idle time
    on both sides: launches, kernels, launches without a kernel, and the
    device events' extent against the host's clock (ms from the host's
    time before the forward; its end is the host's time after the
    synchronize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROBE_IDLE_S)
        h0 = time.time_ns()
        fn()
        torch.cuda.synchronize()
        h1 = time.time_ns()
        time.sleep(PROBE_IDLE_S)
    evs = prof.profiler.kineto_results.events()
    launches = {e.correlation_id(): e for e in evs
                if e.name() in LAUNCH_CALLS}
    kernels = [e for e in evs if e.device_type() == torch.autograd.DeviceType
               .CUDA and e.correlation_id() in launches]
    dev = [e for e in evs if e.device_type() == torch.autograd.DeviceType
           .CUDA]
    seen = {e.correlation_id() for e in kernels}
    lost = sorted(launches[c].start_ns() for c in launches if c not in seen)
    out = {"launches": len(launches), "kernels": len(kernels),
           "device_events": len(dev), "lost": len(lost),
           "host_ms": (h1 - h0) / 1e6}
    if dev:
        out["dev_first_ms"] = (min(e.start_ns() for e in dev) - h0) / 1e6
        out["dev_last_ms"] = (max(e.end_ns() for e in dev) - h0) / 1e6
    if lost:
        first_launch = min(e.start_ns() for e in launches.values())
        out["lost_from_ms"] = (lost[0] - first_launch) / 1e6
        out["lost_to_ms"] = (lost[-1] - first_launch) / 1e6
    return out


def _read(fn, margin_s: float) -> float:
    """Busy ms of chip_smoke._device_busy_ms at margin_s; 0.0 where the
    trace held no device event (its check failed)."""
    import chip_smoke
    try:
        return chip_smoke._device_busy_ms(fn, margin_s=margin_s)[0]
    except chip_smoke.SmokeFailure:
        return 0.0


def _age(chip_smoke, phases: list, smi: str) -> dict:
    """Run chip_smoke.py's `phases` in this process, their output kept
    out of ours; {phases, seconds, failures: [(phase, message)]}."""
    ctx = {"smi": smi, "only_kernels": []}
    failures = []
    t0 = time.perf_counter()
    for name in phases:
        note = ""
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                chip_smoke.PHASES[name](ctx)
        except chip_smoke.SmokeFailure as e:
            failures.append((name, str(e)[:200]))
            note = f"; failed: {failures[-1][1]}"
        print(f"aged: phase {name} done at {time.perf_counter() - t0:.1f} "
              f"s{note}", flush=True)
    return {"phases": phases, "seconds": time.perf_counter() - t0,
            "failures": failures}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--xprof-margin-s", type=float, default=None,
                    help="the process's margin (default: PROFILE_MARGIN_S)")
    ap.add_argument("--age-phases", default="",
                    help="chip_smoke.py phases to run first, comma-separated")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_empty_traces: no card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import boda_tpu_torch.modes  # noqa: F401
    import chip_smoke
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    from boda_tpu_torch.tune import xprof
    margin = xprof.PROFILE_MARGIN_S
    if opts.xprof_margin_s is not None:
        xprof.PROFILE_MARGIN_S = opts.xprof_margin_s
    smi = chip_smoke.smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    aged = _age(chip_smoke, [a for a in opts.age_phases.split(",") if a],
                smi)
    margins = {"margin": margin, "no_margin": 0.0}
    reads = {k: [] for k in margins}
    probes = []
    t_start = time.perf_counter()
    for r in range(opts.rounds):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            hm = create_and_run_has_main(
                "(mode=cnet_xprof,model=resnet-50,batch=32,steps=5,top_k=8,"
                "conv_fwd=(engine=torch,op_tune=()))", {})
        eng = hm.eng
        data = eng.pipe.data_img_node_names[0]
        x = torch.randn(tuple(eng.pipe.get_data_img_dims().shape),
                        device=eng.dev) * 0.1

        def fwd():
            with torch.inference_mode():
                eng.fwd({data: x}, eng.weights)
        order = list(margins) if r % 2 == 0 else list(margins)[::-1]
        row = {}
        for k in order:
            row[k] = _read(fwd, margins[k])
            reads[k].append(row[k])
            if row[k] <= 0:
                print(f"round {r}: {k} read empty; probe right after it "
                      f"{json.dumps(_probe(fwd))}", flush=True)
        probe = _probe(fwd)
        probes.append(probe)
        print(f"round {r} t={time.perf_counter() - t_start:.1f}s "
              f"xprof {hm.total_ns / 1e6 / 5:.3f} ms/step; "
              + "; ".join(f"{k} busy {b:.3f} ms" for k, b in row.items())
              + f"; probe {json.dumps(probe)}", flush=True)
        del hm, eng
        torch.cuda.empty_cache()
    res = {"smi": smi, "rounds": opts.rounds,
           "xprof_margin_s": xprof.PROFILE_MARGIN_S, "aged": aged,
           "seconds": time.perf_counter() - t_start,
           "probe_lost_rounds": sum(1 for p in probes if p["lost"]),
           "probe_dev_first_ms_min": min(p.get("dev_first_ms", 0.0)
                                         for p in probes),
           "probe_dev_last_over_host_ms_max": max(
               p.get("dev_last_ms", 0.0) - p["host_ms"] for p in probes)}
    median = sorted(b for rs in reads.values() for b in rs)[
        len(margins) * opts.rounds // 2]
    for k, rs in reads.items():
        res[k] = {"margin_s": margins[k],
                  "empty": sum(1 for b in rs if b <= 0),
                  "short": sum(1 for b in rs if 0 < b < SHORT * median),
                  "busy_ms_min": min(rs), "busy_ms_max": max(rs)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
