"""cnet_xprof: per-kernel device-event profile of a whole-net forward.

The port of boda_tpu/tune/xprof.py. Reference parity: per-call device event
timing, `rtc_compute_t::get_dur` over CUDA events (reference
`src/nvrtc_util.cc:296`, `src/rtc_prof.cc:37`) feeding boda's per-kernel
tables. Where the JAX mode reads an xplane trace of `jax.profiler`, this
one runs `steps` forwards of the program cnet_bench times under
torch.profiler (CUPTI's kernel activity on the card) and aggregates the
device events per kernel name (aggregate_profile), then by kind
(rollup_kinds: the name without its template arguments, parameter list,
anonymous namespace or instance suffix). The hand kernels appear under
their `__global__` names (boda_tpu_torch/csrc/*.cu), the library's under
theirs.

On a card, a trace without device events raises: a table of the host's
events would hide the card. On device=cpu the table holds the host's
events (each op's self time), as the JAX mode does on the CPU.
"""

from __future__ import annotations

import re
from pathlib import Path

from ..apps.cnet_bench import CnetBench
from ..core.config import Attr
from ..core.error import RtErr
from ..core.has_main import mode

_TRAIL_ID = re.compile(r"\.\d+$")
_TEMPLATE_ARGS = re.compile(r"<[^<>]*>")


def _strip_params(k: str) -> str:
    """k without its trailing parameter list, which may nest parentheses
    (a lambda's, '{lambda(int)#1}')."""
    depth = 0
    for i in range(len(k) - 1, 0, -1):
        if k[i] == ")":
            depth += 1
        elif k[i] == "(":
            depth -= 1
            if depth == 0:
                return k[:i].rstrip()
    return k


def kernel_kind(name: str) -> str:
    """A kernel's kind: its name without template arguments, parameter
    list, return type, anonymous namespace or trailing instance id, e.g.
    'void matmul_ffma<float>(float const*, ...)' -> 'matmul_ffma'."""
    k = name.replace("(anonymous namespace)::", "")
    prev = None
    while prev != k:  # innermost template arguments first
        prev, k = k, _TEMPLATE_ARGS.sub("", k)
    if k.endswith(")"):
        k = _strip_params(k)
    if k.startswith("void "):
        k = k[5:]
    return _TRAIL_ID.sub("", k.strip())


def aggregate_profile(prof, device: bool) -> list[dict]:
    """Rows of a torch.profiler run: [{op, kind, count, total_ns}] summed
    over calls, heaviest first. device: the card's events (each kernel's
    self device time), else the host's (each op's self time). The
    profiler's own step annotations (ProfilerStep*), which span whole
    steps, are not rows."""
    rows = []
    for e in prof.key_averages():
        us = e.self_device_time_total if device else e.self_cpu_time_total
        if us > 0 and not e.key.startswith("ProfilerStep"):
            rows.append({"op": e.key, "kind": kernel_kind(e.key),
                         "count": e.count, "total_ns": us * 1e3})
    return sorted(rows, key=lambda r: -r["total_ns"])


def rollup_kinds(rows):
    """Aggregate per-op rows by kind."""
    by_kind: dict[str, dict] = {}
    for r in rows:
        k = by_kind.setdefault(r["kind"],
                               {"kind": r["kind"], "count": 0,
                                "total_ns": 0.0, "n_ops": 0})
        k["count"] += r["count"]
        k["total_ns"] += r["total_ns"]
        k["n_ops"] += 1
    return sorted(by_kind.values(), key=lambda r: -r["total_ns"])


@mode("cnet_xprof", help="per-kernel device-event profile (torch.profiler)")
class CnetXprof(CnetBench):
    """Trace `steps` forwards of the fused net under torch.profiler (after
    one forward outside the trace, which builds the kernels, and one inside
    it as the profiler's warm-up) and report per-kernel device time. Inherits every net/tune attr from
    cnet_bench (its _build_engine) so the profiled program is the benched
    one. `iters`/`reps` are unused here (the trace replaces the timing).

    After main: `rows` and `kinds` (aggregate_profile, rollup_kinds),
    `total_ns`, `eng`."""

    steps = Attr(int, default=10, help="forwards to run inside the trace")
    bwd = Attr(bool, default=False,
               help="profile the TRAINING step instead: grad of a "
                    "logits-sum loss w.r.t. all weights (the same "
                    "construction as cnet_stage_probe --bwd) — decomposes "
                    "the whole-net backward per kernel")
    top_k = Attr(int, default=25, help="rows in the per-op table")
    dump_fn = Attr(str, default="",
                   help="also write every row (full kernel name) to this "
                        "file")
    trace_dir = Attr(str, default="",
                     help="keep the trace here as a Chrome trace "
                          "(trace.json); default: not written")

    def main(self):
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        from ..apps.train import train_forward, train_top
        from ..ops.cuda.util import full_fp32
        from ..ops.mxu_grad import check_trainable

        pipe, eng, x, data, top = self._build_engine()
        d = pipe.get_data_img_dims()
        on_card = eng.dev.type == "cuda"

        if self.bwd:
            check_trainable(eng.plan.steps, "cnet_xprof")
            # backprop from the pre-softmax logits, exactly as
            # cnet_stage_probe --bwd / cnet_train do (the softmax VJP of an
            # all-ones cotangent is ~0)
            ltop, _ = train_top(pipe, eng.plan)
            bfwd = train_forward(eng.plan, eng.dev, ltop)
            wg = {k: v.detach().requires_grad_(v.is_floating_point())
                  for k, v in eng.weights.items()}
            leaves = [v for v in wg.values() if v.requires_grad]

            def step():
                loss = bfwd({data: x}, wg)[ltop].float().sum()
                return torch.autograd.grad(loss, leaves)
        else:
            def step():
                with torch.inference_mode():
                    return eng.fwd({data: x}, eng.weights)[top]

        def sync():
            if on_card:
                torch.cuda.synchronize(eng.dev)

        with full_fp32():
            t0 = time.perf_counter()
            step()  # kernel builds and first-call work outside the trace
            sync()
            compile_s = time.perf_counter() - t0
            act = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
            # one more step as the profiler's warm-up, whose events it drops:
            # CUPTI can miss the first kernels of a trace it has just
            # started (2 of 200 launches seen missing on an H100)
            with profile(activities=[act], schedule=schedule(
                    wait=0, warmup=1, active=self.steps, repeat=1)) as prof:
                for _ in range(1 + self.steps):
                    step()
                    sync()
                    prof.step()

        rows = self.rows = aggregate_profile(prof, on_card)
        name = self.model or self.ptt_fn
        if on_card and not rows:
            raise RtErr(f"cnet_xprof {name}: torch.profiler recorded no "
                        f"device events on {eng.dev}")
        self.kinds = rollup_kinds(rows)
        if self.trace_dir:
            tdir = Path(self.trace_dir)
            tdir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(tdir / "trace.json"))
        if self.dump_fn:
            p = self.out_path(self.dump_fn)
            with open(p, "w") as f:
                for r in rows:
                    f.write(f"{r['total_ns'] / 1e6 / self.steps:9.4f} ms "
                            f"x{r['count']:<4d} {r['op']}\n")
            print(f"wrote {len(rows)} rows to {p}")

        total_ns = self.total_ns = sum(r["total_ns"] for r in rows)
        kind = torch.cuda.get_device_name(eng.dev) if on_card else "cpu"
        print(f"cnet_xprof {name} b{d['img']} steps={self.steps} "
              f"device={kind.replace(' ', '_')} compile_s={compile_s:.1f} "
              f"planes={[act.name]}")
        print(f"device total: {total_ns / 1e6 / self.steps:.3f} ms/step "
              f"over {len(rows)} {'kernels' if on_card else 'ops'}")
        print(f"{'kernel':44s} {'calls':>6s} {'ms/step':>9s} {'%':>6s}")
        for r in rows[:self.top_k]:
            print(f"{r['op'][:44]:44s} {r['count']:6d} "
                  f"{r['total_ns'] / 1e6 / self.steps:9.3f} "
                  f"{100 * r['total_ns'] / max(total_ns, 1):6.2f}")
        print("-- by kind --")
        for r in self.kinds[:self.top_k]:
            print(f"{r['kind'][:44]:44s} {r['count']:6d} "
                  f"{r['total_ns'] / 1e6 / self.steps:9.3f} "
                  f"{100 * r['total_ns'] / max(total_ns, 1):6.2f}")
