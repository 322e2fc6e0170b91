"""The readings that a cell's limit is set from, on the card, at the cell's
own size.

    python -m benchmark.limits --workload <cell> --seeds 1,2,3 --seconds 3

For each seed, in one process: one run of the cell (`run.run_cell`, a short
window at the cell's load), then, besides the program's numbers, the
control's (the plain reference one precision below the declared one at every
site: bf16 -> int8, int8 -> int4), where the cell mixes precisions a second
control's that lowers only the sites above int8 (bf16 -> int8), and the
faults' (the previous request's answer returned again, half of the batch
answered with the other half's rows, one answer's largest and smallest logits
swapped), each against the same reference at the declared precision. One
JSON line per seed on standard output, each reading the pair [logit_err,
mean_logit_err] (`check.py`). The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys

# the bits of the control's integer codes at a site of each declared
# precision: the nearest lower precision
LOWER_BITS = {"bf16": 8, "int8": 4}


def control_quant(sites: dict, scales: dict) -> dict:
    """The control's quantized convs: each site one precision below the
    declared one (bf16 -> int8 at its input's own absmax, int8 -> int4 at
    the calibrated absmax)."""
    return {name: (LOWER_BITS[p], scales.get(name))
            for name, p in sites.items()}


def readings(run, seed: int, device: str = "cuda") -> dict:
    """The numbers that set the limit besides the program's own, from the
    record of a run of `seed` on `device`: the controls over the pool
    batches the run answered, and the faults the cell can have, made from
    the program's own answers; each a pair [logit_err, mean_logit_err]."""
    import numpy as np
    import torch

    from .check import worst_err, worst_mean_err
    from .reference.graph import run_reference
    from .weights import make_weights, preprocess

    cfg, tr = run.cell.config, run.cell.traffic
    net, refs, answers = run.net, run.refs, run.answers
    dev = torch.device(device)
    w = make_weights(net.weight_shapes(), cfg["weights"], seed, dev)

    def control(quant):
        out = []
        for k in refs:
            x = preprocess(torch.from_numpy(run.pool[k]).to(dev),
                           tr["preproc"])
            out.append((k, run_reference(net, x, w, quant,
                                         tr["precision"]).numpy()))
        return both(out)

    def both(answers):
        return [worst_err(answers, refs), worst_mean_err(answers, refs)]

    got = {"control": control(control_quant(run.sites, run.scales))}
    if "int8" in run.sites.values() and len(set(run.sites.values())) > 1:
        q = {n: (8, run.scales.get(n)) for n in run.sites}
        got["control_above_int8"] = control(q)
    stale = [(k, answers[i - 1][1]) for i, (k, _) in enumerate(answers)
             if i and answers[i - 1][0] != k]
    half = []
    for k, out in answers[:8]:
        o = out.copy()
        h = len(o) // 2
        o[h:2 * h] = o[:h]
        half.append((k, o))
    k, o = answers[len(answers) // 2]
    o = o.copy()
    a, b = int(np.argmax(o[0])), int(np.argmin(o[0]))
    o[0, a], o[0, b] = o[0, b], o[0, a]
    return {**got, "stale_answer": both(stale), "half_batch": both(half),
            "altered_answer": both([(k, o)])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args(argv)
    import torch

    from .run import run_cell
    from .spec import load_cell
    if not torch.cuda.is_available():
        print("limits: no CUDA card; nothing read", file=sys.stderr)
        return 3
    cell = load_cell(a.workload)
    for s in a.seeds.split(","):
        r = run_cell(cell, int(s), a.seconds, False)
        print(json.dumps({"workload": a.workload, "seed": int(s),
                          "program": [r.checks["logit_err"][0],
                                      r.checks["mean_logit_err"][0]],
                          **readings(r, int(s)), "attempted": r.attempted,
                          "failed": r.failed,
                          "imgs_per_s": r.answered * r.batch / r.window_s,
                          "setup_s": r.setup_s}), flush=True)
        del r
    return 0


if __name__ == "__main__":
    sys.exit(main())
