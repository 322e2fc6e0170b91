"""Times the engine's fused forward (engine=torch, fuse=1) of one or more
checkouts, in one process, in turns.

Each checkout's boda_tpu_torch is imported under a module name of its own,
so a parent's `git archive` and a change run side by side on one card.
ResNet-50 at batch 32, 224x224, random weights from the zoo's seed, under
the f32 hand-kernel tune (), the bf16 NHWC tune and the vendor headline
tune: per tune, each checkout's TorchFwd.fwd is warmed once, then timed in
windows of 30 back-to-back calls between two CUDA events, the checkouts
taking turns A B B A, A B B A, ... for 6 rounds, so that drift in the
host's load falls on every checkout alike. Prints one JSON line (the
card's name and power limit; per tune and checkout, the median window
and every window, ms per call) and appends it to --out:

    python3 scripts/fused_fwd_times.py --roots PARENT_DIR . --out t.jsonl
"""

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

TUNES = {"f32": "()", "bf16_nhwc": "(prec=bf16,layout=nhwc)",
         "headline": "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,"
                     "fuse_siblings=1)"}
BATCH = 32
ITERS = 30
ROUNDS = 6


def load_package(root: Path, name: str):
    """root/boda_tpu_torch imported as module `name` (its imports of itself
    are relative, so they stay within the checkout)."""
    pkg = root / "boda_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def window_ms(fn) -> float:
    """ms per call over ITERS back-to-back calls of fn, on the card."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(ITERS):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / ITERS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", required=True,
                    help="the checkouts whose boda_tpu_torch is timed")
    ap.add_argument("--out", default="", help="JSON lines file to append to")
    opts = ap.parse_args()
    import importlib
    import torch
    roots = [str(Path(r).resolve()) for r in opts.roots]
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    pkgs = [load_package(Path(r), f"ckpt{i}") for i, r in enumerate(roots)]
    zoo = [importlib.import_module(f"{p.__name__}.models.zoo") for p in pkgs]
    iface = [importlib.import_module(f"{p.__name__}.engine.iface")
             for p in pkgs]
    import numpy as np
    pipes = [z.build_model("resnet-50", batch=BATCH) for z in zoo]
    x = torch.from_numpy(np.random.RandomState(1).randn(
        *pipes[0].get_data_img_dims().shape).astype(np.float32)).cuda()
    order = list(range(len(roots)))
    res, wins = {}, {}
    for name, tune in TUNES.items():
        engs = []
        for f, pipe in zip(iface, pipes):
            e = f.make_engine(f"(engine=torch,op_tune={tune})")
            e.init(pipe)
            engs.append(e)
        calls = [lambda e=e: e.fwd({"data": x}, e.weights) for e in engs]
        w = {r: [] for r in roots}
        with torch.no_grad():
            for c in calls:  # builds the kernels, warms the libraries
                c()
            torch.cuda.synchronize()
            for _ in range(ROUNDS):
                for i in order + order[::-1]:
                    w[roots[i]].append(window_ms(calls[i]))
        res[name] = {r: statistics.median(v) for r, v in w.items()}
        wins[name] = w
        del engs, calls
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = json.dumps({"card": smi, "batch": BATCH, "hw": 224,
                       "iters": ITERS, "ms": res, "windows": wins})
    print(line)
    if opts.out:
        with open(opts.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
