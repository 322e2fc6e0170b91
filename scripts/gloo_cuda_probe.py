"""What torch.distributed's gloo backend does with CUDA tensors.

Runs all_gather, all_reduce and send/recv of CUDA tensors, each in a pair
of ranks of its own on the card (a refusal may abort the process), beside
send/recv of CPU tensors, and prints one JSON object: each call's outcome,
"ok" or its exit codes and last error line. The mesh's collectives between
processes (boda_tpu_torch/parallel/mesh.py) copy to the host explicitly
whatever this finds. Run from the repo root on a machine with a card:

    python3 scripts/gloo_cuda_probe.py

It exits 1 if the CPU pair fails (gloo itself does not work here).
"""

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
RANK = r"""
import sys
import torch
import torch.distributed as dist
from boda_tpu_torch.parallel.multihost import init_multihost, \
    shutdown_multihost
coord, rank, op = sys.argv[1], int(sys.argv[2]), sys.argv[3]
init_multihost(coord, 2, rank)
dev = "cpu" if op.endswith("_cpu") else "cuda"
x = torch.full((4,), rank + 1.0, device=dev)
if op.startswith("all_gather"):
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    assert [p.tolist() for p in parts] == [[1.0] * 4, [2.0] * 4]
elif op.startswith("all_reduce"):
    dist.all_reduce(x)
    assert x.tolist() == [3.0] * 4
else:
    if rank == 0:
        dist.send(torch.full((4,), 7.0, device=dev), 1)
    else:
        dist.recv(x, 0)
        assert x.tolist() == [7.0] * 4
torch.cuda.synchronize()
print("PROBE_OK", op)
shutdown_multihost()
"""
OPS = ("all_gather_cuda", "all_reduce_cuda", "send_recv_cuda",
       "send_recv_cpu")


def run_pair(op: str) -> str:
    """Both ranks of one call at once, each killed after TIMEOUT_S."""
    sys.path.insert(0, str(ROOT))
    from boda_tpu_torch.parallel.multihost import free_port
    coord = f"localhost:{free_port()}"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", RANK, coord, str(r), op],
                              cwd=ROOT, env=env, stdout=lg,
                              stderr=subprocess.STDOUT, text=True)
             for r, lg in enumerate(logs)]
    try:
        rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for lg in logs:
        lg.seek(0)
        outs.append(lg.read())
        lg.close()
    if rcs == [0, 0] and all(f"PROBE_OK {op}" in o for o in outs):
        return "ok"
    errs = [ln.strip() for o in outs for ln in o.splitlines()
            if re.search(r"Error|Exception|what\(\)", ln)
            and "Traceback" not in ln]
    return f"exit {rcs}: " + (errs[-1][:160] if errs else "no error line")


def main() -> int:
    import torch
    res = {op: run_pair(op) for op in OPS}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"torch": torch.__version__, "card": smi,
                      "gloo": res}))
    return 0 if res["send_recv_cpu"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
