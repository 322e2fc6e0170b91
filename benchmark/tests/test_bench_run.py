"""The command as a whole: it refuses without a card and without the
program, and a rehearsal of a run on the CPU, the card's look skipped,
prints the contract's last line and loads neither JAX nor the JAX
package."""

import json
import shutil
import subprocess
import sys

from benchmark import spec

from .small import SMALL

REHEARSE = """
import json, sys
from benchmark import run as R
from benchmark.tests.small import small_cell
cell = small_cell({w!r})
r = R.run_cell(cell, 2**40 + 3, 0.5, {trace}, device="cpu", overrides={ov!r})
print(json.dumps({{"result": R.result(r, {trace}, 1),
                   "forbidden": R.forbidden_modules(),
                   "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def rehearse(w, trace, cwd=spec.ROOT):
    code = REHEARSE.format(w=w, trace=trace, ov=dict(SMALL, trace_requests=2))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=cwd, timeout=600)


def test_refuses_without_a_card():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "googlenet-bf16-b128", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=spec.ROOT, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA card" in p.stderr


def test_refuses_an_unknown_workload():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "nope", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=spec.ROOT,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_rehearsal_last_line_and_imports():
    p = rehearse("googlenet-bf16-b128", True)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 3
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s", "window_s"}
    assert res["checks"]["logit_err"]["value"] <= \
        res["checks"]["logit_err"]["limit"]
    # no device metric from a CPU run
    assert res["metrics"] == {}
    assert out["forbidden"] == []
    assert "boda_tpu_torch" in out["tops"]
    assert not {"jax", "jaxlib", "flax", "boda_tpu"} & set(out["tops"])


def test_end_to_end_metrics_of_a_rehearsal():
    p = rehearse("resnet50-bf16-b128", False)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])["result"]
    assert set(res["metrics"]) == {"imgs_per_s", "req_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"


def test_no_result_without_the_program(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = rehearse("googlenet-bf16-b128", False, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "cannot be imported" in p.stderr
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "googlenet-bf16-b128", "--seed", "1", "--seconds",
                        "1"], capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""
