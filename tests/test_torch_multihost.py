"""The port's mh_test (boda_tpu_torch/parallel/multihost.py) on the CPU:
the JAX package's command lines (tests/test_multichip.py) through `python
-m boda_tpu_torch`, two gloo ranks of 2 CPU slots each, held to the JAX
package's unsharded forward (digest mrd 1e-5) and training step (the loss
within 1e-5, the updated weight's digest within mrd 1e-4; the port trains
under the f32 vendor tune, the JAX package under `()`), plus a mesh whose
mp groups span the two ranks, a mesh of one, and the mode's refusals.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import boda_tpu_torch.modes  # noqa: F401  (register the port's modes)
from boda_tpu.core.digest import Digest
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.has_main import create_and_run_has_main

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240


def _mh_test(*args) -> subprocess.CompletedProcess:
    """`python -m boda_tpu_torch mh_test args` from the repo root, retried
    where the coordinator's port was taken between free_port and its
    bind."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("BODA_TORCH_DEVICE", "BODA_TORCH_LOCAL_DEVICES")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"  # two ranks share the machine's cores
    for _attempt in range(3):
        r = subprocess.run([sys.executable, "-m", "boda_tpu_torch", "mh_test",
                            *args], capture_output=True, text=True,
                           timeout=TIMEOUT_S, env=env, cwd=ROOT)
        text = r.stdout + r.stderr
        if "EADDRINUSE" not in text and "address already in use" not in text:
            break
    return r


def _digest(r) -> tuple[str, Digest]:
    line = next(ln for ln in r.stdout.splitlines() if "digest (" in ln)
    return line, Digest.from_lexp(line.split("digest ", 1)[1])


def _jax_mini(batch: int):
    import __graft_entry__ as ge
    pipe, plan, fwd, weights = ge._fused_for("mini", batch=batch, ysz=32,
                                             xsz=32)
    x = np.random.RandomState(0).randn(
        *pipe.get_data_img_dims().shape).astype(np.float32) * 0.1
    return plan, fwd, weights, x


def _jax_forward_digest(batch: int):
    import jax

    from boda_tpu.core.digest import nda_digest
    plan, fwd, weights, x = _jax_mini(batch)
    return nda_digest(np.asarray(
        jax.jit(lambda w, xv: fwd({"data": xv}, w)["prob"])(weights, x)))


# the JAX test's mesh (two ranks of 2 slots: dp=4), and one whose mp groups
# span the two ranks (one slot each, mp=2)
LAYOUTS = {"dp4": ("--local-devices=2",),
           "mp-across-ranks": ("--local-devices=1", "--mp=2")}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_two_process_forward_matches_jax(layout):
    r = _mh_test("--num-processes=2", "--model=mini", "--batch=8",
                 *LAYOUTS[layout])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "mh_test PASSED ranks=2" in r.stdout, r.stdout
    line, got = _digest(r)
    n = 2 if layout == "mp-across-ranks" else 4
    assert f"global_devices={n}" in line
    assert _jax_forward_digest(8).comp(got, mrd_toler=1e-5) is None


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_two_process_train_step_matches_jax(layout):
    """One sharded training step over two ranks: every rank's updated
    weight digest equal (mh_test asserts it), and the loss and weight
    within f32 tolerance of the JAX package's unsharded step."""
    import jax

    from boda_tpu.apps.train import build_train_step
    r = _mh_test("--num-processes=2", "--model=mini", "--batch=8",
                 "--train=1", *LAYOUTS[layout])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "mh_test PASSED ranks=2" in r.stdout, r.stdout
    line, got = _digest(r)
    loss = float(line.split("loss=", 1)[1].split()[0])
    wk = line.split("loss=", 1)[1].split()[1]
    plan, fwd, weights, x = _jax_mini(8)
    top = plan.output_nodes[-1]
    labels = np.random.RandomState(1).randint(
        0, plan.node_dims[top].shape[1], size=(8,)).astype(np.int32)
    step = build_train_step(fwd, "data", top, lr=0.01)
    jl, jw = jax.jit(lambda w, xv, lb: step(w, {}, xv, lb)[:2])(
        weights, x, labels)
    from boda_tpu.core.digest import nda_digest
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl)) + 1e-6
    assert nda_digest(np.asarray(jw[wk])).comp(got, mrd_toler=1e-4) is None


def test_a_mesh_of_one_process():
    r = _mh_test("--num-processes=1", "--local-devices=1", "--model=mini",
                 "--batch=2")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "mh_test PASSED ranks=1" in r.stdout
    line, got = _digest(r)
    assert "global_devices=1" in line
    assert _jax_forward_digest(2).comp(got, mrd_toler=1e-5) is None


@pytest.mark.parametrize("spec,err", [
    ("(mode=mh_test,num_processes=2,process_id=5)", "out of range"),
    ("(mode=mh_test,num_processes=2)", "needs --local-devices"),
    ("(mode=mh_test,num_processes=0)", "num_processes must be >= 1")],
    ids=["err_mh_bad_rank", "err_mh_spawn_real_dev", "no_processes"])
def test_refusals_keep_the_jax_messages(spec, err):
    from boda_tpu.core.error import RtErr as JRtErr
    from boda_tpu.core.has_main import create_and_run_has_main as jrun
    with pytest.raises(RtErr, match=err) as got:
        create_and_run_has_main(spec, {})
    with pytest.raises(JRtErr, match=err) as want:
        jrun(spec, {})
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]
