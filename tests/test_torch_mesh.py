"""The port's mesh (boda_tpu_torch/parallel/mesh.py, engine/mesh_fwd.py,
the engine's mesh_dp/mesh_mp) and its dry run (parallel/dryrun.py) on the
CPU, against the JAX package on the conftest's 8 virtual devices.

The port's side gets 8 slots of the CPU (BODA_TORCH_DEVICE=cpu,
BODA_TORCH_LOCAL_DEVICES=8, restored after each test). Tolerances: the
engine's mesh forward against the JAX engine's, f32 rtol = atol = 2e-5 and
bf16 mrd 5e-3; the sharded ResNet-50 against one slot mrd < 1e-4 (the JAX
dry run's bound) and against the JAX package's output mrd 1e-4.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import boda_tpu_torch.modes  # noqa: F401  (the port's engines)
from boda_tpu.core import dims as jdims
from boda_tpu.engine import iface as jiface
from boda_tpu.engine.lower import lower_pipe as jlower_pipe
from boda_tpu.models import zoo as jzoo
from boda_tpu.parallel import mesh as jmesh
from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.engine.lower import lower_pipe
from boda_tpu_torch.engine.mesh_fwd import column_sig, plan_at_batch
from boda_tpu_torch.engine.torch_fwd import build_forward, weights_to_torch
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.cnn_variants import make_op_tune
from boda_tpu_torch.parallel import mesh as pmesh
from boda_tpu_torch.parallel.multihost import host_array

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MESHES = [(8, 1), (4, 2), (2, 4), (1, 1)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a mesh or a pipeline runs many small ops one
    after another, and with several test processes on one machine torch's
    threads would mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def cpu_slots(monkeypatch):
    """8 slots of the CPU for this test (the env restored after it)."""
    monkeypatch.setenv("BODA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("BODA_TORCH_LOCAL_DEVICES", "8")


def _jax_mesh(dp, mp):
    import jax
    return jmesh.make_mesh(n_devices=dp * mp, dp=dp, mp=mp,
                           devices=jax.devices("cpu"))


def _port_mesh(dp, mp):
    return pmesh.make_mesh(n_devices=dp * mp, dp=dp, mp=mp,
                           devices=[CPU] * 8)


def _plans(model):
    kw = dict(batch=8) if model == "mini" else dict(batch=8, ysz=32, xsz=32)
    return (jlower_pipe(jzoo.build_model(model, **kw)),
            lower_pipe(build_model(model, **kw)))


@pytest.mark.parametrize("model", ["mini", "resnet-50"])
@pytest.mark.parametrize("dp,mp", MESHES)
def test_shardings_equal_the_jax_package(model, dp, mp):
    jplan, plan = _plans(model)
    jm, m = _jax_mesh(dp, mp), _port_mesh(dp, mp)
    assert plan.input_nodes == jplan.input_nodes
    assert plan.weight_nodes == jplan.weight_nodes
    for sw in (True, False):
        jin, jw = jmesh.plan_shardings(jplan, jm, shard_weights=sw)
        pin, pw = pmesh.plan_shardings(plan, m, shard_weights=sw)
        for want, got in ((jin, pin), (jw, pw)):
            assert {n: tuple(s.spec) for n, s in want.items()} == \
                {n: tuple(s.spec) for n, s in got.items()}
    for n, dims in plan.node_dims.items():
        assert tuple(pmesh.spec_for_dims(dims, m)) == \
            tuple(jmesh.spec_for_dims(jplan.node_dims[n], jm)), n


def test_make_mesh_refuses_as_the_jax_package():
    with pytest.raises(RtErr, match=r"8 devices not divisible by mp=3"):
        pmesh.make_mesh(mp=3, devices=[CPU] * 8)
    with pytest.raises(RtErr, match=r"dp\*mp = 3\*2 != 8 devices"):
        pmesh.make_mesh(dp=3, mp=2, devices=[CPU] * 8)
    m = pmesh.make_mesh(n_devices=6, mp=3, devices=[CPU] * 8)
    assert m.shape == {"dp": 2, "mp": 3}
    assert m.local_positions() == m.positions()


def test_slots_follow_the_environment(monkeypatch):
    from boda_tpu_torch.core.device import local_devices
    monkeypatch.setenv("BODA_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("BODA_TORCH_LOCAL_DEVICES", raising=False)
    assert local_devices() == [CPU]
    monkeypatch.setenv("BODA_TORCH_LOCAL_DEVICES", "3")
    assert local_devices("cuda") == [CPU] * 3
    assert len(pmesh.global_devices()) == 3
    monkeypatch.setenv("BODA_TORCH_LOCAL_DEVICES", "0")
    with pytest.raises(RtErr, match="a count of slots >= 1"):
        local_devices()


def test_collectives_within_one_process():
    m = _port_mesh(2, 4)
    rng = np.random.RandomState(3)
    vals = {p: torch.from_numpy(rng.randn(2, 3).astype(np.float32))
            for p in m.local_positions()}
    g = pmesh.all_gather(m, vals, "mp", dim=1)
    s = pmesh.psum(m, vals, "dp")
    perm = [(i, (i + 1) % 4) for i in range(3)]  # no wrap: 0 gets zeros
    sh = pmesh.ppermute(m, vals, "mp", perm)
    for (i, j) in m.local_positions():
        torch.testing.assert_close(
            g[(i, j)], torch.cat([vals[(i, k)] for k in range(4)], dim=1))
        torch.testing.assert_close(s[(i, j)], vals[(0, j)] + vals[(1, j)])
        want = vals[(i, j - 1)] if j > 0 else torch.zeros(2, 3)
        torch.testing.assert_close(sh[(i, j)], want)
    assert pmesh.sum_over_ranks(m, {"a": vals[(0, 0)]})["a"] is vals[(0, 0)]


def test_host_array_takes_each_slots_shard():
    m = _port_mesh(4, 2)
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    sh = host_array(pmesh.NamedSharding(m, pmesh.PartitionSpec("dp", "mp")),
                    x)
    for (i, j), v in sh.items():
        np.testing.assert_array_equal(v.numpy(),
                                      x[2 * i:2 * i + 2, 3 * j:3 * j + 3])


_COLLECTIVES_2RANKS = r"""
import sys
import torch
import torch.distributed as dist
from boda_tpu_torch.parallel import mesh as pm
from boda_tpu_torch.parallel.multihost import init_multihost, \
    shutdown_multihost
rank = int(sys.argv[2])
init_multihost(sys.argv[1], 2, rank)
try:
    m = pm.make_mesh(mp=2)           # (2, 2): rank r holds row r
    assert m.spans_ranks() and len(m.local_positions()) == 2
    v = {p: torch.full((2,), 10.0 * p[0] + p[1]).to(torch.bfloat16)
         for p in m.local_positions()}
    g = pm.all_gather(m, v, "dp", dim=0)
    s = pm.psum(m, v, "dp")
    sh = pm.ppermute(m, v, "dp", [(0, 1)])
    for (i, j) in m.local_positions():
        assert g[(i, j)].tolist() == [float(j)] * 2 + [10.0 + j] * 2, g
        assert s[(i, j)].tolist() == [10.0 + 2 * j] * 2, s
        assert sh[(i, j)].tolist() == ([float(j)] * 2 if i else [0.0] * 2)
    r = pm.sum_over_ranks(m, {"w": torch.full((3,), rank + 1.0)})
    assert r["w"].tolist() == [3.0] * 3, r
    mx = pm.pmax(m, {p: torch.tensor([10.0 * p[0] - p[1],
                                      float("nan") if p == (1, 1) else 0.0])
                     for p in m.local_positions()}, "dp")
    for (i, j) in m.local_positions():
        assert mx[(i, j)][0].item() == 10.0 - j, mx
        assert mx[(i, j)][1].isnan().item() == (j == 1), mx
    print("collectives OK")
finally:
    shutdown_multihost()
"""


def test_collectives_between_two_processes(tmp_path):
    """all_gather, psum and ppermute over the dp axis of a (2,2) mesh whose
    rows are two gloo ranks (bf16 values, through the host),
    sum_over_ranks, and pmax over dp (f32, a NaN kept)."""
    from boda_tpu_torch.parallel.multihost import free_port
    script = tmp_path / "coll.py"
    script.write_text(_COLLECTIVES_2RANKS)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "BODA_TORCH_DEVICE": "cpu",
           "BODA_TORCH_LOCAL_DEVICES": "2", "OMP_NUM_THREADS": "1"}
    for _attempt in range(3):
        coord = f"localhost:{free_port()}"
        procs = [subprocess.Popen([sys.executable, str(script), coord,
                                   str(r)], cwd=ROOT, env=env, text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=120)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if not any("EADDRINUSE" in o or "address already in use" in o
                   for o in outs):
            break
    for p, o in zip(procs, outs):
        assert p.returncode == 0 and "collectives OK" in o, o[-2000:]


def test_plan_at_batch_and_column_sig():
    plan = lower_pipe(build_model("mini", batch=8))
    lp = plan_at_batch(plan, 2)
    assert all(d["img"] == 2 for d in lp.node_dims.values() if "img" in d)
    assert plan_at_batch(plan, 8) is plan
    s = next(s for s in lp.steps if s.func_name in ("conv", "k1conv"))
    cs = column_sig(s.sig, 2)
    oc = s.sig.get_dims("filts")["out_chan"]
    assert cs.get_dims("filts")["out_chan"] == oc // 2
    assert cs.get_dims("out")["chan"] == oc // 2
    assert cs.get_dims("in") == s.sig.get_dims("in")


def _jax_engine_prob(tune, mesh, x):
    pipe = jzoo.build_model("mini", batch=8)
    e = jiface.make_engine(f"(engine=rtc,op_tune={tune}{mesh})")
    e.init(pipe)
    d = pipe.get_data_img_dims()
    return e.run_fwd({"data": jdims.NDA(d, x)}, ["prob"])["prob"].v


@pytest.mark.parametrize("tune,f32", [("()", True),
                                      ("(prec=bf16,layout=nhwc)", False)])
def test_engine_mesh_matches_the_jax_engine(cpu_slots, tune, f32):
    """engine=torch with mesh_dp=4,mesh_mp=2 on mini b8 against engine=rtc
    on the same mesh, and against its own forward without a mesh."""
    pipe = build_model("mini", batch=8)
    d = pipe.get_data_img_dims()
    x = np.random.RandomState(0).randn(*d.shape).astype(np.float32)
    mesh = ",mesh_dp=4,mesh_mp=2"
    e = make_engine(f"(engine=torch,device=cpu,op_tune={tune}{mesh})")
    e.init(pipe)
    assert e.fwd.routes == {"column_parallel": 4, "gathered": 0}
    assert "mesh: {'dp': 4, 'mp': 2}" in e.get_info_log()
    got = e.run_fwd({"data": NDA(d, x)}, ["prob"])["prob"].v
    want = _jax_engine_prob(tune, mesh, x)
    e1 = make_engine(f"(engine=torch,device=cpu,op_tune={tune})")
    e1.init(pipe)
    one = e1.run_fwd({"data": NDA(d, x)}, ["prob"])["prob"].v
    if f32:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, one, rtol=2e-5, atol=2e-5)
    else:
        for ref in (want, one):
            assert np.abs(got - ref).max() / np.abs(ref).max() <= 5e-3


def test_engine_mesh_routes_and_hooks(cpu_slots):
    """The sibling-fused tune sends its xla_conv2 steps down the gathered
    route; enable_stats and nan_check read the dp-gathered nodes, so their
    results equal the forward's without a mesh."""
    pipe = build_model("resnet-50", batch=4, ysz=32, xsz=32)
    d = pipe.get_data_img_dims()
    x = NDA(d, np.random.RandomState(1).randn(*d.shape).astype(np.float32))
    tune = "(use_culibs=1,fuse_siblings=1,s2d=0)"
    outs = {}
    for mesh in ("", ",mesh_dp=2,mesh_mp=2"):
        e = make_engine(f"(engine=torch,device=cpu,op_tune={tune},"
                        f"enable_stats=1,nan_check=1{mesh})")
        e.init(pipe)
        outs[mesh] = (e.run_fwd({"data": x}, ["prob", "res3a"])["res3a"].v,
                      {k: v.v for k, v in e.stats.items()})
        if mesh:
            assert e.fwd.routes == {"column_parallel": 46, "gathered": 4}
    (a, sa), (b, sb) = outs.values()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        np.testing.assert_allclose(sb[k], sa[k], rtol=1e-4, atol=1e-5)


def test_engine_mesh_refusals(cpu_slots):
    pipe = build_model("mini", batch=8)
    with pytest.raises(RtErr, match="the mesh runs the fused executor"):
        make_engine("(engine=torch,device=cpu,fuse=0,mesh_dp=2)").init(pipe)
    with pytest.raises(RtErr, match=r"dp\*mp = 4\*4 != 8 devices"):
        make_engine("(engine=torch,device=cpu,mesh_dp=4,mesh_mp=4)").init(
            pipe)
    # a dynamic int8 scale is the batch's absmax: a dp split takes it over
    # the dp group (pmax), so its forward is one slot's
    d = pipe.get_data_img_dims()
    x = {"data": NDA(d, np.random.RandomState(0).randn(*d.shape)
                     .astype(np.float32))}
    tune = "op_tune=(use_culibs=1,prec=bf16,layout=nhwc,quant8=1)"
    probs = []
    for mesh in (",mesh_dp=2", ""):
        e = make_engine(f"(engine=torch,device=cpu,{tune}{mesh})")
        e.init(pipe)
        probs.append(e.run_fwd(x, ["prob"])["prob"].v)
    np.testing.assert_array_equal(*probs)
    # mp alone leaves the batch whole, so the dynamic scale is the same
    e = make_engine("(engine=torch,device=cpu,mesh_dp=1,mesh_mp=2,"
                    "op_tune=(use_culibs=1,prec=bf16,layout=nhwc,quant8=1))")
    e.init(pipe)
    assert e.fwd.routes["column_parallel"] > 0


def test_mesh_forward_under_autograd_sums_the_slots(cpu_slots):
    """The dp slots' gradients add up to the unsharded forward's (the
    weights' autograd accumulates every slot's share)."""
    pipe = build_model("mini", batch=8)
    plan = lower_pipe(pipe, make_op_tune("(use_culibs=1)"), fused_storage=True)
    w = weights_to_torch(plan, pipe.op_params, CPU)
    x = torch.from_numpy(np.random.RandomState(2).randn(
        *pipe.get_data_img_dims().shape).astype(np.float32))
    grads = []
    for fwd in (build_forward(plan, CPU),
                build_forward(plan, mesh=_port_mesh(4, 2))):
        wr = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        loss = fwd({"data": x}, wr)["prob"].square().sum()
        grads.append(torch.autograd.grad(loss, list(wr.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


def test_flagship_sharded_vs_single_and_the_jax_output(cpu_slots):
    """flagship_sharded_vs_single at ResNet-50 b8 32x32 on a (4,2) mesh: the
    sharded prob within 1e-4 of one slot's, and of the JAX package's."""
    import jax

    import __graft_entry__ as ge
    from boda_tpu_torch.parallel import dryrun
    mrd = dryrun.flagship_sharded_vs_single(_port_mesh(4, 2), CPU, batch=8,
                                            ysz=32)
    assert mrd < 1e-4
    pipe, plan, fwd, weights = dryrun._fused_for("resnet-50", device=CPU,
                                                 batch=8, ysz=32, xsz=32)
    x = np.random.RandomState(0).randn(
        *pipe.get_data_img_dims().shape).astype(np.float32) * 0.1
    with torch.no_grad():
        got = build_forward(plan, mesh=_port_mesh(4, 2))(
            {"data": torch.from_numpy(x)}, weights)["prob"].numpy()
    _jp, _jplan, jfwd, jw = ge._fused_for("resnet-50", batch=8, ysz=32,
                                         xsz=32)
    want = np.asarray(jax.jit(lambda w, xv: jfwd({"data": xv}, w)["prob"])(
        jw, x))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_dryrun_multichip_on_8_cpu_slots(cpu_slots, capsys):
    from boda_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8)
    out = capsys.readouterr().out
    for line in ("dryrun_multichip OK: mesh=(4,2) loss",
                 "resnet-50 sharded mesh=(4,2) vs single-device",
                 "resnet-50 bf16 TRAINING step sharded mesh=(4,2)",
                 "gpipe pp=4 resnet-50 stages match sequential",
                 "gpipe pp=4 resnet-50 TRAINING step",
                 "1F1B pp=4 TRAINING step"):
        assert line in out, out
