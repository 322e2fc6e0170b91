"""be=ipc on the port (backend/ipc.py) against the JAX package's.

A worker process (`python -m boda_tpu_torch ipc_compute_worker`) runs each
verb on its own backend; the port's master is engine=torch's per-call mode
or the per-op modes. On the CPU (BODA_TORCH_DEVICE=cpu, which the spawned
worker inherits), `mini`'s per-call forward over (be=ipc,worker_be=torch)
is bit-equal to the in-process per-call forward and within f32 rounding
(mrd 1e-5) of the JAX package's forward over (be=ipc,worker_be=xla);
cs_test_master passes over both inner backends; a worker's error reaches
the master with the worker's own text, and so does a worker asked for a
card that is not there; the TCP and spawn_str workers and the launches
verb work; the native stream (impl=cpp) interoperates with the Python one.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import boda_tpu.modes  # noqa: F401  (register be=ipc of the JAX package)
from boda_tpu.core.dims import NDA as JNDA
from boda_tpu.engine.iface import make_engine as jmake_engine
from boda_tpu.models.zoo import build_model as jbuild_model
from boda_tpu.ops.pallas.sgemm import make_sgemm_op
from boda_tpu_torch.backend.iface import make_backend
from boda_tpu_torch.core.dims import NDA, Dims
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.has_main import create_and_run_has_main
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.op_base import OpBase
from boda_tpu_torch.ops.registry import Codegen
from boda_tpu_torch.parallel.transport import Stream, make_stream

import boda_tpu_torch.modes  # noqa: F401,E402


@pytest.fixture()
def cpu_ask(monkeypatch):
    """The CPU ask for this process and every worker it spawns."""
    monkeypatch.setenv("BODA_TORCH_DEVICE", "cpu")


@pytest.fixture()
def ipc_be(cpu_ask):
    be = make_backend("(be=ipc,worker_be=torch)")
    be.init()
    yield be
    be.quit_worker()


def _mini_input(batch=2):
    pipe = build_model("mini", batch=batch)
    d = pipe.get_data_img_dims()
    x = np.random.RandomState(3).randn(*d.shape).astype(np.float32)
    return pipe, d, x


def test_per_call_forward_over_ipc_matches_in_process_and_jax(cpu_ask):
    pipe, d, x = _mini_input()
    data, top = pipe.data_img_node_names[0], pipe.get_single_top_node().name
    nodes = ["conv1", "conv2", top]
    remote = make_engine("(engine=torch,fuse=0,"
                         "rtc=(be=ipc,worker_be=torch))")
    remote.init(pipe)
    try:
        assert remote.dev is None  # the worker holds the device
        assert remote.rtc.get_plat_tag() == "ipc:torch:cpu:cpu"
        got = remote.run_fwd({data: NDA(d, x)}, nodes)
        assert remote.last_run_secs > 0
        assert set(remote.rtc.launches()) >= {"matmul_ext", "tconv", "qconv"}
    finally:
        remote.rtc.quit_worker()
    local = make_engine("(engine=torch,fuse=0,device=cpu)")
    local.init(pipe)
    want = local.run_fwd({data: NDA(d, x)}, nodes)
    for n in nodes:
        np.testing.assert_array_equal(got[n].v, want[n].v)
    jpipe = jbuild_model("mini", batch=2)
    jeng = jmake_engine("(engine=rtc,fuse=0,rtc=(be=ipc,worker_be=xla))")
    jeng.init(jpipe)
    try:
        jout = jeng.run_fwd({data: JNDA(jpipe.get_data_img_dims(), x)}, nodes)
    finally:
        jeng.rtc.quit_worker()
    for n in nodes:
        a, b = got[n].v.astype(np.float64), np.asarray(jout[n].v, np.float64)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), n


def test_default_worker_be_is_torch(cpu_ask):
    """rtc=(be=ipc) with no worker_be starts the worker on the port's own
    backend: the whole per-call forward runs and equals the in-process one."""
    pipe, d, x = _mini_input()
    data, top = pipe.data_img_node_names[0], pipe.get_single_top_node().name
    remote = make_engine("(engine=torch,fuse=0,rtc=(be=ipc))")
    remote.init(pipe)
    try:
        assert remote.rtc.worker_be == "torch"
        assert remote.rtc.get_plat_tag() == "ipc:torch:cpu:cpu"
        got = remote.run_fwd({data: NDA(d, x)}, [top])[top].v
    finally:
        remote.rtc.quit_worker()
    local = make_engine("(engine=torch,fuse=0,device=cpu)")
    local.init(pipe)
    np.testing.assert_array_equal(
        got, local.run_fwd({data: NDA(d, x)}, [top])[top].v)


@pytest.mark.parametrize("worker_be", ["interp", "torch"])
def test_cs_test_master(worker_be, cpu_ask, capsys):
    create_and_run_has_main(f"(mode=cs_test_master,worker_be={worker_be},"
                            f"n=256)", global_vars={})
    out = capsys.readouterr().out
    plat = "interp:numpy" if worker_be == "interp" else "torch:cpu:cpu"
    assert f"rtc_test PASSED plat=ipc:{plat} n=256" in out
    assert "cs_test_master PASSED" in out


def test_ipc_backend_contract(ipc_be):
    be = ipc_be
    d = Dims.make(y=4, x=8)
    be.create_var_with_dims("v", d)
    assert be.var_exists("v") and be.get_var_dims("v") == d
    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    be.copy_nda_to_var("v", NDA(d, x))
    np.testing.assert_array_equal(be.copy_var_to_nda("v").v, x)
    be.create_var_with_dims_as_reshaped_view_of_var("vf", Dims.make(n=32), "v")
    np.testing.assert_array_equal(be.copy_var_to_nda("vf").v, x.reshape(-1))
    be.release_var("vf")
    be.release_var("v")
    with pytest.raises(RtErr, match="ipc worker error"):
        be.copy_var_to_nda("nonexistent")
    assert be.launches(reset=True)["matmul_ext"] == 0  # plain on the CPU


def test_ipc_runs_a_template_like_in_process(ipc_be):
    """One sgemm through the worker's be=torch equals the same instance in
    process (the worker builds the template from the shipped signature)."""
    op = OpBase.from_lexp(str(make_sgemm_op(32, 32, 32).to_lexp()))
    rng = np.random.RandomState(0)
    a = rng.randn(32, 32).astype(np.float32)
    b = rng.randn(32, 32).astype(np.float32)
    outs = []
    for be in (ipc_be, make_backend("(be=torch,device=cpu)")):
        be.ensure_init()
        cg = Codegen(be)
        for v in ("a", "b", "c"):
            be.create_var_with_dims(v, op.get_dims(v))
        be.copy_ndas_to_vars({"a": NDA(op.get_dims("a"), a),
                              "b": NDA(op.get_dims("b"), b)})
        cid = cg.gen_and_run(op, {"a": "a", "b": "b", "c": "c"})
        be.finish_and_sync()
        assert be.get_dur(cid, cid) >= 0
        outs.append(be.copy_var_to_nda("c").v)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_worker_error_reaches_the_master(monkeypatch):
    """No card and no CPU ask: the worker's be=torch raises on its default
    device, and the master raises with the worker's own error text; nothing
    falls back to the CPU."""
    monkeypatch.delenv("BODA_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    be = make_backend("(be=ipc,worker_be=torch)")
    with pytest.raises(RtErr, match="ipc worker error: RtErr: device 'cuda' "
                                    "requested but CUDA is not available"):
        be.init()
    be.quit_worker()


def test_engine_over_ipc_reports_the_worker_error(monkeypatch):
    monkeypatch.delenv("BODA_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    pipe, _d, _x = _mini_input()
    eng = make_engine("(engine=torch,fuse=0,rtc=(be=ipc,worker_be=torch))")
    with pytest.raises(RtErr, match="ipc worker error: .*CUDA is not "
                                    "available"):
        eng.init(pipe)
    eng.rtc.quit_worker()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ipc_tcp_remote_worker(cpu_ask):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "boda_tpu_torch", "ipc_compute_worker",
         f"--boda-parent-addr=tcp-listen:{port}", "--rtc=interp"])
    try:
        deadline = time.time() + 120
        be = None
        while time.time() < deadline:
            try:
                be = make_backend(f"(be=ipc,boda_parent_addr="
                                  f"tcp:127.0.0.1:{port})")
                be.init()
                break
            except (RtErr, OSError):
                be = None
                time.sleep(0.5)
        assert be is not None, "worker never came up"
        assert be.get_plat_tag() == "ipc:interp:numpy"
        d = Dims.make(y=2, x=3)
        be.create_var_with_dims("v", d)
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        be.copy_nda_to_var("v", NDA(d, x))
        np.testing.assert_array_equal(be.copy_var_to_nda("v").v, x)
        be.quit_worker()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_ipc_spawn_str_worker(cpu_ask):
    spawn = (f"{sys.executable} -m boda_tpu_torch ipc_compute_worker "
             f"--boda-parent-addr=%%(addr) --rtc=torch")
    be = make_backend({"be": "ipc", "spawn_str": spawn})
    be.init()
    try:
        assert be.get_plat_tag() == "ipc:torch:cpu:cpu"
        d = Dims.make(y=2, x=2)
        be.create_var_with_dims("v", d)
        x = np.arange(4, dtype=np.float32).reshape(2, 2)
        be.copy_nda_to_var("v", NDA(d, x))
        np.testing.assert_array_equal(be.copy_var_to_nda("v").v, x)
    finally:
        be.quit_worker()
    assert be._proc.returncode == 0


def test_worker_spawns_the_port():
    """The spawned worker is the port's CLI, never the JAX package's."""
    import inspect
    from boda_tpu_torch.backend import ipc
    from boda_tpu_torch.io import data_stream
    for mod in (ipc, data_stream):
        src = inspect.getsource(mod)
        assert '"-m", "boda_tpu_torch"' in src
        assert '"-m", "boda_tpu",' not in src


@pytest.mark.parametrize("writer,reader", [("cpp", "py"), ("py", "cpp"),
                                           ("cpp", "cpp")])
def test_native_stream_interoperates(writer, reader):
    """make_stream(impl=cpp) (the host core's stream.cc) and the Python
    stream share one wire: frames written by one are read by the other."""
    from boda_tpu_torch.utils.cpplib import cpp_available
    if not cpp_available():
        pytest.skip("no C++ compiler for the native host core")
    a, b = socket.socketpair()
    fa, fb = os.dup(a.fileno()), os.dup(b.fileno())
    a.close()
    b.close()
    w = make_stream(f"fds:{fa}:{fa}", impl=writer)
    r = make_stream(f"fds:{fb}:{fb}", impl=reader)
    frames = [b"", b"x", bytes(range(256)) * 300]
    for f in frames:
        w.write_frame(f)
    assert [r.read_frame() for _ in frames] == frames
    w.close()
    with pytest.raises(RtErr, match="EOF"):
        r.read_frame()
    r.close()
    assert isinstance(make_stream("fds:0:1", impl="py"), Stream)
    with pytest.raises(RtErr, match="unknown impl"):
        make_stream("fds:0:1", impl="rust")
