"""The serving path of the port on the CPU: the dynamic-batching server
(apps/aio_serve.py: aio_cls_server, serve_bench), its framed wire
(parallel/transport.py) and the cnet-infer stream stage
(apps/stream_infer.py), against the JAX package.

The cases of tests/test_aio.py run through the port's server with
engine=(engine=torch,device=cpu) (the kernels' plain versions); then the
same images go through the JAX server (engine=rtc on the CPU) and the
port's: the same classes, probabilities within 1e-5. The wire's framing
over fds, tcp and tcp-listen, and a JAX peer on the port's stream. No
fixed sleeps: servers listen on port 0 and report it through the started
callback.

Tolerances: probabilities across packages and engines 1e-5; the u8 wire
against the f32 wire 1e-6 (the same float values reach the forward).
"""

import os
import socket
import threading

import numpy as np
import pytest

from boda_tpu.apps import aio_serve as jaio
from boda_tpu.core import has_main as jhas_main
from boda_tpu.core import lexp as jlexp
from boda_tpu.parallel import transport as jtransport
import boda_tpu_torch.modes  # noqa: F401  (registers the modes, engines, stages)
from boda_tpu_torch.apps.aio_serve import AioClsServer, classify_over_stream
from boda_tpu_torch.core.dims import NDA, Dims
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core import lexp as plexp
from boda_tpu_torch.core.has_main import create_and_run_has_main
from boda_tpu_torch.io.img import img_to_chw, make_test_pattern_img
from boda_tpu_torch.parallel.transport import (Stream, accept_stream,
                                               listen_socket, make_stream)

CPU = "(engine=torch,device=cpu)"
PROB_TOL = 1e-5


@pytest.fixture(autouse=True)
def _jnp_fallback(monkeypatch):
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")


def _start(cls, conv_fwd, lexp_mod, **kw):
    """Start a server of class `cls` (either package's AioClsServer) on
    port 0 in a thread; returns (server, thread, port)."""
    cfg = {"model": "mini", "port": "0",
           **{k: str(v) for k, v in kw.items()}}
    if conv_fwd:
        cfg["conv_fwd"] = lexp_mod.parse_lexp(conv_fwd)
    srv = cls.init_from_lexp(lexp_mod.Lexp.from_obj(cfg))
    box = {}
    evt = threading.Event()
    cls._started_cb = staticmethod(lambda p: (box.update(port=p), evt.set()))
    th = threading.Thread(target=srv.main, daemon=True)
    th.start()
    assert evt.wait(120), "server did not start"
    cls._started_cb = None
    return srv, th, box["port"]


def _start_server(**kw):
    return _start(AioClsServer, CPU, plexp, **kw)


def _client(port):
    return make_stream(f"tcp:127.0.0.1:{port}", impl="py")


def test_concurrent_clients_coalesce():
    n = 4
    srv, th, port = _start_server(max_batch=n, batch_window_ms=800,
                                  num_requests=n, top_k=2)
    d = srv._img_dims
    results = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        img = (np.random.RandomState(i).randn(*d) * 0.1).astype(np.float32)
        st = _client(port)
        barrier.wait()
        results[i] = classify_over_stream(st, img, 2)
        st.close()

    cs = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for c in cs:
        c.start()
    for c in cs:
        c.join(120)
    th.join(120)
    assert not th.is_alive()
    assert all(r is not None for r in results)
    # all 4 arrived inside the window: coalescing must have happened
    assert max(r[0] for r in results) >= 2
    for bsz, rows in results:
        assert rows.shape == (2, 2)
        assert 0 <= rows[0, 0] < 10 and 0 <= rows[0, 1] <= 1.0001


def test_single_request_and_quit():
    srv, th, port = _start_server(max_batch=2, batch_window_ms=5, top_k=3)
    d = srv._img_dims
    st = _client(port)
    bsz, rows = classify_over_stream(st, np.zeros(d, np.float32), 3)
    assert bsz == 1 and rows.shape == (3, 2)
    assert rows[0, 1] >= rows[1, 1] >= rows[2, 1]  # sorted descending
    st.write_frame(b"(op=quit)")
    assert st.read_frame() == b"(ok=1)"
    st.close()
    th.join(60)
    assert not th.is_alive()


def test_bad_dims_errors():
    srv, th, port = _start_server(max_batch=1, batch_window_ms=5,
                                  num_requests=1)
    st = _client(port)
    with pytest.raises(RtErr, match="bad image dims"):
        classify_over_stream(st, np.zeros((1, 2, 2), np.float32), 1)
    # the server still serves a good request afterwards
    bsz, rows = classify_over_stream(st, np.zeros(srv._img_dims, np.float32),
                                     1)
    assert bsz == 1 and rows.shape == (1, 2)
    st.close()
    th.join(60)


def test_serve_bench_smoke(tmp_path, capsys):
    import re
    hm = create_and_run_has_main(
        f"(mode=serve_bench,model=mini,num_clients=3,n1=1,n2=3,"
        f"batch_window_ms=200,out_fn=sb.lexp,boda_output_dir={tmp_path},"
        f"engine={CPU})")
    out = capsys.readouterr().out
    assert (tmp_path / "sb.lexp").exists()
    m = re.search(r"slope over (\d+) reqs: ([\d.]+|nan) req/s", out)
    assert m, out
    assert int(m.group(1)) == 3 * (3 - 1)
    if m.group(2) != "nan":  # host timing noise can leave it unresolved
        assert float(m.group(2)) > 0
    assert "mean realized batch" in out
    # every client's last reply and image are kept
    assert all(r is not None and r[1].shape == (1, 2) for r in hm.replies)
    assert [im.shape for im in hm.imgs] == [(3, 32, 32)] * 3


def test_serve_bench_engine_passthrough(tmp_path, capsys):
    """serve_bench --engine reaches the server's engine: a quant8 per-site
    tune shows in the op_tunes_pat line and the bench still resolves."""
    t = "use_culibs=1,prec=bf16,layout=nhwc,s2d=0"
    create_and_run_has_main(
        f"(mode=serve_bench,model=mini,num_clients=2,n1=1,n2=3,"
        f"batch_window_ms=200,out_fn=sb.lexp,boda_output_dir={tmp_path},"
        f"engine=(engine=torch,device=cpu,op_tune=({t}),"
        f"op_tunes_pat=(conv2=({t},quant8=1))))")
    out = capsys.readouterr().out
    assert "op_tunes_pat: tuned 1 op(s)" in out
    assert "mean realized batch" in out


def test_serve_bench_latency_decomposition(tmp_path, capsys):
    import re
    hm = create_and_run_has_main(
        f"(mode=serve_bench,model=mini,num_clients=3,n1=1,n2=4,"
        f"batch_window_ms=200,out_fn=sb.lexp,boda_output_dir={tmp_path},"
        f"engine={CPU})")
    out = capsys.readouterr().out
    m = re.search(r"decomposition \(p2-p1\): queue ([\d.]+) ms/req, "
                  r"engine ([\d.]+) ms/batch \(([\d.]+) ms/req at "
                  r"realized batch ([\d.]+)\)", out)
    assert m, out
    q, eb, er, rb = (float(g) for g in m.groups())
    assert q >= 0 and eb > 0 and er > 0 and rb >= 1
    assert abs(er - eb / rb) < 0.05 * eb + 1e-6
    rec = (tmp_path / "sb.lexp").read_text()
    for key in ("req_per_sec", "secs_per_req", "mean_batch",
                "queue_ms_per_req", "engine_ms_per_batch",
                "engine_ms_per_req", "p2_batch"):
        assert f"{key}=" in rec
        assert key in hm.record


def test_u8_wire_format_matches_f32():
    """wire_fmt=u8 (raw HWC uint8 on the wire, mean subtraction, BGR and
    transpose on the engine's device, TorchFwd.set_input_preproc) gives
    the f32 wire's replies (host img_to_chw)."""
    srv8, th8, port8 = _start_server(max_batch=1, batch_window_ms=5,
                                     num_requests=1, top_k=3, wire_fmt="u8")
    y, x, _c = srv8._img_dims
    raw = np.ascontiguousarray(make_test_pattern_img(y, x, mode=2), np.uint8)
    st = _client(port8)
    bsz8, rows8 = classify_over_stream(st, raw, 3)
    st.close()
    th8.join(60)

    srv, th, port = _start_server(max_batch=1, batch_window_ms=5,
                                  num_requests=1, top_k=3)
    st = _client(port)
    bszf, rowsf = classify_over_stream(
        st, img_to_chw(raw).astype(np.float32), 3)
    st.close()
    th.join(60)

    assert rows8.shape == rowsf.shape == (3, 2)
    np.testing.assert_array_equal(rows8[:, 0], rowsf[:, 0])  # same classes
    np.testing.assert_allclose(rows8[:, 1], rowsf[:, 1], rtol=0, atol=1e-6)


def test_u8_wire_format_rejects_f32_request():
    srv, th, port = _start_server(max_batch=1, batch_window_ms=5,
                                  num_requests=1, wire_fmt="u8")
    st = _client(port)
    y, x, _c = srv._img_dims
    with pytest.raises(RtErr, match="bad image dims"):
        classify_over_stream(st, np.zeros((3, y, x), np.float32), 1)
    bsz, rows = classify_over_stream(st, np.zeros(srv._img_dims, np.uint8), 1)
    assert bsz == 1 and rows.shape == (1, 2)
    st.close()
    th.join(60)


@pytest.mark.parametrize("wire_fmt", ["f32", "u8"])
def test_same_replies_as_the_jax_server(wire_fmt):
    """Three images, one request each, to the JAX server (engine=rtc on
    the CPU) and to the port's (engine=torch,device=cpu): the same
    classes, probabilities within 1e-5."""
    kw = dict(max_batch=3, batch_window_ms=5, num_requests=3, top_k=5,
              wire_fmt=wire_fmt)
    got = {}
    for name, cls, spec, lmod, client in (
            ("jax", jaio.AioClsServer, "", jlexp, jaio.classify_over_stream),
            ("port", AioClsServer, CPU, plexp, classify_over_stream)):
        srv, th, port = _start(cls, spec, lmod, **kw)
        d = srv._img_dims
        # the same images for both servers, near the mean so that the
        # mini net's softmax is far from saturated (its top-5 are apart)
        rng = np.random.RandomState(11)
        imgs = [(np.array([123, 117, 104]) + rng.randint(-2, 3, d))
                .astype(np.uint8) if wire_fmt == "u8"
                else rng.randn(*d).astype(np.float32) for _ in range(3)]
        st = jtransport.make_stream(f"tcp:127.0.0.1:{port}", impl="py")
        got[name] = [client(st, im, 5)[1] for im in imgs]
        st.close()
        th.join(60)
        assert not th.is_alive()
    for rj, rp in zip(got["jax"], got["port"]):
        assert rj.shape == rp.shape == (5, 2)
        np.testing.assert_array_equal(rp[:, 0], rj[:, 0])
        np.testing.assert_allclose(rp[:, 1], rj[:, 1], rtol=0, atol=PROB_TOL)


# ---- the wire: framed streams ----

PAYLOADS = [b"", b"x", b"(op=classify,top_k=3)", bytes(range(256)) * 300]


def _roundtrip(a: Stream, b: Stream):
    """Every payload from a to b and back, in order, byte for byte; each
    direction's writer runs in a thread of its own (a large frame fills a
    pipe's buffer before its reader starts)."""
    for src, dst, ps in ((a, b, PAYLOADS), (b, a, PAYLOADS[::-1])):
        w = threading.Thread(target=lambda s=src, q=ps: [s.write_frame(p)
                                                          for p in q])
        w.start()
        got = [dst.read_frame() for _ in ps]
        w.join(60)
        assert got == ps


def test_fds_framing():
    r1, w1 = os.pipe()
    r2, w2 = os.pipe()
    a = make_stream(f"fds:{r2}:{w1}")
    b = make_stream(f"fds:{r1}:{w2}")
    _roundtrip(a, b)
    a.close()
    b.close()
    # a closed peer reads as EOF
    r, w = os.pipe()
    s = make_stream(f"fds:{r}:{w}")
    os.close(w)
    s.wfd = None
    with pytest.raises(RtErr, match="EOF"):
        s.read_frame()
    s.close()


def test_tcp_framing_and_a_jax_peer():
    """tcp: the port's listener and client; then a JAX client on the
    port's listener (one wire format)."""
    for client_mod in ("port", "jax"):
        lsock = listen_socket(0)
        port = lsock.getsockname()[1]
        box = {}
        th = threading.Thread(target=lambda: box.update(s=accept_stream(lsock)))
        th.start()
        mk = make_stream if client_mod == "port" else jtransport.make_stream
        c = mk(f"tcp:127.0.0.1:{port}", impl="py")
        th.join(60)
        _roundtrip(c, box["s"])
        c.close()
        box["s"].close()


def test_tcp_listen_framing():
    """The tcp-listen address: a port is found free, make_stream listens
    on it in a thread and the client connects once it listens (polled)."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    box = {}
    th = threading.Thread(
        target=lambda: box.update(s=make_stream(f"tcp-listen:{port}",
                                                is_server=True)))
    th.start()
    for _ in range(2000):
        try:
            c = make_stream(f"tcp:127.0.0.1:{port}")
            break
        except ConnectionRefusedError:
            th.join(0.01)
    th.join(60)
    _roundtrip(c, box["s"])
    c.close()
    box["s"].close()


def test_native_stream_and_unknown_addresses_raise():
    # impl=cpp is the native host core's stream: with no listener (or no
    # compiler to build the core) it raises, never falling back to py
    with pytest.raises(RtErr):
        make_stream("tcp:127.0.0.1:1", impl="cpp")
    with pytest.raises(RtErr, match="unknown impl"):
        make_stream("tcp:127.0.0.1:1", impl="rust")
    with pytest.raises(RtErr, match="unknown transport method"):
        make_stream("udp:1:2")


# ---- the cnet-infer stream stage ----

def test_cnet_infer_stage_against_jax():
    """cnet-infer on u8 HWC, RGBA, preprocessed float CHW and raw float
    blocks: the port (engine=torch,device=cpu) gives the JAX stage's
    (engine=rtc) rows; a wrong-size float block raises."""
    import boda_tpu.apps.stream_infer  # noqa: F401  (registers cnet-infer)
    from boda_tpu.core.dims import NDA as JNDA, Dims as JDims
    from boda_tpu.io import data_stream as jds
    from boda_tpu_torch.apps import stream_infer  # noqa: F401
    from boda_tpu_torch.io import data_stream as pds

    rng = np.random.RandomState(7)
    img = rng.randint(0, 255, (32, 32, 3)).astype(np.uint8)
    chw = img_to_chw(img)
    rgba = np.concatenate([img, np.full((32, 32, 1), 255, np.uint8)], axis=2)
    raw_f = np.transpose(img, (2, 0, 1)).astype(np.float32)
    blocks = [(img, dict(y=32, x=32, chan=3)),
              (rgba, dict(y=32, x=32, chan=4)),
              (chw, dict(chan=3, y=32, x=32)),
              (raw_f, dict(chan=3, y=32, x=32))]

    def run(ds_mod, nda, dims_cls, spec):
        st = ds_mod.make_data_stream(spec)
        rows = []
        for v, dd in blocks:
            tn = "float" if v.dtype.kind == "f" else "uint8_t"
            b = st.proc_block(ds_mod.DataBlock(
                nda(dims_cls.make(tn=tn, **dd), v), frame_ix=0,
                timestamp_ns=5))
            pred = b.get_sdb("pred")
            assert pred.timestamp_ns == 5
            rows.append((pred.nda.v.copy(), b.meta))
        return st, rows

    _, jrows = run(jds, JNDA, JDims,
                   "(mode=cnet-infer,model=mini,top_k=3,conv_fwd=(engine=rtc))")
    st, prows = run(pds, NDA, Dims,
                    f"(mode=cnet-infer,model=mini,top_k=3,conv_fwd={CPU})")
    for (pj, mj), (pp, mp) in zip(jrows, prows):
        assert pp.shape == (3, 2)
        np.testing.assert_array_equal(pp[:, 0], pj[:, 0])
        np.testing.assert_allclose(pp[:, 1], pj[:, 1], rtol=0, atol=PROB_TOL)
        assert mp.split()[0].split(":")[0] == mj.split()[0].split(":")[0]
    with pytest.raises(RtErr, match="float block spatial"):
        st.proc_block(pds.DataBlock(NDA(Dims.make(tn="float", chan=3, y=16,
                                                  x=16),
                                        chw[:, :16, :16].copy()),
                                    frame_ix=0, timestamp_ns=0))
