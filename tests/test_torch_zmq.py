"""The zmq inference service of the port (apps/zmq_serve.py; reference
zmq-util.cc req/rep protocol, the det stub server and the zmq-det
data-stream stage): the cases of tests/test_zmq_serve.py through the
port, and the real detection and classification servers on the CPU
(engine=torch,device=cpu) against the JAX package's (engine=rtc) on the
same image: the same boxes, confidences within 1e-4."""

import threading

import numpy as np
import pytest

pytest.importorskip("zmq")

from boda_tpu.core import has_main as jhas_main  # noqa: E402
import boda_tpu_torch.modes  # noqa: E402,F401  (registers the modes)
from boda_tpu_torch.core.dims import NDA, Dims  # noqa: E402
from boda_tpu_torch.core.error import RtErr  # noqa: E402
from boda_tpu_torch.core.has_main import create_and_run_has_main  # noqa: E402

CPU = "(engine=torch,device=cpu)"
TOL = 1e-4


@pytest.fixture(autouse=True)
def _jnp_fallback(monkeypatch):
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")


def _ep(tmp_path, name):
    return f"ipc://{tmp_path}/{name}"


def _serve_in_thread(spec, run=create_and_run_has_main):
    t = threading.Thread(target=run, args=(spec, {}))
    t.start()
    return t


def test_hello_roundtrip(tmp_path, capsys):
    ep = _ep(tmp_path, "hello")
    t = _serve_in_thread(f"(mode=zmq_hello_server,endpoint={ep},num_req=1)")
    create_and_run_has_main(f"(mode=zmq_hello_client,endpoint={ep})", {})
    t.join(timeout=10)
    assert "world (hello)" in capsys.readouterr().out


def test_det_stub_roundtrip(tmp_path, capsys):
    ep = _ep(tmp_path, "det")
    img = tmp_path / "img.bin"
    img.write_bytes(b"\x01\x02\x03\x04" * 16)
    t = _serve_in_thread(f"(mode=zmq_det_stub_server,endpoint={ep},num_req=2)")
    create_and_run_has_main(
        f"(mode=zmq_det_client,endpoint={ep},image_fn={img},num_iter=2)", {})
    t.join(timeout=10)
    out = capsys.readouterr().out
    assert out.count("box: x=100 y=100 w=200 h=200 conf=0.98") == 2


def test_zmq_det_stream_annotates(tmp_path):
    from boda_tpu_torch.io.data_stream import make_data_stream, \
        read_all_blocks
    ep = _ep(tmp_path, "dets")
    t = _serve_in_thread(f"(mode=zmq_det_stub_server,endpoint={ep},num_req=3)")
    ds = make_data_stream(
        f"(mode=pipe,stages=((mode=test-gen,num=3,sz=8),"
        f"(mode=zmq-det,endpoint={ep})))")
    bs = read_all_blocks(ds)
    t.join(timeout=10)
    assert len(bs) == 3
    for b in bs:
        boxes = b.get_sdb("boxes")
        assert boxes is not None
        assert boxes.nda.v.shape == (1, 5)
        assert boxes.nda.v[0, 4] == np.float32(0.98)


def test_nda_wire_roundtrip_and_a_jax_peer(tmp_path):
    """send_nda/recv_nda between two port sockets, then from a JAX
    sender to a port receiver (one wire format)."""
    import zmq

    from boda_tpu.apps.zmq_serve import send_nda as jsend_nda
    from boda_tpu.core.dims import NDA as JNDA, Dims as JDims
    from boda_tpu_torch.apps.zmq_serve import recv_nda, send_nda
    ctx = zmq.Context()
    a = ctx.socket(zmq.PAIR)
    b = ctx.socket(zmq.PAIR)
    ep = _ep(tmp_path, "pair")
    a.bind(ep)
    b.connect(ep)
    v = np.arange(12, dtype=np.float32).reshape(3, 4)
    nda = NDA(Dims.make(tn="float", y=3, x=4), v)
    send_nda(a, nda)
    got = recv_nda(b)
    assert got.dims == nda.dims
    np.testing.assert_array_equal(got.v, nda.v)
    jsend_nda(a, JNDA(JDims.make(tn="float", y=3, x=4), v))
    got = recv_nda(b)
    assert got.dims == nda.dims
    np.testing.assert_array_equal(got.v, v)
    a.close()
    b.close()
    ctx.term()


def _boxes(out):
    return [[float(t.split("=")[1]) for t in ln.split()[1:]]
            for ln in out.splitlines() if ln.startswith("box:")]


def _serve_and_ask(tmp_path, capsys, spec, run, img_fn):
    ep = _ep(tmp_path, f"real_{abs(hash(spec))}")
    t = _serve_in_thread(f"({spec},endpoint={ep},num_req=1)", run)
    create_and_run_has_main(
        f"(mode=zmq_det_client,endpoint={ep},image_fn={img_fn})", {})
    t.join(timeout=120)
    assert not t.is_alive()
    return _boxes(capsys.readouterr().out)


def _test_image(tmp_path):
    pytest.importorskip("PIL")
    from boda_tpu_torch.io.img import make_test_pattern_img, save_img
    img_fn = tmp_path / "in.png"
    save_img(img_fn, make_test_pattern_img(96, 80, 2))
    return img_fn


def test_zmq_det_server_against_jax(tmp_path, capsys):
    """The real pyramid dense-inference service of each package on the
    same image: >= 1 box in client-image coordinates, the same boxes,
    confidences within 1e-4."""
    img_fn = _test_image(tmp_path)
    spec = ("mode=zmq_det_server,model=mini,out_node=conv2,in_sz=48,"
            "bin_sz=96,min_sz=24,filt_show_thresh=0.05")
    want = _serve_and_ask(tmp_path, capsys, spec,
                          jhas_main.create_and_run_has_main, img_fn)
    got = _serve_and_ask(tmp_path, capsys,
                         f"{spec},conv_fwd=(engine=torch,device=cpu,"
                         f"keep_all_nodes=1)", create_and_run_has_main,
                         img_fn)
    assert got and len(got) == len(want)
    np.testing.assert_array_equal(np.array(got)[:, :4], np.array(want)[:, :4])
    np.testing.assert_allclose(np.array(got)[:, 4], np.array(want)[:, 4],
                               rtol=0, atol=TOL)
    for x, y, w, h, _c in got:  # coords scaled back to the 96x80 image
        assert 0 < w <= 80 + 1


def test_zmq_cls_server_against_the_jax_engine(tmp_path, capsys):
    """zmq_cls_server's top-k rows (class in the X slot, the net's input
    size as W and H, the probability as confidence) against the JAX
    engine's forward of the same decoded image. The JAX package's own
    zmq_cls_server answers every encoded image with a 0-box error reply
    (it wraps img_to_batch's NDA in a second NDA); the port unwraps it."""
    from boda_tpu.core.dims import NDA as JNDA
    from boda_tpu.engine.iface import make_engine as jmake_engine
    from boda_tpu.io.img import img_to_batch as jimg_to_batch, load_img
    from boda_tpu.models.zoo import build_model as jbuild_model
    img_fn = _test_image(tmp_path)
    got = _serve_and_ask(tmp_path, capsys,
                         f"mode=zmq_cls_server,model=mini,in_sz=32,top_k=3,"
                         f"conv_fwd={CPU}", create_and_run_has_main, img_fn)
    pipe = jbuild_model("mini", batch=1, ysz=32, xsz=32)
    eng = jmake_engine("(engine=rtc,fuse=1)")
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    blob = jimg_to_batch(load_img(img_fn), d)
    p = np.asarray(eng.run_fwd({"data": JNDA(d, blob.v)}, ["prob"])["prob"]
                   .v).reshape(-1)
    ix = np.argsort(-p)[:3]
    assert len(got) == 3
    g = np.array(got)
    np.testing.assert_array_equal(g[:, 0], ix)
    np.testing.assert_array_equal(g[:, 1:4], [[0, 32, 32]] * 3)
    np.testing.assert_allclose(g[:, 4], p[ix], rtol=0, atol=TOL)


def test_zmq_detect_error_gives_a_zero_box_reply(tmp_path, capsys):
    """An engine error is answered with a 0-box reply and printed; the
    service stays up for the next request (zmq_serve.py:101-106)."""
    ep = _ep(tmp_path, "err")
    bad = tmp_path / "not_an_image.bin"
    bad.write_bytes(b"\x00\x01" * 8)
    t = _serve_in_thread(f"(mode=zmq_cls_server,endpoint={ep},num_req=2,"
                         f"model=mini,in_sz=32,conv_fwd={CPU})")
    create_and_run_has_main(
        f"(mode=zmq_det_client,endpoint={ep},image_fn={bad},num_iter=2)", {})
    t.join(timeout=60)
    assert not t.is_alive()
    out = capsys.readouterr().out
    assert out.count("detect error: failed to decode image bytes") == 2
    assert "box:" not in out


def test_require_zmq_raises_without_pyzmq(monkeypatch):
    import sys

    from boda_tpu_torch.apps import zmq_serve
    monkeypatch.setitem(sys.modules, "zmq", None)
    with pytest.raises(RtErr, match="pyzmq not available"):
        zmq_serve._require_zmq()
