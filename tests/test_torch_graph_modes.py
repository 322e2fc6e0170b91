"""The port's net-analysis and net-surgery modes (graph/modes.py) against
the JAX package's, on the CPU: conv_ana, cnet_ana and cnet_bpt_dump print
the same text; cnet_copy, cnet_fc_to_conv, cnet_resize_conv and cnet_util
write the same prototxt text and the same caffemodel bytes (so blobs are
numpy-equal); cnet_util's identity conv leaves the port's forward
(engine=torch) within 1e-6 (tests/test_graph.py's twin on the JAX
engine=ref)."""

import contextlib
import io

import numpy as np
import pytest

from boda_tpu.core.has_main import create_and_run_has_main as jrun
from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.core.has_main import create_and_run_has_main
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.graph.caffe_io import read_model
from boda_tpu_torch.models.zoo import build_model

# a net with InnerProduct layers, for cnet_fc_to_conv
FC_NET = """name: "fcnet"
input: "data"
input_dim: 2
input_dim: 3
input_dim: 16
input_dim: 16
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 stride: 2 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "fc6" type: "InnerProduct" bottom: "conv1" top: "fc6"
  inner_product_param { num_output: 16 } }
layer { name: "fc7" type: "InnerProduct" bottom: "fc6" top: "fc7"
  inner_product_param { num_output: 10 } }
layer { name: "prob" type: "Softmax" bottom: "fc7" top: "prob" }
"""


def _out(run, spec: str) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(spec)
    return buf.getvalue()


def _both(spec: str, tmp_path) -> tuple[str, str]:
    """The port's and the JAX mode's stdout for the same spec, each writing
    into a directory of its own (a relative path in the text is the same)."""
    outs = []
    for name, run in (("port", create_and_run_has_main), ("jax", jrun)):
        outs.append(_out(run, f"({spec},boda_output_dir={tmp_path / name})"))
    return outs[0], outs[1]


def _caffemodel(tmp_path):
    """mini's prototxt and caffemodel, written by the JAX cnet_copy: both
    packages then load the same weights."""
    _out(jrun, f"(mode=cnet_copy,model=mini,out_ptt_fn=mini.prototxt,"
               f"out_trained_fn=mini.caffemodel,boda_output_dir={tmp_path})")
    return tmp_path / "mini.prototxt", tmp_path / "mini.caffemodel"


def _same_files(tmp_path, *names) -> None:
    """The port's and the JAX mode's output files are byte-equal (so a
    caffemodel's blobs are numpy-equal)."""
    for n in names:
        p, j = tmp_path / "port" / n, tmp_path / "jax" / n
        assert p.read_bytes() == j.read_bytes() and p.read_bytes()


@pytest.mark.parametrize("model", ["mini", "resnet-50"])
@pytest.mark.parametrize("mode", ["conv_ana", "cnet_ana"])
def test_analysis_text_as_the_jax_mode(mode, model, tmp_path):
    extra = ",dump_ops=1" if mode == "conv_ana" else ""
    out, jout = _both(f"mode={mode},model={model}{extra}", tmp_path)
    assert out == jout and len(out.splitlines()) > 5


def test_bpt_dump_text_as_the_jax_mode(tmp_path):
    ptt, cm = _caffemodel(tmp_path)
    out, jout = _both(f"mode=cnet_bpt_dump,ptt_fn={ptt},trained_fn={cm}",
                      tmp_path)
    assert out == jout and "blob conv1_filts: out_chan:16" in out


def test_cnet_copy_as_the_jax_mode(tmp_path):
    ptt, cm = _caffemodel(tmp_path)
    out, jout = _both(f"mode=cnet_copy,ptt_fn={ptt},trained_fn={cm},"
                      f"out_ptt_fn=c.prototxt,out_trained_fn=c.caffemodel",
                      tmp_path)
    assert out == jout
    _same_files(tmp_path, "c.prototxt", "c.caffemodel")


def test_cnet_fc_to_conv_as_the_jax_mode(tmp_path):
    (tmp_path / "fc.prototxt").write_text(FC_NET)
    _out(jrun, f"(mode=cnet_copy,ptt_fn={tmp_path / 'fc.prototxt'},"
               f"out_ptt_fn=fcw.prototxt,out_trained_fn=fcw.caffemodel,"
               f"boda_output_dir={tmp_path})")
    out, jout = _both(f"mode=cnet_fc_to_conv,ptt_fn={tmp_path}/fc.prototxt,"
                      f"trained_fn={tmp_path}/fcw.caffemodel,"
                      f"out_ptt_fn=conv.prototxt,"
                      f"out_trained_fn=conv.caffemodel", tmp_path)
    assert out == jout
    _same_files(tmp_path, "conv.prototxt", "conv.caffemodel")
    txt = (tmp_path / "port" / "conv.prototxt").read_text()
    assert "InnerProduct" not in txt and txt.count("Convolution") == 3


def test_cnet_resize_conv_as_the_jax_mode(tmp_path):
    ptt, cm = _caffemodel(tmp_path)
    out, jout = _both(f"mode=cnet_resize_conv,ptt_fn={ptt},trained_fn={cm},"
                      f"layer=conv1,new_kern_sz=3 3,"
                      f"out_trained_fn=r.caffemodel", tmp_path)
    assert out == jout and "(5, 5) -> (3, 3)" in out
    _same_files(tmp_path, "r.caffemodel")


def test_cnet_util_identity_conv_keeps_the_forward(tmp_path):
    ptt, cm = _caffemodel(tmp_path)
    out, jout = _both(f"mode=cnet_util,ptt_fn={ptt},trained_fn={cm},"
                      f"add_before_ln=conv2,out_ptt_fn=u.prototxt,"
                      f"out_trained_fn=u.caffemodel", tmp_path)
    assert out == jout and "inserted identity conv" in out
    _same_files(tmp_path, "u.prototxt", "u.caffemodel")
    orig = read_model(str(ptt), str(cm))
    mod = read_model(str(tmp_path / "port" / "u.prototxt"),
                     str(tmp_path / "port" / "u.caffemodel"),
                     in_dims=orig.get_data_img_dims())
    assert "conv2_pre_ident" in mod.ops
    d = orig.get_data_img_dims()
    x = NDA(d, np.random.RandomState(0).randn(*d.shape).astype(np.float32))
    probs = []
    for pipe in (orig, mod):
        eng = make_engine("(engine=torch,device=cpu)")
        eng.init(pipe)
        probs.append(eng.run_fwd({"data": x}, ["prob"])["prob"].v)
    np.testing.assert_allclose(probs[1], probs[0], rtol=0, atol=1e-6)


def test_zoo_weights_equal_across_packages():
    """The zoo's weights are made alike in both packages (cnet_copy's
    caffemodels agree without a shared input)."""
    from boda_tpu.models.zoo import build_model as jbuild_model
    p, j = build_model("mini"), jbuild_model("mini")
    assert sorted(p.op_params) == sorted(j.op_params)
    for n in p.op_params:
        np.testing.assert_array_equal(p.op_params[n].v, j.op_params[n].v)
