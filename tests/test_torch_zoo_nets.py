"""The zoo's concat, LRN and deconv nets through the port's engine on the
CPU against the JAX engine (engine=rtc, its Pallas templates on their jnp
fallback), on the same seeded weights and inputs: the incep_micro net of
tests/test_storage.py (Concat, LRN, dropout), deconv-tiny.prototxt,
squeezenet-1.0 and googlenet_conv_lrn at 64x64 and alexnet_ng_conv at its
full 227x227 (fc6-conv's 6x6 kernel needs it), batch 1, each under the f32
tune () and the bf16 NHWC-storage tune; the fused executor against the
per-call mode (fuse=0) on the concat nets, under () and the vendor f32
tune; the INOUT first touch of
build_forward; the stats of a concat node, written once per member, in
both executors; the trained 40-class GoogLeNet snapshot
(tests/data/googlenet-shapes40.boda) on four held-out shapes-src images;
and the cnet_bench mode's line and int8 sites on the CPU.

Tolerances (testing/comp.comp_digests, mrd over every node): 5e-4 under
() (the repo's cross-engine default), 5e-3 under bf16 NHWC storage (its
bf16 mrd_toler) with bf16-exact weights; the fused and per-call executors
bit-equal; stats within rtol 1e-5 of the JAX engine's; the trained
GoogLeNet's prob within mrd 5e-4 of the JAX engine's, with the same top-1
for every image.
"""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from boda_tpu.core import dims as jdims
from boda_tpu.engine import iface as jiface
from boda_tpu.graph import caffe_io as jcaffe_io
from boda_tpu.models import zoo as jzoo
from boda_tpu.ops.pallas import gen_data as jgen_data
from boda_tpu_torch.core.digest import nda_digest
from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.engine.lower import lower_pipe
from boda_tpu_torch.engine.torch_fwd import build_forward, produced_nodes, \
    weights_to_torch
from boda_tpu_torch.graph import caffe_io
from boda_tpu_torch.models import zoo
from boda_tpu_torch.ops.cnn_variants import make_op_tune
from boda_tpu_torch.ops.cuda.gen_data import gen_test_nda
from boda_tpu_torch.testing.comp import comp_digests

DATA = Path(__file__).parent / "data"
TUNES = {"f32": ("()", 5e-4), "bf16-nhwc": ("(prec=bf16,layout=nhwc)", 5e-3)}
# each package's zoo, caffe reader, engine factory, NDA and test pattern
PORT = (zoo, caffe_io, make_engine, NDA, gen_test_nda)
JAX = (jzoo, jcaffe_io, jiface.make_engine, jdims.NDA, jgen_data.gen_test_nda)


@pytest.fixture(autouse=True)
def _jnp_fallback(monkeypatch):
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")


def incep_micro(pkg=PORT):
    """tests/test_storage.py's incep_micro (Concat, LRN and dropout at toy
    scale), built with either package's NetBuilder."""
    b = pkg[0].NetBuilder("incep_micro", 2, 3, 32, 32)
    b.conv("conv1", 16, 3, 2, 1)
    b.lrn("lrn1")
    stem = b.cur
    b.conv("i1_a", 8, 1)
    ba = b.cur
    b.cur = stem
    b.conv("i1_b", 8, 3, 1, 1)
    b.concat("i1_cat", [ba, b.cur])
    b.pool("pool1", 3, 2)
    b.dropout("drop1")
    b.conv("fc", 10, 1, relu=False)
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.softmax("prob")
    return b.done(seed=11)


def _deconv_tiny(pkg=PORT):
    pipe = pkg[1].read_model(str(DATA / "nets" / "deconv-tiny.prototxt"))
    pkg[0].init_pipe_weights(pipe)
    return pipe


NETS = {
    "incep_micro": incep_micro,
    "deconv-tiny": _deconv_tiny,
    "squeezenet-1.0": lambda pkg=PORT: pkg[0].build_model(
        "squeezenet-1.0", batch=1, ysz=64, xsz=64),
    "googlenet_conv_lrn": lambda pkg=PORT: pkg[0].build_model(
        "googlenet_conv_lrn", batch=1, ysz=64, xsz=64),
    "alexnet_ng_conv": lambda pkg=PORT: pkg[0].build_model(
        "alexnet_ng_conv", batch=1),
}
# the templates each net must reach under ()
NET_TEMPLATES = {"incep_micro": {"copy", "lrn", "dropout"},
                 "deconv-tiny": {"deconv"},
                 "squeezenet-1.0": {"copy", "k1conv", "conv"},
                 "googlenet_conv_lrn": {"copy", "lrn", "k1conv", "conv",
                                        "tconv", "ipconv"},
                 "alexnet_ng_conv": {"lrn", "conv", "tconv", "ipconv"}}
CONCAT_NETS = ["incep_micro", "squeezenet-1.0", "googlenet_conv_lrn"]


def _bf16_exact(pipe):
    for v in pipe.op_params.values():
        v.v[...] = torch.from_numpy(v.v).bfloat16().float().numpy()


def _all_nodes(pipe):
    return [n for n, nd in pipe.nodes.items()
            if nd.dims is not None and nd.top_for]


def _run(pipe, spec, pkg=PORT):
    """Engine `spec` of package `pkg` on a seeded input; every node of the
    pipe that its plan produces."""
    make, nda, pattern = pkg[2:]
    eng = make(spec)
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    blob = nda(d, pattern(d, 0, 0.1))
    return eng, eng.run_fwd({pipe.data_img_node_names[0]: blob},
                            [n for n in _all_nodes(pipe)
                             if n in produced_nodes(eng.plan)])


def _kg(jouts, pipe):
    """Digests of the JAX engine's outputs under the port pipe's dims."""
    return {n: nda_digest(NDA(pipe.nodes[n].dims, np.asarray(v.v)))
            for n, v in jouts.items()}


@pytest.mark.parametrize("tune", list(TUNES))
@pytest.mark.parametrize("net", list(NETS))
def test_zoo_net_matches_jax_engine(net, tune):
    op_tune, toler = TUNES[tune]
    pipe, jpipe = NETS[net](), NETS[net](JAX)
    if tune == "bf16-nhwc":
        # bf16-exact weights: the JAX matmul keeps an f32 weight beside a
        # bf16 activation on the CPU, the port rounds it
        # (tests/test_torch_engine.py)
        _bf16_exact(pipe)
        _bf16_exact(jpipe)
    teng, touts = _run(pipe, f"(engine=torch,device=cpu,keep_all_nodes=1,"
                             f"op_tune={op_tune})")
    _, jouts = _run(jpipe, f"(engine=rtc,keep_all_nodes=1,"
                           f"op_tune={op_tune})", JAX)
    funcs = {s.func_name for s in teng.plan.steps}
    if tune == "f32":
        assert NET_TEMPLATES[net] <= funcs
    assert teng.plan.storage_nhwc == (tune == "bf16-nhwc")
    assert sorted(touts) == sorted(jouts)
    errs = comp_digests(touts, _kg(jouts, pipe), toler)
    assert not errs, errs


@pytest.mark.parametrize("op_tune", ["()", "(use_culibs=1)"])
@pytest.mark.parametrize("net", CONCAT_NETS)
def test_concat_net_fused_equals_per_call(net, op_tune):
    # the hand kernels' plain versions, and the vendor convs; both
    # executors run NCHW f32 edges under these tunes
    pipe = NETS[net]()
    feng, fouts = _run(pipe, f"(engine=torch,device=cpu,keep_all_nodes=1,"
                             f"op_tune={op_tune})")
    peng, pouts = _run(pipe, f"(engine=torch,device=cpu,fuse=0,"
                             f"op_tune={op_tune})")
    assert not feng.plan.storage_nhwc and not peng.plan.storage_nhwc
    assert sorted(fouts) == sorted(pouts)
    concats = {s.arg_nodes["out"] for s in peng.plan.steps
               if s.func_name == "copy"}
    assert concats and concats <= set(pouts)
    for n in fouts:
        np.testing.assert_array_equal(fouts[n].v, pouts[n].v, err_msg=n)
    # a second forward on the per-call vars gives the same concat values
    d = pipe.get_data_img_dims()
    again = peng.run_fwd({pipe.data_img_node_names[0]:
                          NDA(d, gen_test_nda(d, 0, 0.1))}, sorted(concats))
    for n in concats:
        np.testing.assert_array_equal(again[n].v, pouts[n].v)


@pytest.mark.parametrize("tune", list(TUNES))
def test_inout_first_touch_is_zeros_in_storage_form(tune):
    pipe = incep_micro()
    plan = lower_pipe(pipe, make_op_tune(TUNES[tune][0]), fuse_relu=True,
                      fused_storage=True)
    dev = torch.device("cpu")
    weights = weights_to_torch(plan, pipe.op_params, dev)
    fwd = build_forward(plan, dev)
    first: dict = {}

    def write_hook(node, v):
        if node == "i1_cat" and node not in first:
            first[node] = v.clone()

    d = pipe.get_data_img_dims()
    x = torch.from_numpy(gen_test_nda(d, 0, 0.1))
    out1 = fwd({"data": x}, weights, out_nodes=["i1_cat"],
               write_hook=write_hook)["i1_cat"].clone()
    # the buffer the first member's copy wrote into: its own channels set,
    # the second member's still zero, in the storage form
    cat = first["i1_cat"]
    nhwc = plan.storage_nhwc
    assert nhwc == (tune == "bf16-nhwc")
    assert tuple(cat.shape) == (2, 16, 16, 16)  # 16 chans of 16x16
    assert cat.dtype == (torch.bfloat16 if tune == "bf16-nhwc"
                         else torch.float32)
    second = cat[..., 8:] if nhwc else cat[:, 8:]
    assert not second.any() and (cat[..., :8] if nhwc else cat[:, :8]).any()
    # a fresh buffer each forward: a second forward on another input
    # leaves the first result as it was
    out2 = fwd({"data": -x}, weights, out_nodes=["i1_cat"])["i1_cat"]
    assert not torch.equal(out1, out2)
    out3 = fwd({"data": x}, weights, out_nodes=["i1_cat"])["i1_cat"]
    assert torch.equal(out1, out3)


def test_missing_weight_still_raises():
    pipe = incep_micro()
    plan = lower_pipe(pipe, make_op_tune("()"), fuse_relu=True,
                      fused_storage=True)
    dev = torch.device("cpu")
    weights = weights_to_torch(plan, pipe.op_params, dev)
    weights.pop("i1_b_filts")
    d = pipe.get_data_img_dims()
    with pytest.raises(RtErr, match=r"weight node 'i1_b_filts' .* missing "
                                    r"from the weights dict \(resolve_plan_"
                                    r"weights on THIS plan\)"):
        build_forward(plan, dev)({"data": torch.from_numpy(
            gen_test_nda(d, 0, 0.1))}, weights)


def test_trained_googlenet_matches_jax_engine():
    """The trained 40-class snapshot on four held-out images (the shapes
    source the smoke's cls_agree reads: start 100000, seed 1, mean 128,
    scale 1/64) at 224x224 through both engines under ()."""
    from boda_tpu_torch.apps.train import load_weights_into_pipe
    from boda_tpu_torch.io.synth import render_shapes
    from boda_tpu.apps.train import load_weights_into_pipe as jload
    fn = str(DATA / "googlenet-shapes40.boda")
    n = 4
    imgs, labels = render_shapes(range(100000, 100000 + n), 224, 224, 40, 1)
    x = ((imgs.astype(np.float32) - 128.0) * 0.015625)
    probs = []
    for pkg, load, spec in ((PORT, load_weights_into_pipe,
                             "(engine=torch,device=cpu)"),
                            (JAX, jload, "(engine=rtc)")):
        pipe = pkg[0].build_model("googlenet_conv", batch=n, num_classes=40)
        with contextlib.redirect_stdout(io.StringIO()):
            load(pipe, fn)
        eng = pkg[2](spec)
        eng.init(pipe)
        top = pipe.get_single_top_node().name
        d = pipe.get_data_img_dims()
        probs.append(eng.run_fwd({pipe.data_img_node_names[0]:
                                  pkg[3](d, np.ascontiguousarray(x))},
                                 [top])[top].v.reshape(n, -1))
    got, want = probs
    assert np.abs(got - want).max() / np.abs(want).max() <= 5e-4
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert (got.argmax(1) == labels).sum() >= 3, (got.argmax(1), labels)


def test_cnet_bench_line_and_int8_sites():
    """cnet_bench through the CLI on the CPU: GoogLeNet with int8 at its
    site set (the 18 inception 3x3 and 5x5 convs) and the static scales of
    tests/data/googlenet-b128-int8-scales.lexp; the line has the JAX
    line's keys, and the engine's plan carries every site's scale."""
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    q = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1,quant8=1)"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        hm = create_and_run_has_main(
            f"(mode=cnet_bench,model=googlenet_conv,batch=2,"
            f"model_opts=(ysz=64,xsz=64),conv_fwd=(engine=torch,device=cpu),"
            f"iters=1,reps=2,"
            f"op_tunes_pat=(inception_.*/[35]x[35]={q}),"
            f"act_scales_fn={DATA / 'googlenet-b128-int8-scales.lexp'})", {})
    (line,) = [ln for ln in buf.getvalue().splitlines()
               if ln.startswith("cnet_bench ")]
    head, tail = line.split(": ", 1)
    assert head == "cnet_bench googlenet_conv b2 bf16 storage=nhwc"
    keys = [kv.split("=")[0] for kv in tail.split()]
    assert keys == ["step_ms", "imgs_per_sec", "tflops", "frac_roofline",
                    "compile_s", "device"]
    # no share of a peak on the host clock
    assert "frac_roofline=n/a " in tail and tail.endswith("device=cpu")
    assert hm.forwards == 3 and hm.step_ms > 0
    q8 = [s for s in hm.eng.plan.steps if s.sig.get_u32_or("quant8", 0)]
    assert len(q8) == 18
    assert all("act_scale" in s.sig.nda_vals for s in q8)
    assert {s.call_tag for s in hm.eng.plan.steps if s.func_name == "copy"}


def test_cnet_bench_takes_its_device_from_a_torch_engine():
    """cnet_bench runs on its conv_fwd engine, which must be engine=torch:
    engine=ref has no tune or device to bench."""
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    with pytest.raises(RtErr, match="conv_fwd must be engine=torch"), \
            contextlib.redirect_stdout(io.StringIO()):
        create_and_run_has_main(
            "(mode=cnet_bench,model=mini,batch=1,conv_fwd=(engine=ref),"
            "iters=1,reps=1)", {})


@pytest.mark.parametrize("fuse", [1, 0])
def test_concat_stats_match_jax_engine(fuse):
    """enable_stats on a concat net: a concat node is written once per
    member. The fused executors take its stats after the last write (the
    whole concat), the per-call ones after the first (one member in a
    zeroed buffer), in both packages; all within rtol 1e-5 of the JAX
    engine's (f32 sums in another order)."""
    spec = f"fuse={fuse},enable_stats=1,keep_all_nodes=1"
    eng, outs = _run(incep_micro(), f"(engine=torch,device=cpu,{spec})")
    jeng, _ = _run(incep_micro(JAX), f"(engine=rtc,{spec})", JAX)
    assert set(eng.stats) == set(jeng.stats) and "i1_cat" in eng.stats
    for n, v in eng.stats.items():
        np.testing.assert_allclose(v.v, np.asarray(jeng.stats[n].v),
                                   rtol=1e-5, atol=1e-30, err_msg=n)
    cat = outs["i1_cat"].v.astype(np.float64)
    whole = [cat.min(), cat.max(), cat.mean(), (cat * cat).sum()]
    first = cat.copy()
    first[:, 8:] = 0  # the first member's 8 channels, the rest still zero
    part = [first.min(), first.max(), first.mean(), (first * first).sum()]
    np.testing.assert_allclose(eng.stats["i1_cat"].v,
                               whole if fuse else part, rtol=1e-5)
