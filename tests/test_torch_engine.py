"""The whole slice: TorchFwd (engine=torch) on the CPU against the JAX
engine (engine=rtc, fallback mode) under the unfused and the fused
(fuse_stem, fuse_resblock) tunes and against the per-node digests recorded
on a TPU, plus weights_to_torch, the forward's input checks, the nodes a
fused plan no longer produces, and run_cnet driven through the normal
entry point.

Tolerances (testing/comp.comp_digests, mrd over every node): 5e-4 for the
f32 tune (the repo's cross-engine default and the `mini` TPU archive's),
5e-3 for the bf16 NHWC-storage tune (the repo's bf16 mrd_toler).
"""

import contextlib
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from boda_tpu.core import dims as jdims
from boda_tpu.core import has_main as jhas_main
from boda_tpu.engine import iface as jiface
from boda_tpu.models import zoo as jzoo
from boda_tpu.ops.pallas import gen_data as jgen_data
from boda_tpu_torch.core.digest import nda_digest
from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.has_main import create_and_run_has_main
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.engine.lower import lower_pipe, resolve_plan_weights
from boda_tpu_torch.engine.torch_fwd import build_forward, produced_nodes, \
    weights_to_torch
from boda_tpu_torch.models import zoo
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.cnn_variants import make_op_tune
from boda_tpu_torch.ops.cuda.gen_data import gen_test_nda
from boda_tpu_torch.testing.comp import comp_digests, read_digest_stream

ARCHIVE = Path(__file__).parent / "data" / "tpu_digests"
TUNES = {"f32": ("()", 5e-4), "bf16-nhwc": ("(prec=bf16,layout=nhwc)", 5e-3)}
SLICE_STEPS = {"s2d_conv": 1, "pool": 2, "k1conv": 2, "conv": 1, "tconv": 1,
               "eltwise": 1, "relu": 1, "ipconv": 1, "softmax": 1}
FUSED = "fuse_stem=1,fuse_resblock=1"
FUSED_TUNES = {"f32": (f"({FUSED})", 5e-4),
               "bf16-nhwc": (f"(prec=bf16,layout=nhwc,{FUSED})", 5e-3)}
FUSED_SLICE_STEPS = {"fused_stem": 1, "resblock": 1, "pool": 1, "ipconv": 1,
                     "softmax": 1}
# each package's zoo, engine factory, NDA and test pattern: a net is built,
# and run, in one package; both builds draw the same seeded weights
PORT = (zoo, make_engine, NDA, gen_test_nda)
JAX = (jzoo, jiface.make_engine, jdims.NDA, jgen_data.gen_test_nda)


def build_slice_net(batch=2, pkg=PORT):
    """A small net that reaches every template of the ResNet-50 path:
    s2d_conv (7x7/s2, C=3), a ceil-mode max pool, k1conv at stride 1 and
    2, conv (3x3, C=16), tconv (3x3, C=128), eltwise + relu, a global
    average pool, ipconv (fc) and softmax."""
    b = pkg[0].NetBuilder("slice", batch, 3, 32, 32)
    b.conv("conv1", 16, 7, 2, 3).pool("pool1", 3, 2)
    b.conv("c1x1", 16, 1).conv("c3x3", 16, 3, 1, 1)
    b.conv("proj", 128, 1, 2, relu=False)
    proj = b.cur
    b.conv("t3x3", 128, 3, 1, 1, relu=False)
    b.eltwise("sum", [proj, b.cur]).relu("sum_relu")
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.conv("fc", 10, 1, relu=False).softmax("prob")
    return b.done(seed=7)


def build_fused_slice_net(batch=2, pkg=PORT):
    """A small net for the fused tunes: a 7x7/s2 stem with a ceil-mode max
    pool (fused_stem), one identity bottleneck with C=16, Cm=8 (resblock),
    a global average pool, an fc and softmax."""
    b = pkg[0].NetBuilder("fused_slice", batch, 3, 32, 32)
    b.conv("conv1", 16, 7, 2, 3).pool("pool1", 3, 2)
    shortcut = b.cur
    b.conv("res_a", 8, 1).conv("res_b", 8, 3, 1, 1)
    b.conv("res_c", 16, 1, relu=False)
    b.eltwise("res_sum", [shortcut, b.cur]).relu("res_relu")
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.conv("fc", 10, 1, relu=False).softmax("prob")
    return b.done(seed=7)


def _bf16_exact(pipe):
    for v in pipe.op_params.values():
        v.v[...] = torch.from_numpy(v.v).bfloat16().float().numpy()


def _step_counts(plan):
    steps = {}
    for s in plan.steps:
        steps[s.func_name] = steps.get(s.func_name, 0) + 1
    return steps


def _all_nodes(pipe):
    return [n for n, nd in pipe.nodes.items()
            if nd.dims is not None and nd.top_for]


def _kg(jouts, pipe):
    """Digests of the JAX engine's outputs, as the port's digests of the
    same arrays under the port pipe's dims of each node."""
    return {n: nda_digest(NDA(pipe.nodes[n].dims, np.asarray(v.v)))
            for n, v in jouts.items()}


def _run(pipe, spec, pkg=PORT, produced=None):
    """Run engine `spec` of package `pkg` on a seeded input; fetch every
    node of the pipe that its plan produces (a fused plan drops its fused
    ops' interiors; `produced` gives that set for a JAX engine)."""
    _zoo, make, nda, pattern = pkg
    eng = make(spec)
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    blob = nda(d, pattern(d, 0, 0.1))
    if produced is None:
        produced = produced_nodes(eng.plan)
    return eng, eng.run_fwd({pipe.data_img_node_names[0]: blob},
                            [n for n in _all_nodes(pipe) if n in produced])


@pytest.mark.parametrize("tune", list(TUNES))
def test_slice_net_matches_jax_engine(monkeypatch, tune):
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")
    op_tune, toler = TUNES[tune]
    pipe, jpipe = build_slice_net(), build_slice_net(pkg=JAX)
    if tune == "bf16-nhwc":
        # bf16-exact weights: with a bf16 activation the JAX matmul keeps
        # an f32 weight as it is (sgemm.py:181-183) and the CPU multiplies
        # in f32, while a TPU at DEFAULT precision and the port round it
        # to bf16; exact weights compare the two engines on equal operands
        _bf16_exact(pipe)
        _bf16_exact(jpipe)
    teng, touts = _run(pipe, f"(engine=torch,device=cpu,keep_all_nodes=1,"
                             f"op_tune={op_tune})")
    jeng, jouts = _run(jpipe, f"(engine=rtc,keep_all_nodes=1,op_tune={op_tune})",
                       JAX)
    assert _step_counts(teng.plan) == SLICE_STEPS
    assert teng.plan.storage_nhwc == (tune == "bf16-nhwc")
    assert sorted(touts) == sorted(jouts)
    kg = _kg(jouts, pipe)
    errs = comp_digests(touts, kg, toler)
    assert not errs, errs


@pytest.mark.parametrize("tune", list(FUSED_TUNES))
def test_fused_slice_net_matches_jax_engine(monkeypatch, tune):
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")
    op_tune, toler = FUSED_TUNES[tune]
    pipe, jpipe = build_fused_slice_net(), build_fused_slice_net(pkg=JAX)
    if tune == "bf16-nhwc":
        # bf16-exact weights and biases: the JAX whole-net path runs the
        # resblock's fallback, which adds the bias unrounded
        # (resblock.py:61-64), while the port follows the Pallas kernel
        # body, which rounds it to bf16 like the weights (:171-177)
        _bf16_exact(pipe)
        _bf16_exact(jpipe)
    teng, touts = _run(pipe, f"(engine=torch,device=cpu,keep_all_nodes=1,"
                             f"op_tune={op_tune})")
    # the JAX engine asked for the nodes the port's plan produces
    jeng, jouts = _run(jpipe, f"(engine=rtc,keep_all_nodes=1,op_tune={op_tune})",
                       JAX, produced_nodes(teng.plan))
    assert _step_counts(teng.plan) == FUSED_SLICE_STEPS
    assert teng.plan.storage_nhwc == (tune == "bf16-nhwc")
    # the fused ops' interior nodes are produced by neither engine
    assert sorted(touts) == sorted(jouts)
    assert not {"conv1", "res_a", "res_b", "res_c"} & set(touts)
    kg = _kg(jouts, pipe)
    errs = comp_digests(touts, kg, toler)
    assert not errs, errs


def test_resnet50_culibs_fused_matches_jax_engine(monkeypatch):
    # the JAX package's own fusion gates (tests/test_resblock.py:178-198,
    # tests/test_stem.py:85-96) under the use_culibs=1 tune, whose
    # unfused convs are the vendor xla_conv (cuDNN in the port)
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")
    pipe = build_model("resnet-50", batch=1, ysz=64, xsz=64)
    jpipe = jzoo.build_model("resnet-50", batch=1, ysz=64, xsz=64)
    tune = f"(use_culibs=1,{FUSED},s2d=0)"
    teng, touts = _run(pipe, f"(engine=torch,device=cpu,keep_all_nodes=1,"
                             f"op_tune={tune})")
    _, jouts = _run(jpipe, f"(engine=rtc,keep_all_nodes=1,op_tune={tune})",
                    JAX, produced_nodes(teng.plan))
    steps = _step_counts(teng.plan)
    assert (steps["resblock"], steps["fused_stem"], steps["xla_conv"]) \
        == (12, 1, 17)
    assert sorted(touts) == sorted(jouts)
    kg = _kg(jouts, pipe)
    errs = comp_digests(touts, kg, 5e-4)
    assert not errs, errs


def test_run_fwd_refuses_nodes_removed_by_fusion():
    pipe = build_fused_slice_net()
    eng = make_engine(f"(engine=torch,device=cpu,op_tune=({FUSED}))")
    eng.init(pipe)
    assert produced_nodes(eng.plan) == {"data", "pool1", "res_sum", "gpool",
                                        "fc", "prob"}
    d = pipe.get_data_img_dims()
    blob = NDA(d, gen_test_nda(d, 0, 0.1))
    got = eng.run_fwd({"data": blob}, ["pool1", "res_sum", "prob"])
    assert got["res_sum"].v.shape == (2, 16, 8, 8)
    with pytest.raises(RtErr, match=r"\['res_b'\] are not produced by any "
                                    r"step \(eliminated by fusion\?\)"):
        eng.run_fwd({"data": blob}, ["res_b", "prob"])


def test_mini_matches_tpu_digest_archive():
    kg = read_digest_stream(ARCHIVE / "mini" / "digest-rtc.boda")
    _, outs = _run(build_model("mini", batch=1),
                   "(engine=torch,device=cpu,keep_all_nodes=1)")
    assert [k for k in kg if k not in outs] == []
    errs = comp_digests(outs, kg, 5e-4, ignore_missing=True)
    assert not errs, errs


def test_run_fwd_serves_weights_and_refuses_unknown_nodes():
    pipe = build_model("mini", batch=1)
    eng = make_engine("(engine=torch,device=cpu)")
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    blob = NDA(d, gen_test_nda(d, 0, 0.1))
    got = eng.run_fwd({"data": blob}, ["conv1_filts", "conv2", "prob"])
    np.testing.assert_array_equal(got["conv1_filts"].v,
                                  pipe.op_params["conv1_filts"].v)
    assert got["conv2"].v.shape == tuple(pipe.nodes["conv2"].dims.shape)
    with pytest.raises(RtErr, match="'nope'.*not produced"):
        eng.run_fwd({"data": blob}, ["nope"])


def test_weights_to_torch():
    pipe = build_slice_net()
    plan = lower_pipe(pipe, make_op_tune("()"), fuse_relu=True,
                      fused_storage=True)
    ref = resolve_plan_weights(plan, pipe.op_params)
    w = weights_to_torch(plan, pipe.op_params, torch.device("cpu"))
    assert sorted(w) == sorted(plan.weight_nodes) == sorted(ref)
    for n, v in w.items():
        assert v.dtype == torch.float32 and v.is_contiguous()
        np.testing.assert_array_equal(v.numpy(), ref[n])
    wb = weights_to_torch(plan, pipe.op_params, torch.device("cpu"),
                          torch.bfloat16)
    assert {v.dtype for v in wb.values()} == {torch.bfloat16}


def test_forward_checks_its_inputs():
    pipe = build_slice_net()
    plan = lower_pipe(pipe, make_op_tune("()"), fuse_relu=True,
                      fused_storage=True)
    dev = torch.device("cpu")
    fwd = build_forward(plan, dev)
    w = weights_to_torch(plan, pipe.op_params, dev)
    x = torch.zeros(2, 3, 32, 32)
    assert fwd({"data": x}, w)["prob"].shape == (2, 10, 1, 1)
    with pytest.raises(RtErr, match="input nodes"):
        fwd({"dat": x}, w)
    with pytest.raises(RtErr, match="input nodes"):
        fwd({"data": x, "conv1": x}, w)
    with pytest.raises(RtErr, match="shape"):
        fwd({"data": torch.zeros(1, 3, 32, 32)}, w)
    with pytest.raises(RtErr, match="dtype"):
        fwd({"data": x.double()}, w)
    with pytest.raises(RtErr, match="torch.Tensor"):
        fwd({"data": x.numpy()}, w)
    with pytest.raises(RtErr, match="on meta"):
        fwd({"data": x.to("meta")}, w)
    with pytest.raises(RtErr, match="weight node 'conv1_filts'.*no value"):
        fwd({"data": x}, {})


def test_forward_runs_each_step_inside_the_step_hook():
    pipe = build_slice_net()
    plan = lower_pipe(pipe, make_op_tune("()"), fuse_relu=True,
                      fused_storage=True)
    dev = torch.device("cpu")
    fwd = build_forward(plan, dev)
    w = weights_to_torch(plan, pipe.op_params, dev)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 32, 32)
                         .astype(np.float32))
    seen = []

    @contextlib.contextmanager
    def hook(step):
        seen.append(("in", step.call_tag))
        yield
        seen.append(("out", step.call_tag))

    got = fwd({"data": x}, w, step_hook=hook)["prob"]
    tags = [s.call_tag for s in plan.steps]
    assert seen == [(e, t) for t in tags for e in ("in", "out")]
    torch.testing.assert_close(got, fwd({"data": x}, w)["prob"], rtol=0,
                               atol=0)


def test_engine_refuses_cuda_without_a_card_and_unported_options():
    eng = make_engine("(engine=torch)")
    assert eng.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RtErr, match="CUDA is not available"):
            eng.init(build_model("mini", batch=1))
    # the option of engine=rtc that the port leaves out is refused by the
    # config's unused-value check
    with pytest.raises(RtErr, match="unused config value.*per_call_slope"):
        make_engine("(engine=torch,device=cpu,per_call_slope=1)")
    # the mesh options are taken (tests/test_torch_mesh.py runs them)
    eng = make_engine("(engine=torch,device=cpu,mesh_dp=2,mesh_mp=2)")
    assert (eng.mesh_dp, eng.mesh_mp) == (2, 2)


def _run_cnet(conv_fwd, run=create_and_run_has_main):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(f"(mode=run_cnet,model=mini,batch=2,conv_fwd={conv_fwd})", {})
    return buf.getvalue()


def test_run_cnet_through_the_entry_point(monkeypatch):
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")
    out = _run_cnet("(engine=torch,device=cpu)")
    assert "run_cnet: out node 'prob' dims img:2,chan:10,y:1,x:1" in out
    top = re.findall(r"img (\d) top-5: (\d+):", out)
    assert len(top) == 2
    # the same top-1 classes as the JAX engine
    assert top == re.findall(r"img (\d) top-5: (\d+):",
                             _run_cnet("(engine=rtc)",
                                       jhas_main.create_and_run_has_main))
