"""The port's own copies of the op variants, lowering, template metadata
and wisdom agree with the JAX package's, string for string: for every step
of ResNet-50 lowered under the unfused f32 tune, the bf16 NHWC tune, the
fused tunes and the two fuse_siblings vendor tunes, under the selective-int8
preset (with and without int8 storage edges, q8_edges=1), for every step of
every zoo model under (), the bf16 NHWC tune and the JAX bench's tune (the
plan, the storage pass's decision and each template's nhwc_ok flag), and
for every op
sig of tests/data/ops/*.txt under the tunes the per-op sweeps use, both
packages pick the same template, reduce the sig to the same signature, name
the same instance and give the same wisdom key and wisdom record. The
per-call executor (fuse=0) issues the same calls as the JAX engine's: call
tags, instance names, arg maps and full sigs, with the quantize and stats
calls the engine inserts.
"""

import contextlib
import io
from pathlib import Path

import pytest

from boda_tpu.backend.interp import InterpBackend as JInterp
from boda_tpu.engine.iface import make_engine as jmake_engine
from boda_tpu.engine.lower import lower_pipe as jlower_pipe
from boda_tpu.models import zoo as jzoo
from boda_tpu.models.zoo import build_model as jbuild_model
from boda_tpu.ops.cnn_variants import add_codegen_annotations as jannotate
from boda_tpu.ops.cnn_variants import make_op_tune as jmake_op_tune
from boda_tpu.ops.op_base import read_op_sigs as jread_op_sigs
from boda_tpu.ops.registry import Codegen as JCodegen
from boda_tpu.ops.registry import all_templates as jall_templates
from boda_tpu.ops.registry import get_template as jget_template
from boda_tpu.tune import presets as jpresets
from boda_tpu.tune import wisdom as jwisdom
from boda_tpu_torch.backend.interp import InterpBackend
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.engine.lower import lower_pipe
from boda_tpu_torch.engine.torch_fwd import produced_nodes
from boda_tpu_torch.models import zoo as port_zoo
from boda_tpu_torch.models.zoo import MODEL_BUILDERS, build_model
from boda_tpu_torch.ops.cnn_variants import add_codegen_annotations, \
    make_op_tune
from boda_tpu_torch.ops.op_base import read_op_sigs
from boda_tpu_torch.ops.registry import Codegen, all_templates, get_template
from boda_tpu_torch.tune import presets, wisdom

DATA = Path(__file__).parent / "data"
OPS = DATA / "ops"
NET_TUNES = ["()", "(prec=bf16,layout=nhwc)",
             "(fuse_stem=1,fuse_resblock=1)",
             "(prec=bf16,layout=nhwc,fuse_stem=1,fuse_resblock=1)",
             # the vendor tunes with sibling convs fused (xla_conv2): the
             # f32 twin and the tune the JAX bench times
             "(use_culibs=1,fuse_siblings=1,s2d=0)",
             "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"]
SIG_TUNES = ["()", "(prec=bf16,layout=nhwc)", "(use_culibs=1)",
             "(prec=int8)"]
# the JAX package's templates the port has not: none (the training
# templates BckConv, Spreading, bck_lrn, sm_grad_and_loss and
# sum_loss_over_imgs are held to the JAX declarations with the rest)
NOT_PORTED: set = set()
# the zoo's plans: every model under the f32 tune, the bf16 NHWC-storage
# tune and the tune the JAX bench times
ZOO_TUNES = ["()", "(prec=bf16,layout=nhwc)",
             "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"]
_ZOO_PIPES: dict = {}  # the last model's pipes, (port, JAX)


def _record(mod, op) -> str:
    """The wisdom record of op (one tune, one run) as written by `mod`."""
    w = mod.OpWisdom(op)
    w.tune("(t=1)").add_run("plat", 1.0)
    f = io.StringIO()
    mod.write_op_wisdom(w, f)
    return f.getvalue()


def _same(op, jop, cg, jcg) -> str:
    """Assert both packages treat op alike; return its template name."""
    assert op.func_name == jop.func_name
    assert str(op) == str(jop)
    assert wisdom.wisdom_key(op) == jwisdom.wisdom_key(jop)
    assert _record(wisdom, op) == _record(jwisdom, jop)
    pt, jt = get_template(op.func_name), jget_template(op.func_name)
    assert str(pt.check_args(op)) == str(jt.check_args(jop))
    assert pt.flops(pt.check_args(op)) == jt.flops(jt.check_args(jop))
    assert (pt.in_args(), pt.out_args(), pt.io_args()) == \
        (jt.in_args(), jt.out_args(), jt.io_args())
    assert cg.sig_key_str(op) == jcg.sig_key_str(jop)
    assert cg.gen_func(op) == jcg.gen_func(jop)
    return op.func_name


def _codegens():
    be, jbe = InterpBackend(), JInterp()
    be.init()
    jbe.init()
    return Codegen(be), JCodegen(jbe)


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("tune", NET_TUNES)
def test_resnet50_plans_agree(tune, batch):
    plan = lower_pipe(build_model("resnet-50", batch=batch),
                      make_op_tune(tune), fuse_relu=True, fused_storage=True)
    jplan = jlower_pipe(jbuild_model("resnet-50", batch=batch),
                        jmake_op_tune(tune), fuse_relu=True,
                        fused_storage=True)
    assert len(plan.steps) == len(jplan.steps)
    assert plan.storage_nhwc == jplan.storage_nhwc
    assert plan.input_nodes == jplan.input_nodes
    assert plan.weight_nodes == jplan.weight_nodes
    assert {n: str(d) for n, d in plan.node_dims.items()} == \
        {n: str(d) for n, d in jplan.node_dims.items()}
    cg, jcg = _codegens()
    funcs = set()
    for s, js in zip(plan.steps, jplan.steps):
        assert (s.call_tag, s.arg_nodes) == (js.call_tag, js.arg_nodes)
        funcs.add(_same(s.sig, js.sig, cg, jcg))
    assert funcs <= set(all_templates())
    assert ("tconv" in funcs) == ("use_culibs" not in tune)
    assert ("xla_conv2" in funcs) == ("fuse_siblings" in tune)
    assert ("resblock" in funcs) == ("fuse_resblock" in tune)


@pytest.mark.parametrize("tune", ZOO_TUNES)
@pytest.mark.parametrize("model", sorted(MODEL_BUILDERS))
def test_zoo_plans_agree(model, tune, monkeypatch):
    # each model built once per package and lowered under each tune; the
    # plan reads no weight value, so the weights are left uninitialised
    # (their init is most of a build's time)
    if model not in _ZOO_PIPES:
        for mod in (port_zoo, jzoo):
            monkeypatch.setattr(mod, "init_pipe_weights",
                                lambda *a, **k: None)
        _ZOO_PIPES.clear()
        _ZOO_PIPES[model] = (build_model(model, batch=1),
                             jbuild_model(model, batch=1))
    pipe, jpipe = _ZOO_PIPES[model]
    plan = lower_pipe(pipe, make_op_tune(tune), fuse_relu=True,
                      fused_storage=True)
    jplan = jlower_pipe(jpipe, jmake_op_tune(tune), fuse_relu=True,
                        fused_storage=True)
    assert len(plan.steps) == len(jplan.steps)
    assert plan.storage_nhwc == jplan.storage_nhwc
    assert plan.edge_prec == jplan.edge_prec
    assert plan.input_nodes == jplan.input_nodes
    assert plan.weight_nodes == jplan.weight_nodes
    assert {n: str(d) for n, d in plan.node_dims.items()} == \
        {n: str(d) for n, d in jplan.node_dims.items()}
    cg, jcg = _codegens()
    for s, js in zip(plan.steps, jplan.steps):
        assert (s.call_tag, s.arg_nodes) == (js.call_tag, js.arg_nodes)
        _same(s.sig, js.sig, cg, jcg)
        # every step has a port template, the storage pass's flag included
        pt = get_template(s.func_name)
        assert pt.nhwc_ok == jget_template(s.func_name).nhwc_ok
    # the storage pass runs wherever the tune asks for NHWC storage: every
    # template of every zoo plan is nhwc_ok
    assert plan.storage_nhwc == ("layout=nhwc" in tune)


def test_per_site_wisdom_records_agree(tmp_path):
    """fusion_penalty's per-site records: for every conv site of ResNet-50
    b32 (the smoke's wisdom flow), a record pinned to the site is written
    alike by both packages, keyed alike, and an index over it resolves
    each site (and no other same-sig site) alike."""
    pipe, jpipe = build_model("resnet-50", batch=32), \
        jbuild_model("resnet-50", batch=32)
    plat = "torch:cuda:NVIDIA H100 80GB HBM3" + wisdom.NET_PLAT_SUFFIX
    ws, jws = [], []
    for op in pipe.ops.values():
        if op.type != "Convolution":
            continue
        jop = jpipe.get_op(op.tag)
        for mod, o, out in ((wisdom, op, ws), (jwisdom, jop, jws)):
            w = mod.OpWisdom(o.copy(), site=o.tag)
            w.tune("(prec=bf16,layout=nhwc)").add_run(plat, 1e-4)
            w.tune("(use_culibs=1,prec=bf16,layout=nhwc,s2d=0)").add_run(
                plat, 2e-4 if len(o.tag) % 2 else 5e-5)
            out.append(w)
        assert wisdom.site_key(wisdom.wisdom_key(op), op.tag) == \
            jwisdom.site_key(jwisdom.wisdom_key(jop), jop.tag)
    assert len(ws) == 54
    f, jf = io.StringIO(), io.StringIO()
    for w, jw in zip(ws, jws):
        wisdom.write_op_wisdom(w, f)
        jwisdom.write_op_wisdom(jw, jf)
    assert f.getvalue() == jf.getvalue()
    back = list(wisdom.read_wisdom_stream(io.StringIO(f.getvalue())))
    assert [w.site for w in back] == [w.site for w in ws]
    (tmp_path / "s.wis").write_text(f.getvalue())
    base = plat[:-len(wisdom.NET_PLAT_SUFFIX)]
    idx = wisdom.load_tune_index(tmp_path / "s.wis", base)
    assert idx == jwisdom.load_tune_index(tmp_path / "s.wis", base)
    picks = {op.tag: wisdom.lookup_tune(idx, op) for op in pipe.ops.values()
             if op.type == "Convolution"}
    assert picks == {op.tag: jwisdom.lookup_tune(idx, op)
                     for op in jpipe.ops.values() if op.type == "Convolution"}
    assert set(picks.values()) == {"(prec=bf16,layout=nhwc)",
                                   "(use_culibs=1,prec=bf16,layout=nhwc,"
                                   "s2d=0)"}


def test_every_port_mode_has_its_jax_name():
    """Every mode the port registers is registered under the same name by
    the JAX package (the port adds no mode of its own and renames none),
    as a class of the port's, with the JAX class's name."""
    from boda_tpu import modes as jmodes  # noqa: F401  (the JAX modes)
    from boda_tpu.core import config as jconfig
    from boda_tpu.core import has_main as jhas_main
    from boda_tpu_torch import modes  # noqa: F401  (the port's modes)
    from boda_tpu_torch.core.config import Config
    from boda_tpu_torch.core.has_main import HasMain
    jreg = jconfig.Config.registered(jhas_main.HasMain)
    reg = Config.registered(HasMain)
    assert len(reg) >= 40
    assert sorted(set(reg) - set(jreg)) == []
    for name, cls in reg.items():
        assert cls.__module__.startswith("boda_tpu_torch."), name
        assert cls.__name__ == jreg[name].__name__, name

    def attrs(cls):
        return {k for c in cls.__mro__ for k, v in vars(c).items()
                if type(v).__name__ == "Attr"}
    # the tuning, profiling, plot, wisdom and net modes take the JAX modes'
    # attributes (compiler_options, a TPU compiler's, excepted) and add at
    # most where they run (device=, or cnet_bench's conv_fwd)
    for name in ("cnet_tune", "fusion_penalty", "cnet_stage_probe",
                 "cnet_xprof", "wis_merge", "wis_ana", "roofline_plot",
                 "wis_plot", "op_eff_plot", "conv_ana", "cnet_ana",
                 "cnet_copy", "cnet_fc_to_conv", "cnet_resize_conv",
                 "cnet_bpt_dump", "cnet_util", "ops_prof", "cnn_op_info",
                 "cnn_prof", "rtc_test"):
        a, ja = attrs(reg[name]), attrs(jreg[name])
        assert ja - a <= {"compiler_options"}, name
        assert a - ja <= {"device", "conv_fwd"}, name


def test_templates_match_the_jax_package():
    ported = all_templates()
    jax_all = jall_templates()
    assert set(jax_all) - set(ported) == NOT_PORTED
    assert set(ported) <= set(jax_all)
    for name, pt in ported.items():
        jt = jax_all[name]
        assert pt.nhwc_ok == jt.nhwc_ok, name
        assert (pt.in_args(), pt.out_args(), pt.io_args()) == \
            (jt.in_args(), jt.out_args(), jt.io_args()), name
        assert (pt.sig_nda_keys, pt.sig_str_keys) == \
            (jt.sig_nda_keys, jt.sig_str_keys), name
    assert {n for n, t in ported.items() if t.nhwc_ok} >= {
        "copy", "split_copy", "scale", "lrn", "deconv"}
    assert not ported["ZeroIfNonPos"].nhwc_ok


@pytest.mark.parametrize("tune", SIG_TUNES)
@pytest.mark.parametrize("sig_file", sorted(p.name for p in OPS.glob("*.txt")))
def test_sig_file_ops_agree(sig_file, tune):
    ops, jops = read_op_sigs(OPS / sig_file), jread_op_sigs(OPS / sig_file)
    assert len(ops) == len(jops) > 0
    cg, jcg = _codegens()
    for op, jop in zip(ops, jops):
        assert str(op) == str(jop)
        top, jtop = op.copy(), jop.copy()
        add_codegen_annotations(top, make_op_tune(tune))
        jannotate(jtop, jmake_op_tune(tune))
        _same(top, jtop, cg, jcg)


@pytest.mark.parametrize("q8_edges", [False, True])
@pytest.mark.parametrize("batch", [1, 32])
def test_resnet50_int8_preset_plans_agree(batch, q8_edges):
    # bench.py's int8 tune: int8 at the preset's 33 sites with the static
    # scales of the trained snapshot; q8_edges=1 also stores the edges
    # between two int8 steps int8 (out_q8 on the producer, in_q8 on the
    # reader)
    tune = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1" + \
        (",q8_edges=1)" if q8_edges else ")")
    scales = DATA / "resnet50-shapes40-int8-scales.lexp"
    plans = []
    for mod, build, lower, mk in ((presets, build_model, lower_pipe,
                                   make_op_tune),
                                  (jpresets, jbuild_model, jlower_pipe,
                                   jmake_op_tune)):
        pipe = build("resnet-50", batch=batch, num_classes=40)
        with contextlib.redirect_stderr(io.StringIO()):
            tunes = mod.load_act_scales(
                scales, mod.resnet_int8_site_tunes(pipe, tune))
        plans.append(lower(pipe, mk(tune), op_tunes=tunes, fuse_relu=True,
                           fused_storage=True))
    plan, jplan = plans
    assert len(plan.steps) == len(jplan.steps)
    assert plan.weight_nodes == jplan.weight_nodes
    assert plan.weight_transforms == jplan.weight_transforms
    assert {n: str(d) for n, d in plan.node_dims.items()} == \
        {n: str(d) for n, d in jplan.node_dims.items()}
    cg, jcg = _codegens()
    for s, js in zip(plan.steps, jplan.steps):
        assert (s.call_tag, s.arg_nodes) == (js.call_tag, js.arg_nodes)
        _same(s.sig, js.sig, cg, jcg)
    q = [s for s in plan.steps if s.sig.get_u32_or("quant8", 0)]
    assert len(q) == 31
    edges = sum(s.sig.get_u32_or("out_q8", 0) for s in plan.steps)
    assert (edges > 0) == q8_edges


PER_CALL_TUNES = {
    "()": "op_tune=()",
    "fuse_siblings": "op_tune=(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,"
                     "fuse_siblings=1)",
    # the selective-int8 preset: int8 at the 33 sites with the trained
    # snapshot's static scales
    "int8": "op_tune=(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,"
            "fuse_siblings=1),op_tunes_pat=(res3[a-z0-9]*_branch2b=(use_"
            "culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1,quant8=1),"
            "res[45][a-z0-9]*_branch.*=(use_culibs=1,prec=bf16,layout=nhwc,"
            "s2d=0,fuse_siblings=1,quant8=1)),act_scales_fn="
            + str(DATA / "resnet50-shapes40-int8-scales.lexp")}


@pytest.mark.parametrize("tune", list(PER_CALL_TUNES))
def test_resnet50_per_call_plans_agree(tune, tmp_path):
    # ResNet-50 (40 classes, as the scales were calibrated) at batch 1 under
    # fuse=0, with two quantize hooks and the stats calls
    hooks = ("enable_stats=1,quantize=((name=res2a_branch2a,max_val=4,"
             "keep_bits=8),(name=res4b,max_val=8,keep_bits=6))")
    calls, sigs = [], []
    for make, build, spec in (
            (make_engine, build_model, "(engine=torch,device=cpu"),
            (jmake_engine, jbuild_model, "(engine=rtc,rtc=interp")):
        fn = tmp_path / f"sigs-{len(calls)}.txt"
        eng = make(f"{spec},fuse=0,{PER_CALL_TUNES[tune]},{hooks},"
                   f"write_op_sigs_fn={fn})")
        with contextlib.redirect_stderr(io.StringIO()):
            eng.init(build("resnet-50", batch=1, num_classes=40))
        calls.append([(c.call_tag, c.func_name, c.args)
                      for c in eng.fwd_calls])
        sigs.append(fn.read_text())
        steps = [s.func_name for s in eng.plan.steps]
    assert calls[0] == calls[1]
    assert sigs[0] == sigs[1]
    tags = [c[0] for c in calls[0]]
    assert tags.count("quantize__res2a_branch2a") == 1
    # res4b is written by its eltwise and again by its in-place ReLU: a
    # quantize call after each, as in the JAX engine
    assert tags.count("quantize__res4b") == 2
    # one stats call per node written (after its first write)
    written = produced_nodes(eng.plan) - set(eng.plan.input_nodes)
    assert sum(t.startswith("stats__") for t in tags) == len(written) > 50
    assert ("xla_conv2" in steps) == (tune != "()")
    assert ("tconv" in steps) == (tune == "()")
    quant8 = [s for s in eng.plan.steps if s.sig.get_u32_or("quant8", 0)]
    assert len(quant8) == (31 if tune == "int8" else 0)
