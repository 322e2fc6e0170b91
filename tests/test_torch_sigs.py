"""The port's own copies of the op variants, lowering, template metadata
and wisdom agree with the JAX package's, string for string: for every step
of ResNet-50 lowered under the unfused f32 tune, the bf16 NHWC tune, the
fused tunes and the two fuse_siblings vendor tunes, and for every op sig of tests/data/ops/*.txt under the
tunes the per-op sweeps use, both packages pick the same template, reduce
the sig to the same signature, name the same instance and give the same
wisdom key and wisdom record.
"""

import io
from pathlib import Path

import pytest

from boda_tpu.backend.interp import InterpBackend as JInterp
from boda_tpu.engine.lower import lower_pipe as jlower_pipe
from boda_tpu.models.zoo import build_model as jbuild_model
from boda_tpu.ops.cnn_variants import add_codegen_annotations as jannotate
from boda_tpu.ops.cnn_variants import make_op_tune as jmake_op_tune
from boda_tpu.ops.op_base import read_op_sigs as jread_op_sigs
from boda_tpu.ops.registry import Codegen as JCodegen
from boda_tpu.ops.registry import get_template as jget_template
from boda_tpu.tune import wisdom as jwisdom
from boda_tpu_torch.backend.interp import InterpBackend
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.engine.lower import lower_pipe
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.cnn_variants import add_codegen_annotations, \
    make_op_tune
from boda_tpu_torch.ops.op_base import read_op_sigs
from boda_tpu_torch.ops.registry import Codegen, all_templates, get_template
from boda_tpu_torch.tune import wisdom

OPS = Path(__file__).parent / "data" / "ops"
NET_TUNES = ["()", "(prec=bf16,layout=nhwc)",
             "(fuse_stem=1,fuse_resblock=1)",
             "(prec=bf16,layout=nhwc,fuse_stem=1,fuse_resblock=1)",
             # the vendor tunes with sibling convs fused (xla_conv2): the
             # f32 twin and the tune the JAX bench times
             "(use_culibs=1,fuse_siblings=1,s2d=0)",
             "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"]
SIG_TUNES = ["()", "(prec=bf16,layout=nhwc)", "(use_culibs=1)",
             "(prec=int8)"]
# sig-file templates of the JAX package that no path of the port runs
NOT_PORTED = {"bwai"}


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
    if op.func_name in NOT_PORTED:
        with pytest.raises(RtErr, match="has no kernel template"):
            get_template(op.func_name)
        return op.func_name
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
