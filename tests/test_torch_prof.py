"""The port's per-op tuning path: ops_prof, profile_rcg_call,
cnn_op_info / cnn_prof and the machine model, on device=cpu
beside the numpy reference backend (be=interp), and against wisdom written
by the JAX package's own ops_prof.

Tolerances: the f32 tunes at ops_prof's default mrd 5e-4; bf16 at 5e-3;
sgemm_int8 at 5e-2 against the f32 kg (int8 quantization of the gen_data
patterns, as in the JAX package's int8 sweep).
"""

import re
from pathlib import Path

import pytest

from boda_tpu.core import config as jconfig
from boda_tpu.core import has_main as jhas_main
from boda_tpu_torch import modes  # noqa: F401  (the torch_* modes)
from boda_tpu_torch.backend.iface import make_backend
from boda_tpu_torch.backend.torch_be import TorchBackend
from boda_tpu_torch.core.config import Config
from boda_tpu_torch.core.dims import Dims
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.has_main import HasMain, create_and_run_has_main
from boda_tpu_torch.core.machine import H100_PCIE, H100_SXM, card_peaks
from boda_tpu_torch.ops.cnn_variants import add_codegen_annotations, \
    make_op_tune
from boda_tpu_torch.ops.op_base import read_op_sigs
from boda_tpu_torch.ops.registry import Codegen
from boda_tpu_torch.testing.comp import comp_vars
from boda_tpu_torch.tune.opinfo import op_prec
from boda_tpu_torch.tune.prof import profile_rcg_call
from boda_tpu_torch.tune.wisdom import read_wisdom_file

OPS = Path(__file__).parent / "data" / "ops"
CPU = "t=(be=torch,device=cpu)"
SGEMM_TUNES = "(kg=(use_culibs=1),hand=(),int8=(prec=int8))"
INT8_TOL = "func_mrd_toler=(sgemm_int8=5e-2)"
RN50_CONVS = read_op_sigs(OPS / "resnet50-convs.txt")


def _ops_prof(ops_fn, rtcs, tunes, extra="", out=None):
    o = f",boda_output_dir={out},wisdom_out_fn=out.wis" if out else ""
    create_and_run_has_main(
        f"(mode=ops_prof,ops_fn={ops_fn},rtcs=({rtcs}),op_tunes={tunes},"
        f"run_iter=2{o}{',' if extra else ''}{extra})", {})


def _clean(out: str) -> None:
    for bad in ("COMP_FAIL", "KG_DIGEST_FAIL", "ERROR", "UNVERIFIED"):
        assert bad not in out, out


def test_ops_prof_sgemm_on_cpu_and_interp(tmp_path, capsys):
    _ops_prof(OPS / "sgemm-tiny.txt", f"{CPU},ref=(be=interp)", SGEMM_TUNES,
              INT8_TOL, out=tmp_path)
    out = capsys.readouterr().out
    _clean(out)
    for be in ("t", "ref"):
        for tune, func in (("kg", "xla_sgemm"), ("hand", "sgemm"),
                           ("int8", "sgemm_int8")):
            assert out.count(f"tune={tune} be={be} func={func} ") == 2, out
    ws = read_wisdom_file(tmp_path / "out.wis")
    assert len(ws) == 2
    for w in ws:
        assert {"(use_culibs=1)", "()", "(prec=int8)"} <= set(w.tunes)
        for t in w.tunes.values():
            assert set(t.runs) == {"torch:cpu:cpu", "interp:numpy"}
        assert "c" in w.kgs
    # bf16 in a call of its own: its tolerance is wider than the f32 tunes'
    _ops_prof(OPS / "sgemm-tiny.txt", CPU, "(kg=(use_culibs=1),bf16=(prec=bf16))",
              "mrd_toler=5e-3")
    out = capsys.readouterr().out
    _clean(out)
    assert out.count("tune=bf16 be=t func=sgemm ") == 2


@pytest.mark.parametrize("ops_fn,tunes,n_runs", [
    ("sgemm-tiny.txt", "(kg=(use_culibs=1),hand=())", 4),
    ("conv-tiny.txt", "(kg=(use_culibs=1),hand=(),tc=(tconv=1))", 6),
])
def test_ops_prof_takes_the_jax_packages_kg_digests(tmp_path, capsys, ops_fn,
                                                    tunes, n_runs):
    # the JAX package's ops_prof writes the known-good digests ...
    jhas_main.create_and_run_has_main(
        f"(mode=ops_prof,ops_fn={OPS / ops_fn},rtcs=(xla=(be=xla)),"
        f"op_tunes=(kg=(use_culibs=1)),run_iter=1,boda_output_dir={tmp_path},"
        f"wisdom_out_fn=jax.wis)", {})
    capsys.readouterr()
    # ... and the port's outputs match them under every tune
    _ops_prof(OPS / ops_fn, CPU, tunes,
              f"wisdom_in_fn={tmp_path / 'jax.wis'}", out=tmp_path)
    out = capsys.readouterr().out
    _clean(out)
    assert out.count(" ok\n") == n_runs  # 2 ops x each tune
    plats = {p for w in read_wisdom_file(tmp_path / "out.wis")
             for t in w.tunes.values() for p in t.runs}
    assert plats == {"xla:cpu:cpu", "torch:cpu:cpu"}
    # a corrupted digest is caught, and the error count raises at the end
    wis = (tmp_path / "jax.wis").read_text()
    bad = re.sub(r"cnt=(\d+)", "cnt=99", wis)
    assert bad != wis
    (tmp_path / "bad.wis").write_text(bad)
    with pytest.raises(RtErr, match="ops_prof: 4 errors"):
        _ops_prof(OPS / ops_fn, CPU, "(kg=(use_culibs=1),hand=())",
                  f"wisdom_in_fn={tmp_path / 'bad.wis'}")
    assert "KG_DIGEST_FAIL: var" in capsys.readouterr().out


def test_ops_prof_conv_tiny_runs_clean(capsys):
    _ops_prof(OPS / "conv-tiny.txt", f"{CPU},ref=(be=interp)",
              "(kg=(use_culibs=1),hand=(),tc=(tconv=1))")
    out = capsys.readouterr().out
    _clean(out)
    assert "func=conv " in out and "func=k1conv " in out
    _ops_prof(OPS / "conv-tiny.txt", CPU, "(kg=(use_culibs=1),bf16=(prec=bf16))",
              "mrd_toler=5e-3")
    _clean(capsys.readouterr().out)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("ix", range(len(RN50_CONVS)))
def test_resnet50_conv_templates_per_op(ix, bias):
    """Each port template that a ResNet-50 conv sig selects, run outside a
    plan as ops_prof runs it: NCHW, gen_data inputs, with and without the
    optional biases; at batch 1, against the numpy reference."""
    op = RN50_CONVS[ix].copy()
    for k in ("in", "out"):
        d = op.get_dims(k)
        op.set_dims(k, Dims([(n, 1 if n == "img" else s)
                             for n, s in zip(d.names(), d.shape)], tn=d.tn))
    if not bias:
        op.nda_vals.pop("biases")
    ref_be = make_backend("interp")
    ref_be.init()
    _, want = profile_rcg_call(Codegen(ref_be), _annotated(op, "()"), 1)
    cg = Codegen(make_backend("(be=torch,device=cpu)"))
    cg.backend.init()
    funcs = set()
    for tune, tol in (("(use_culibs=1)", 5e-4), ("()", 5e-4),
                      ("(prec=bf16)", 5e-3)):
        top = _annotated(op, tune)
        funcs.add(top.func_name)
        _, got = profile_rcg_call(cg, top, 1)
        assert got["out"].v.dtype.name == "float32"
        assert not comp_vars(want, got, tol), (tune, top.func_name)
    assert funcs <= {"s2d_conv", "xla_conv", "k1conv", "conv", "tconv",
                     "ipconv"}


def _annotated(op, tune):
    top = op.copy()
    add_codegen_annotations(top, make_op_tune(tune))
    return top


def test_resnet50_sigs_select_every_conv_template():
    funcs = {_annotated(op, t).func_name for op in RN50_CONVS
             for t in ("(use_culibs=1)", "()")}
    assert funcs == {"s2d_conv", "xla_conv", "k1conv", "conv", "tconv",
                     "ipconv"}


def test_cnn_op_info_scores_each_op_against_its_own_precision(capsys,
                                                             monkeypatch):
    # the CPU backend, reporting an H100 SXM as its card
    monkeypatch.setattr(TorchBackend, "device_kind",
                        lambda self: "NVIDIA H100 80GB HBM3")
    for tune, prec, peak in (("(prec=int8)", "int8", 1979e12),
                             ("()", "f32", 67e12), ("(prec=bf16)", "bf16",
                                                    989e12)):
        create_and_run_has_main(
            f"(mode=cnn_op_info,ops_fn={OPS / 'sgemm-tiny.txt'},run=1,"
            f"run_iter=1,rtc=(be=torch,device=cpu),op_tune={tune})", {})
        rows = [ln.split() for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("(type=sgemm")]
        assert len(rows) == 2
        for r in rows:
            assert r[-4] == prec
            gfs, pct = float(r[-2]), float(r[-1])
            assert pct == pytest.approx(100 * gfs * 1e9 / peak, abs=0.006)
    monkeypatch.undo()
    # the CPU is no card of the machine model: no made-up peak
    with pytest.raises(RtErr, match="no peaks known for device 'cpu'"):
        create_and_run_has_main(
            f"(mode=cnn_op_info,ops_fn={OPS / 'sgemm-tiny.txt'},run=1,"
            f"rtc=(be=torch,device=cpu))", {})


def test_cnn_prof_over_a_net(tmp_path, capsys):
    create_and_run_has_main(
        f"(mode=cnn_prof,model=mini,run=1,run_iter=1,"
        f"rtc=(be=torch,device=cpu),peak_flops=1e12,comp_tune=(use_culibs=1),"
        f"boda_output_dir={tmp_path},latex_fn=t.tex)", {})
    out = capsys.readouterr().out
    assert "COMP_FAIL" not in out and "ERROR" not in out
    assert "k1conv" in out and "%peak" in out
    assert "\\end{tabular}" in (tmp_path / "t.tex").read_text()


def test_op_prec_defaults_to_f32():
    op = read_op_sigs(OPS / "sgemm-tiny.txt")[0]
    assert op_prec(_annotated(op, "()")) == "f32"
    assert op_prec(_annotated(op, "(prec=bf16)")) == "bf16"
    assert op_prec(_annotated(op, "(prec=int8)")) == "int8"


def test_machine_model_knows_the_h100_by_name():
    assert card_peaks("NVIDIA H100 80GB HBM3") is H100_SXM
    assert card_peaks("NVIDIA H100 PCIe") is H100_PCIE
    assert (H100_SXM.f32, H100_SXM.bf16, H100_SXM.int8, H100_SXM.hbm_bw) == \
        (67e12, 989e12, 1979e12, 3.35e12)
    assert H100_PCIE.flops("int8") == 1513e12
    for bad in ("cpu", "TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(RtErr, match="no peaks known"):
            card_peaks(bad)
    with pytest.raises(RtErr, match="no peak for precision 'fp8'"):
        H100_SXM.flops("fp8")


def test_the_jax_modes_keep_their_names():
    # the two packages register their modes in registries of their own
    from boda_tpu import modes as jmodes  # noqa: F401  (the JAX modes)
    from boda_tpu.backend.modes import RtcTest
    from boda_tpu.tune.opinfo import CnnOpInfo, CnnProf
    from boda_tpu.tune.prof import OpsProf
    jreg = jconfig.Config.registered(jhas_main.HasMain)
    assert jreg["ops_prof"] is OpsProf
    assert jreg["cnn_op_info"] is CnnOpInfo
    assert jreg["cnn_prof"] is CnnProf
    assert jreg["rtc_test"] is RtcTest
    # the port registers the per-op modes under the same names, as classes
    # of its own, and no mode under a torch_ prefix
    reg = Config.registered(HasMain)
    for name in ("ops_prof", "cnn_op_info", "cnn_prof", "rtc_test"):
        assert reg[name].__module__.startswith("boda_tpu_torch.")
        assert reg[name] is not jreg[name]
        assert reg[name].__name__ == jreg[name].__name__
    assert not [n for n in reg if n.startswith("torch_")]


def test_ops_prof_refuses_the_jax_backend():
    # the port registers no be=xla: its config refuses the name
    with pytest.raises(RtErr, match="unknown be 'xla' for Backend"):
        _ops_prof(OPS / "sgemm-tiny.txt", "x=(be=xla)", "(kg=(use_culibs=1))")
