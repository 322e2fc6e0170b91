"""The port's tuning modes against the JAX package's, on the CPU: cnet_tune
(rows, winner file, the plan of each tune), fusion_penalty (candidate
sites, @net records pinned to sites, the index they give), wis_merge and
wis_ana (byte-equal text, CSV and LaTeX) and cnet_bench's wisdom_fn over
the shipped @net rows (the same tune per site as the JAX engine).

Timings on the CPU are noise: what is compared is what the modes choose,
print and write, not how fast anything ran.
"""

import contextlib
import io
import re
from pathlib import Path

import pytest

from boda_tpu.core.has_main import create_and_run_has_main as jrun
from boda_tpu.engine.iface import make_engine as jmake_engine
from boda_tpu.engine.lower import lower_pipe as jlower_pipe
from boda_tpu.graph.caffe_io import write_prototxt as jwrite_prototxt
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.models.zoo import build_model as jbuild_model
from boda_tpu.ops.cnn_variants import make_op_tune as jmake_op_tune
from boda_tpu.tune import wisdom as jwisdom
from boda_tpu_torch.apps.cnet_bench import CnetTune
from boda_tpu_torch.core.has_main import HasMain, create_and_run_has_main
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.tune import wisdom

DATA = Path(__file__).parent / "data"
PLAT, JPLAT = "torch:cpu:cpu", "xla:cpu:cpu"
NET = wisdom.NET_PLAT_SUFFIX
# (the JAX mode's slope over chained forwards can come out negative on
# the CPU, hence \S+ for its numbers)
TUNE_ROW = re.compile(r"^b(\d+) tune (\(.*\)): step_ms=\S+ "
                      r"imgs_per_sec=\S+ tflops=\S+$")


def _out(run, spec: str) -> tuple[str, object]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hm = run(spec)
    return buf.getvalue(), hm


# ---- cnet_tune ----

def test_cnet_tune_rows_and_winner_file_as_the_jax_mode(tmp_path):
    tunes = "((use_culibs=1),(use_culibs=1,prec=bf16,layout=nhwc))"
    args = (f"model=mini,iters=2,reps=1,batches=1 2,tunes={tunes},"
            f"wisdom_out_fn=net.wis")
    rows, hms, bests = {}, {}, {}
    for name, run, extra in (("port", create_and_run_has_main,
                              ",device=cpu"), ("jax", jrun, "")):
        d = tmp_path / name
        out, hms[name] = _out(run, f"(mode=cnet_tune,{args},"
                                   f"boda_output_dir={d}{extra})")
        lines = out.splitlines()
        rows[name] = [TUNE_ROW.match(ln).groups() for ln in lines
                      if ln.startswith("b") and " tune " in ln]
        best = [ln for ln in lines if ln.startswith("best: ")]
        assert len(best) == 1, out
        m = re.match(r"best: batch=(\d+) tune=(\(.*\)) \(imgs_per_sec=\S+\)",
                     best[0])
        assert (d / "net.wis").read_text() == \
            f"(model=mini,batch={m[1]},tune={m[2]})\n"
        bests[name] = (int(m[1]), m[2])
    assert rows["port"] == rows["jax"]
    assert rows["port"] == [(b, t) for b in ("1", "2")
                            for t in ("(use_culibs=1)",
                                      "(use_culibs=1,prec=bf16,layout=nhwc)")]
    assert [(str(r["batch"]), r["tune"]) for r in hms["port"].rows] == \
        rows["port"]
    assert hms["port"].best[1:] == bests["port"]


def test_cnet_tune_defaults_to_the_card():
    with pytest.raises(Exception, match="device 'cuda' requested but CUDA "
                                        "is not available"):
        create_and_run_has_main("(mode=cnet_tune,model=mini,iters=1,reps=1)")


@pytest.mark.parametrize("model", ["mini", "resnet-50"])
@pytest.mark.parametrize("tune", CnetTune.DEFAULT_TUNES + [
    "()", "(prec=bf16,layout=nhwc,fuse_stem=1,fuse_resblock=1)"])
def test_cnet_tune_plans_have_the_jax_templates(model, tune):
    kw = {"batch": 1} if model == "mini" else {"batch": 1, "ysz": 64,
                                               "xsz": 64}
    out, hm = _out(create_and_run_has_main,
                   f"(mode=cnet_tune,model={model},iters=1,reps=1,"
                   f"tunes=({tune}),device=cpu"
                   + (",model_opts=(ysz=64,xsz=64))" if model != "mini"
                      else ")"))
    plan = hm.rows[0]["plan"]
    jplan = jlower_pipe(jbuild_model(model, **kw), jmake_op_tune(tune),
                        fused_storage=True)
    assert [(s.call_tag, s.func_name) for s in plan.steps] == \
        [(s.call_tag, s.func_name) for s in jplan.steps]
    assert plan.storage_nhwc == jplan.storage_nhwc


# ---- fusion_penalty ----

def _crafted_wisdom(mod, ops, plat: str, path) -> None:
    """The crafted standalone wisdom of tests/test_fusion_penalty.py: each
    op's bf16 tune a fake standalone winner over the vendor base."""
    ws = []
    for op in ops:
        w = mod.OpWisdom(op.copy())
        w.tune("(prec=bf16)").add_run(plat, 1e-6)
        w.tune("(use_culibs=1)").add_run(plat, 5e-5)
        ws.append(w)
    mod.write_wisdom_file(path, ws)


def _two_site_prototxt(tmp_path) -> Path:
    """tests/test_fusion_penalty.py's two identical-sig conv sites."""
    b = JNetBuilder("twosite", 2, 3, 16, 16)
    b.conv("conv1", 8, 3, 2, 1)
    b.conv("convA", 8, 3, 1, 1)
    b.conv("convB", 8, 3, 1, 1)
    b.conv("fc-conv", 4, 1, relu=False)
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.softmax("prob")
    ptt = tmp_path / "twosite.prototxt"
    jwrite_prototxt(b.done(seed=7), ptt)
    return ptt


def _records(mod, path, plat: str) -> set:
    """(wisdom key, site, tune, @net plat tag mapped to the port's) of a
    wisdom file's @net runs."""
    return {(mod.wisdom_key(w.op), w.site, ts,
             p.replace(plat, PLAT))
            for w in mod.read_wisdom_file(path) for ts, tw in w.tunes.items()
            for p in tw.runs if p.endswith(NET)}


def _set_net_times(mod, path) -> None:
    """Give every @net run a time fixed by its (site, tune) alone, so that
    both packages' files index the same way whatever the CPU measured."""
    ws = mod.read_wisdom_file(path)
    for w in ws:
        for ts, tw in w.tunes.items():
            for p in tw.runs:
                if p.endswith(NET):
                    tw.runs[p] = 1e-6 * (1 + (len(w.site) * 7 + len(ts)) % 5)
    mod.write_wisdom_file(path, ws)


@pytest.mark.parametrize("net", ["mini", "twosite"])
def test_fusion_penalty_sites_records_and_index_as_the_jax_mode(net,
                                                                tmp_path):
    if net == "mini":
        net_args = "model=mini,batch=2"
        ops = [build_model("mini", batch=2).get_op(t) for t in ("conv2",
                                                                 "cccp1")]
        jops = [jbuild_model("mini", batch=2).get_op(t) for t in ("conv2",
                                                                   "cccp1")]
    else:
        ptt = _two_site_prototxt(tmp_path)
        net_args = f"ptt_fn={ptt}"
        from boda_tpu.graph.caffe_io import read_model as jread_model

        from boda_tpu_torch.graph.caffe_io import read_model
        ops = [read_model(str(ptt)).get_op("convA")]
        jops = [jread_model(str(ptt)).get_op("convA")]
    wfn, jwfn = tmp_path / "port.wis", tmp_path / "jax.wis"
    _crafted_wisdom(wisdom, ops, PLAT, wfn)
    _crafted_wisdom(jwisdom, jops, JPLAT, jwfn)
    spec = f"op_tune=(use_culibs=1),iters=2,reps=1,boda_output_dir={tmp_path}"
    out, hm = _out(create_and_run_has_main,
                   f"(mode=fusion_penalty,{net_args},wisdom_fn={wfn},"
                   f"wisdom_out_fn=port-net.wis,device=cpu,{spec})")
    jout, _ = _out(jrun, f"(mode=fusion_penalty,{net_args},wisdom_fn={jwfn},"
                         f"wisdom_out_fn=jax-net.wis,{spec})")

    def sites(text):
        return [ln.split()[0] for ln in text.splitlines()
                if ln.endswith("WINS") or ln.endswith("(vendor kept)")]
    assert sites(out) == sites(jout) == [t for t, _, _ in hm.sites]
    assert len(hm.sites) >= 2
    assert f"fusion_penalty: {len(hm.sites)} candidate site(s) on {PLAT}" \
        in out
    # both times of each site are printed: the one-site net and the vendor's
    for ln in out.splitlines():
        if ln.split() and ln.split()[0] in sites(out):
            assert len(re.findall(r" \d+\.\d{3} ", ln)) == 2, ln
    recs = _records(wisdom, tmp_path / "port-net.wis", PLAT)
    jrecs = _records(jwisdom, tmp_path / "jax-net.wis", JPLAT)
    assert recs == jrecs
    assert {r[1] for r in recs} == set(sites(out))
    assert {r[3] for r in recs} == {PLAT + NET}
    _set_net_times(wisdom, tmp_path / "port-net.wis")
    _set_net_times(jwisdom, tmp_path / "jax-net.wis")
    assert wisdom.load_tune_index(tmp_path / "port-net.wis", PLAT) == \
        jwisdom.load_tune_index(tmp_path / "jax-net.wis", JPLAT)


def test_fusion_penalty_defaults_to_the_card(tmp_path):
    wfn = tmp_path / "w.wis"
    _crafted_wisdom(wisdom, [build_model("mini", batch=2).get_op("conv2")],
                    PLAT, wfn)
    with pytest.raises(Exception, match="device 'cuda' requested but CUDA "
                                        "is not available"):
        create_and_run_has_main(f"(mode=fusion_penalty,model=mini,"
                                f"wisdom_fn={wfn})")


# ---- wis_merge / wis_ana ----

WIS = [DATA / "wisdom-resnet50-b32.wis", DATA / "wisdom-sgemm-baseline.wis"]


@pytest.mark.parametrize("fn", WIS, ids=lambda p: p.name)
@pytest.mark.parametrize("extra", ["", "plat=TPU,ref_tune_contains=prec"])
def test_wis_ana_byte_equal_to_the_jax_mode(fn, extra, tmp_path):
    outs = []
    for name, run in (("port", create_and_run_has_main), ("jax", jrun)):
        d = tmp_path / name
        out, _ = _out(run, f"(mode=wis_ana,wisdom_in_fn={fn},csv_fn=a.csv,"
                           f"latex_fn=a.tex,boda_output_dir={d}"
                           f"{',' + extra if extra else ''})")
        outs.append((out, (d / "a.csv").read_bytes(),
                     (d / "a.tex").read_bytes()))
    assert outs[0] == outs[1]
    assert len(outs[0][0].splitlines()) > 3


def test_wis_merge_byte_equal_to_the_jax_mode(tmp_path):
    fns = " ".join(str(p) for p in WIS + [WIS[0]])
    outs = []
    for name, run in (("port", create_and_run_has_main), ("jax", jrun)):
        d = tmp_path / name
        out, _ = _out(run, f"(mode=wis_merge,wisdom_in_fns={fns},"
                           f"wisdom_out_fn=m.wis,boda_output_dir={d})")
        outs.append((out, (d / "m.wis").read_bytes()))
    assert outs[0] == outs[1]
    assert "-> 27 merged ops" in outs[0][0]


# ---- cnet_bench --wisdom_fn over the shipped @net rows ----

def test_cnet_bench_wisdom_picks_the_jax_engines_tune_per_site():
    """The shipped ResNet-50 b32 wisdom carries @net rows (a TPU's, picked
    by the any-platform fallback): cnet_bench's engine, built as the mode
    builds it, lowers each site to the same tune and template as the JAX
    engine, and at each sig with @net rows to the in-net winner."""
    wis = DATA / "wisdom-resnet50-b32.wis"
    base = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0)"
    hm = HasMain.init_from_lexp(
        f"(mode=cnet_bench,model=resnet-50,batch=32,op_tune={base},"
        f"wisdom_fn={wis},conv_fwd=(engine=torch,device=cpu))")
    with contextlib.redirect_stdout(io.StringIO()) as log:
        pipe, eng, x, data, top = hm._build_engine()
    assert log.getvalue().startswith("wisdom: tuned ")
    assert tuple(x.shape) == (32, 3, 224, 224) and top == "prob"
    jeng = jmake_engine(f"(engine=rtc,op_tune={base},wisdom_fn={wis})")
    jeng.init(jbuild_model("resnet-50", batch=32))
    assert [(s.call_tag, str(s.sig.to_lexp())) for s in eng.plan.steps] == \
        [(s.call_tag, str(s.sig.to_lexp())) for s in jeng.plan.steps]
    net = "xla:tpu:TPU v5 lite" + NET
    winners = {}
    for w in wisdom.read_wisdom_file(wis):
        runs = {ts: tw.runs[net] for ts, tw in w.tunes.items()
                if net in tw.runs}
        if runs:
            winners[wisdom.wisdom_key(w.op)] = min(runs, key=runs.get)
    assert len(winners) >= 3
    idx = eng._op_tunes(pipe)
    n = 0
    for op in pipe.ops.values():
        key = wisdom.wisdom_key(op)
        if key in winners:
            assert str(idx[op.tag].to_lexp()) == winners[key]
            n += 1
    assert n >= 3
