"""The rest of the engine on the CPU, the port against the JAX package:
TorchFwd's per-call mode (fuse=0, one backend call per step) and its
per-call report, the hooks of both executors (enable_stats, quantize,
nan_check, force_zero_bias, det_drop_seed, train_dropout), wisdom_fn,
write_op_sigs_fn and show_rtc_calls; the templates var_stats and quantize
and both train-mode dropout masks; the float64 engine=ref; and the harness
modes test_compute_multi, comp_ndas and test_lmdb. These mirror the JAX
package's own engine tests (tests/test_engine.py), run the JAX engine
(engine=rtc, its Pallas templates on their jnp fallback) beside the port
(device=cpu, the kernels' plain versions) on the same numpy-seeded inputs.

Tolerances: the cross-engine mrd 5e-4 (testing/comp.DEFAULT_MRD_TOLER);
stats min and max exact and mean and sum of squares within rtol 1e-5 (f32
sums in another order); the masks, the quantized f32 nodes and engine=ref
bit-equal.
"""

import contextlib
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.core import dims as jdims
from boda_tpu.core import has_main as jhas_main
from boda_tpu.core.error import RtErr as JRtErr
from boda_tpu.engine import iface as jiface
from boda_tpu.models import zoo as jzoo
from boda_tpu.ops import op_base as jop_base
from boda_tpu.ops import registry as jregistry
from boda_tpu.ops.pallas import gen_data as jgen_data
from boda_tpu.ops.pallas.elementwise import Dropout as JDropout
from boda_tpu_torch.core import dims
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.has_main import create_and_run_has_main
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.engine.lower import DROP_SEED_NODE
from boda_tpu_torch.models import zoo
from boda_tpu_torch.ops import op_base, registry
from boda_tpu_torch.ops.cuda.elementwise import Dropout
from boda_tpu_torch.ops.cuda.gen_data import gen_test_nda

DATA = Path(__file__).parent / "data"
MRD_TOLER = 5e-4
STATS_RTOL = 1e-5
# each package's zoo, engine factory, NDA and test pattern
PORT = (zoo, make_engine, dims.NDA, gen_test_nda)
JAX = (jzoo, jiface.make_engine, jdims.NDA, jgen_data.gen_test_nda)


@pytest.fixture(autouse=True)
def _jnp_fallback(monkeypatch):
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")


def mrd(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = np.maximum(np.abs(a), np.abs(b)).max() + 1e-30
    return np.abs(a - b).max() / scale


def small_nin(pkg=PORT, batch=1):
    """The zoo's `mini` in package `pkg`: NiN-style, 32x32, conv with pad
    and stride, 1x1 convs, max and global-average pools, dropout, softmax.
    (tests/test_engine.py's NiN also has a concat, which lowers to the
    `copy` template the port has not taken yet.)"""
    return pkg[0].build_model("mini", batch=batch)


def resnet_micro(pkg=PORT, batch=2):
    """tests/test_storage.py's residual net in package `pkg`: a projection
    and an identity bottleneck (the fuse_siblings pair r1_c1 + r1_proj)."""
    b = pkg[0].NetBuilder("resnet_micro", batch, 3, 32, 32)
    b.conv("conv1", 16, 5, 2, 2)
    b.pool("pool1", 3, 2)
    stem = b.cur
    b.conv("r1_c1", 8, 1)
    b.conv("r1_c2", 8, 3, 1, 1)
    b.conv("r1_c3", 32, 1, relu=False)
    br = b.cur
    b.cur = stem
    b.conv("r1_proj", 32, 1, relu=False)
    b.eltwise("r1_add", [br, b.cur])
    b.relu("r1_relu")
    x1 = b.cur
    b.conv("r2_c1", 8, 1)
    b.conv("r2_c2", 8, 3, 1, 1)
    b.conv("r2_c3", 32, 1, relu=False)
    b.eltwise("r2_add", [b.cur, x1])
    b.relu("r2_relu")
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.conv("fc", 10, 1, relu=False)
    b.softmax("prob")
    return b.done(seed=7)


def data_for(pipe, pkg=PORT):
    d = pipe.get_data_img_dims()
    return {"data": pkg[2](d, pkg[3](d, mode=0, scale=0.1))}


def port_spec(spec: str) -> str:
    """A JAX engine spec's port twin: engine=torch on the CPU."""
    if spec == "ref":
        return spec
    return spec.replace("engine=rtc", "engine=torch,device=cpu")


def run_both(spec, build=small_nin, to_get=("prob",)):
    """Engine `spec` (a JAX engine=rtc spec) of each package on the same
    net and input -> (port engine, port outs, jax engine, jax outs)."""
    res = []
    for pkg, s in ((PORT, port_spec(spec)), (JAX, spec)):
        pipe = build(pkg)
        eng = pkg[1](s)
        eng.init(pipe)
        res += [eng, eng.run_fwd(data_for(pipe, pkg), list(to_get))]
    return res


# ---- the per-call mode and its report ----

@pytest.mark.parametrize("extra", ["", ",enable_stats=1",
                                   ",quantize=((name=conv1,max_val=1.0,"
                                   "keep_bits=4))"])
def test_per_call_timing_report(tmp_path, extra):
    reports = []
    for pkg, spec in ((PORT, "(engine=torch,device=cpu,fuse=0"),
                      (JAX, "(engine=rtc,fuse=0")):
        fn = tmp_path / f"calls-{len(reports)}.txt"
        eng = pkg[1](f"{spec},per_call_fn={fn}{extra})")
        pipe = small_nin(pkg)
        eng.init(pipe)
        eng.run_fwd(data_for(pipe, pkg), ["prob"])
        assert eng.last_run_secs > 0
        reports.append(fn.read_text().splitlines())
    port, jax_lines = reports
    assert port[0] == jax_lines[0] == "per-layer timing (tag func secs):"
    assert len(port) == len(jax_lines) > 7
    assert [ln.split()[:2] for ln in port[1:]] == \
        [ln.split()[:2] for ln in jax_lines[1:]]
    assert all(float(ln.split()[2]) > 0 for ln in port[1:])
    tags = [ln.split()[0] for ln in port[1:]]
    assert ("stats__conv1" in tags) == ("stats" in extra)
    assert ("quantize__conv1" in tags) == ("quantize" in extra)


def test_engines_agree_small_nin():
    pipe = small_nin()
    ins = data_for(pipe)
    outs = {}
    for name, spec in (("ref", "ref"), ("fused", "(engine=torch,device=cpu)"),
                       ("percall", "(engine=torch,device=cpu,fuse=0)"),
                       ("interp", "(engine=torch,device=cpu,fuse=0,"
                                  "rtc=(be=interp))")):
        eng = make_engine(spec)
        eng.init(pipe)
        outs[name] = eng.run_fwd(ins, ["prob"])["prob"].v
    assert outs["ref"].shape == (1, 10, 1, 1)
    assert abs(outs["ref"].sum() - 1.0) < 1e-5
    for a in outs:
        for b in outs:
            assert mrd(outs[a], outs[b]) < MRD_TOLER, (a, b)
    # fused and per-call run the same templates on the same plan under ()
    np.testing.assert_array_equal(outs["fused"], outs["percall"])
    _, _, _, jouts = run_both("(engine=rtc,fuse=0)")
    assert mrd(outs["percall"], jouts["prob"].v) < MRD_TOLER


def test_per_call_backend_must_share_the_engines_device():
    # the default backend, and a backend that names no device, run on the
    # engine's device (a nested config reads the engine's device=)
    for rtc in ("", ",rtc=(be=torch)"):
        eng = make_engine(f"(engine=torch,device=cpu,fuse=0{rtc})")
        eng.init(small_nin())
        assert eng.rtc.dev == eng.dev == torch.device("cpu")
    eng = make_engine("(engine=torch,device=cpu,fuse=0,"
                      "rtc=(be=torch,device=cuda))")
    with pytest.raises(RtErr, match="CUDA is not available"
                       if not torch.cuda.is_available()
                       else "the backend runs on cuda:0, the engine on cpu"):
        eng.init(small_nin())


def test_per_call_mode_fused_siblings():
    """Per-call xla_conv2 (declared outs absent from the instance's sig:
    present_args) and its int8 prequant form, against the JAX engine's
    per-call run of the same tunes (tests/test_engine.py:272)."""
    ref = make_engine("ref")
    pipe = resnet_micro()
    ref.init(pipe)
    want = ref.run_fwd(data_for(pipe), ["prob"])["prob"].v
    for tune in ("(use_culibs=1,fuse_siblings=1)",
                 "(use_culibs=1,fuse_siblings=1,quant8=1)"):
        eng, got, jeng, jgot = run_both(f"(engine=rtc,fuse=0,op_tune={tune})",
                                        build=resnet_micro)
        assert any(s.func_name == "xla_conv2" for s in eng.plan.steps)
        got, jgot = got["prob"].v, jgot["prob"].v
        if "quant8" in tune:
            assert any(s.sig.get_u32_or("prequant_w", 0)
                       for s in eng.plan.steps)
            assert (got.reshape(2, -1).argmax(1)
                    == want.reshape(2, -1).argmax(1)).all()
        else:
            assert mrd(got, want) < MRD_TOLER
        assert mrd(got, jgot) < MRD_TOLER


def test_run_fwd_refuses_nodes_removed_by_fusion_per_call():
    pipe = zoo.build_model("resnet-50", batch=1, ysz=64, xsz=64)
    eng = make_engine("(engine=torch,device=cpu,fuse=0,"
                      "op_tune=(fuse_resblock=1))")
    eng.init(pipe)
    with pytest.raises(RtErr, match="not produced by any step"):
        eng.run_fwd(data_for(pipe), ["res2b_branch2a", "prob"])


def test_write_op_sigs_and_show_rtc_calls(tmp_path):
    logs, sigs = [], []
    for pkg, spec in ((PORT, "(engine=torch,device=cpu"),
                      (JAX, "(engine=rtc")):
        fn = tmp_path / f"sigs-{len(sigs)}.txt"
        eng = pkg[1](f"{spec},fuse=0,show_rtc_calls=1,write_op_sigs_fn={fn},"
                     f"op_tunes_pat=(conv1=(use_culibs=1)))")
        pipe = small_nin(pkg)
        eng.init(pipe)
        eng.run_fwd(data_for(pipe, pkg), ["prob"])
        sigs.append(fn.read_text())
        logs.append(eng.get_info_log())
    assert sigs[0] == sigs[1] and sigs[0].count("\n") > 5
    assert logs[0] == logs[1]
    assert logs[0].startswith("op_tunes_pat: tuned 1 op(s)\nCALL conv1 ")


# ---- stats, quantize ----

@pytest.mark.parametrize("fuse", [1, 0])
def test_stats_and_quantize(fuse):
    eng, outs, jeng, _ = run_both(
        f"(engine=rtc,fuse={fuse},enable_stats=1,keep_all_nodes=1)",
        to_get=("conv1", "pool1", "prob"))
    # against the JAX engine's stats of its own nodes, which differ from
    # the port's in f32 rounding: all four within the rtol
    assert set(eng.stats) == set(jeng.stats) and "conv1" in eng.stats
    for n, v in eng.stats.items():
        got, want = v.v, np.asarray(jeng.stats[n].v)
        assert got.shape == (4,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=STATS_RTOL, atol=1e-30)
    for n in ("conv1", "pool1", "prob"):
        v = outs[n].v.astype(np.float64)
        s = eng.stats[n].v
        assert (s[0], s[1]) == (v.min(), v.max())
        np.testing.assert_allclose(s[2:], [v.mean(), (v * v).sum()],
                                   rtol=STATS_RTOL)
    # the quantize hook after conv1: the node lies on the grid, equal bit
    # for bit to the template applied to the unquantized node, and to the
    # JAX engine's where their conv1 agree bit for bit
    q = "quantize=((name=conv1,max_val=1.0,keep_bits=2))"
    qeng, qouts, _, jqouts = run_both(
        f"(engine=rtc,fuse={fuse},{q},keep_all_nodes=1)",
        to_get=("conv1", "prob"))
    step = 1.0 / 4
    got = qouts["conv1"].v
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.round(got / step) * step)
    qfn = _quantize_fn(registry, op_base, dims, 1.0, 2, got.shape)
    np.testing.assert_array_equal(
        got, qfn(torch.from_numpy(outs["conv1"].v)).numpy())
    np.testing.assert_array_equal(got, jqouts["conv1"].v)
    assert not np.allclose(qouts["prob"].v, outs["prob"].v)
    assert mrd(qouts["prob"].v, jqouts["prob"].v) < MRD_TOLER


def _quantize_fn(reg, ob, dm, max_val, keep_bits, shape):
    sig = ob.OpBase({"type": "quantize", "func_name": "quantize"})
    sig.set_dims("inout", dm.Dims.make(img=shape[0], chan=shape[1],
                                       y=shape[2], x=shape[3]))
    sig.nda_vals["max_val"] = dm.NDA.scalar(max_val, "float")
    sig.set_u32("keep_bits", keep_bits)
    t = reg.get_template("quantize")
    return t.build(t.check_args(sig))


@pytest.mark.parametrize("max_val,keep_bits", [(1.0, 2), (0.3, 8), (2.5, 5),
                                               (1e-3, 12), (7.7, 16)])
def test_quantize_template_bit_equal(max_val, keep_bits):
    """The port's quantize against the JAX template on the same input:
    bit-equal in f32 and, rounding in bf16 at every step (JAX's weak-typed
    constants), in bf16 too."""
    x = (np.random.RandomState(keep_bits).randn(2, 8, 9, 7) * 3) \
        .astype(np.float32)
    pf = _quantize_fn(registry, op_base, dims, max_val, keep_bits, x.shape)
    jf = jax.jit(_quantize_fn(jregistry, jop_base, jdims, max_val, keep_bits,
                              x.shape))
    np.testing.assert_array_equal(pf(torch.from_numpy(x)).numpy(),
                                  np.asarray(jf(x)))
    got = pf(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(jf(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)))


def test_var_stats_template_casts_bf16_to_f32_first():
    x = np.random.RandomState(3).randn(2, 5, 6, 7).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    t = registry.get_template("var_stats")
    sig = op_base.OpBase({"type": "var_stats", "func_name": "var_stats"})
    sig.set_dims("in", dims.Dims.make(img=2, chan=5, y=6, x=7))
    got = t.build(t.check_args(sig))(xb)
    assert got.dtype == torch.float32
    want = t.ref_impl(t.check_args(sig), xb.float().numpy())
    np.testing.assert_array_equal(got[:2].numpy(), want[:2])
    np.testing.assert_allclose(got[2:].numpy(), want[2:], rtol=STATS_RTOL)


def test_quantize_spec_errors():
    for pkg, spec, err in ((PORT, "(engine=torch,device=cpu", RtErr),
                           (JAX, "(engine=rtc", JRtErr)):
        eng = pkg[1](f"{spec},quantize=(_=(name=no_such_node,max_val=2)))")
        with pytest.raises(err, match=re.escape(
                "quantize: no step writes node(s) ['no_such_node']")):
            eng.init(small_nin(pkg))
        eng = pkg[1](f"{spec},quantize=(_=(max_val=2)))")
        with pytest.raises(err, match="quantize spec missing 'name'"):
            eng.init(small_nin(pkg))


# ---- nan_check, determinism hooks ----

@pytest.mark.parametrize("fuse", [1, 0])
def test_nan_check_sanitizer(fuse):
    """A clean net passes; a NaN in conv2's filter raises naming conv2
    first, with the JAX engine's message for that executor; without the
    sanitizer the NaN flows to the output."""
    msgs = []
    for pkg, spec, err in ((PORT, f"(engine=torch,device=cpu,fuse={fuse}",
                            RtErr),
                           (JAX, f"(engine=rtc,fuse={fuse}", JRtErr)):
        pipe = small_nin(pkg)
        eng = pkg[1](f"{spec},nan_check=1)")
        eng.init(pipe)
        eng.run_fwd(data_for(pipe, pkg), ["prob"])
        pipe2 = small_nin(pkg)
        w = pipe2.op_params["conv2_filts"]
        w.v = w.v.copy()
        w.v.reshape(-1)[3] = np.nan
        eng = pkg[1](f"{spec},nan_check=1)")
        eng.init(pipe2)
        with pytest.raises(err, match="nan_check: non-finite.*conv2") as ei:
            eng.run_fwd(data_for(pipe2, pkg), ["prob"])
        msgs.append(str(ei.value))
        eng = pkg[1](f"{spec})")
        eng.init(pipe2)
        out = eng.run_fwd(data_for(pipe2, pkg), ["prob"])["prob"].v
        assert np.isnan(np.asarray(out, np.float64)).any()
    assert msgs[0] == msgs[1]


def test_nan_check_flags_inf_under_bf16_storage():
    """The fused executor's flags (max |x| of each node's first write)
    catch an infinity too, in bf16 NHWC storage, with the JAX message."""
    msgs = []
    for pkg, spec, err in ((PORT, "(engine=torch,device=cpu", RtErr),
                           (JAX, "(engine=rtc", JRtErr)):
        pipe = small_nin(pkg)
        w = pipe.op_params["cccp1_filts"]
        w.v = w.v.copy()
        w.v.reshape(-1)[0] = np.inf
        eng = pkg[1](f"{spec},nan_check=1,op_tune=(prec=bf16,layout=nhwc))")
        eng.init(pipe)
        with pytest.raises(err, match="first in step order: 'cccp1'") as ei:
            eng.run_fwd(data_for(pipe, pkg), ["prob"])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("fuse", [1, 0])
def test_determinism_hooks(fuse):
    """set_all_one_weights + force_zero_bias (rtc_fwd.cc:59): with all-ones
    biases, the zero-bias engine differs from the reference by exactly 1
    where both are in ReLU's linear region, as the JAX engine does."""
    pipe = small_nin()
    pipe.set_all_one_weights()
    ref = make_engine("ref")
    ref.init(pipe)
    with_bias = ref.run_fwd(data_for(pipe), ["conv1"])["conv1"].v
    eng = make_engine(f"(engine=torch,device=cpu,fuse={fuse},"
                      f"force_zero_bias=1)")
    eng.init(pipe)
    out = eng.run_fwd(data_for(pipe), ["conv1"])["conv1"].v
    both_pos = (out > 0.5) & (with_bias > 0.5)
    assert both_pos.any() and np.isfinite(out).all()
    np.testing.assert_allclose((with_bias - out)[both_pos], 1.0, rtol=1e-4)
    jpipe = small_nin(JAX)
    jpipe.set_all_one_weights()
    jeng = jiface.make_engine(f"(engine=rtc,fuse={fuse},force_zero_bias=1)")
    jeng.init(jpipe)
    jout = jeng.run_fwd(data_for(jpipe, JAX), ["conv1"])["conv1"].v
    assert mrd(out, jout) < MRD_TOLER


# ---- the dropout masks ----

SHAPES = [(1, 7, 1, 1), (3, 5, 2, 2), (2, 64, 3, 3), (1, 4096, 1, 1)]
SEEDS = [0, 1, 7, 123456, 0x7FFF0000, 2**31 - 1]


def _dropout_sig(ob, dm, shape, seeded, ratio, det_seed):
    sig = ob.OpBase({"type": "Dropout", "func_name": "dropout",
                     "drop_mode": "train"})
    sig.set_dims("inout", dm.Dims.make(img=shape[0], chan=shape[1],
                                       y=shape[2], x=shape[3]))
    sig.nda_vals["dropout_ratio"] = dm.NDA.scalar(ratio, "float")
    if det_seed:
        sig.set_u32("det_drop_seed", det_seed)
    if seeded:
        sig.set_dims("seed", dm.Dims([("v", 1)], tn="int32_t"))
    return sig


@pytest.mark.parametrize("shape", SHAPES)
def test_seeded_mask_bit_equal(shape):
    """_mask32 on torch (int64 with explicit wraps) against the numpy twin
    and the JAX template's uint32 form; the hash products wrap past 32 bits
    from the second element on."""
    for seed in SEEDS:
        u = Dropout._mask32(torch.tensor([seed], dtype=torch.int32), shape)
        assert u.dtype == torch.float32 and tuple(u.shape) == shape
        want = JDropout._mask32_np(seed, shape)
        np.testing.assert_array_equal(u.numpy(), want.astype(np.float32))
        np.testing.assert_array_equal(
            Dropout._mask32_np(seed, shape), want)
        np.testing.assert_array_equal(u.numpy(), np.asarray(
            JDropout._mask32_jnp(jnp.int32(seed), shape)))


@pytest.mark.parametrize("shape", SHAPES)
def test_static_mask_bit_equal(shape):
    """The static per-signature _mask (uint64 LCG + fmix, keyed by
    det_drop_seed) equals the JAX template's, for several seeds."""
    for det_seed in (0, 7, 99991):
        sig = _dropout_sig(op_base, dims, shape, False, 0.5, det_seed)
        jsig = _dropout_sig(jop_base, jdims, shape, False, 0.5, det_seed)
        np.testing.assert_array_equal(Dropout._mask(sig, shape),
                                      JDropout._mask(jsig, shape))


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("ratio", [0.5, 0.3])
def test_dropout_train_template_bit_equal(seeded, ratio):
    """The train-mode template's output against the JAX template's, f32
    and bf16, static and seeded forms; kept units scaled by 1/(1-ratio)."""
    shape = (2, 64, 3, 3)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    sig = _dropout_sig(op_base, dims, shape, seeded, ratio, 7)
    jsig = _dropout_sig(jop_base, jdims, shape, seeded, ratio, 7)
    t, jt = registry.get_template("dropout"), jregistry.get_template("dropout")
    fn, jfn = t.build(t.check_args(sig)), jax.jit(jt.build(jt.check_args(jsig)))
    seed = np.asarray([123], np.int32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16,
                                                   jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dt)
        got = fn(torch.from_numpy(seed), xt) if seeded else fn(xt)
        xj = jnp.asarray(x, jdt)
        want = jfn(seed, xj) if seeded else jfn(xj)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    # the float64 reference divides where XLA multiplies by the reciprocal:
    # the same units kept, the values within one f32 rounding
    want = t.ref_impl(t.check_args(sig), *((seed, x) if seeded else (x,)))
    got = fn(torch.from_numpy(seed), torch.from_numpy(x)) if seeded \
        else fn(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -23)
    kept = got.numpy() != 0
    assert abs(kept.mean() - (1 - ratio)) < 0.06


@pytest.mark.parametrize("fuse", [1, 0])
def test_train_dropout_engine(fuse):
    """train_dropout=1 feeds a per-step seed node: the same units dropped
    as the float64 reference and the JAX engine for a fed seed, an unfed
    seed counts as 0 (the JAX engines' first-touch zero), and another seed
    draws another mask."""
    def run(pkg, pipe, spec, seed):
        eng = pkg[1](spec)
        eng.init(pipe)
        ins = data_for(pipe, pkg)
        if seed is not None:
            ins[DROP_SEED_NODE] = pkg[2](eng.plan.node_dims[DROP_SEED_NODE],
                                         np.asarray([seed], np.int32))
        return eng.run_fwd(ins, ["conv2", "prob"])

    pipe = small_nin()
    spec = "train_dropout=1,det_drop_seed=7,keep_all_nodes=1"
    port = {s: run(PORT, pipe, f"(engine=torch,device=cpu,fuse={fuse},"
                               f"{spec})", s)
            for s in (None, 0, 5)}
    ref = {s: run(PORT, pipe, "(engine=ref,train_dropout=1,det_drop_seed=7)",
                  s)
           for s in (0, 5)}
    jeng = run(JAX, small_nin(JAX), f"(engine=rtc,fuse={fuse},{spec})", 5)
    for s in (0, 5):
        got, want = port[s]["conv2"].v, ref[s]["conv2"].v
        np.testing.assert_array_equal(got == 0, want == 0)
        assert mrd(got, want) < MRD_TOLER
        assert mrd(port[s]["prob"].v, ref[s]["prob"].v) < MRD_TOLER
    np.testing.assert_array_equal(port[None]["conv2"].v, port[0]["conv2"].v)
    assert (port[0]["conv2"].v != port[5]["conv2"].v).any()
    np.testing.assert_array_equal(port[5]["conv2"].v == 0,
                                  jeng["conv2"].v == 0)


# ---- wisdom ----

def test_wisdom_fn_picks_the_jax_engines_tunes():
    """wisdom_fn on the recorded ResNet-50 b32 wisdom (TPU platform tags:
    the any-platform fallback picks them): the same per-op tunes, hence the
    same lowered plan, as the JAX engine."""
    wis = DATA / "wisdom-resnet50-b32.wis"
    plans = []
    for pkg, spec in ((PORT, "(engine=torch,device=cpu"),
                      (JAX, "(engine=rtc")):
        eng = pkg[1](f"{spec},wisdom_fn={wis})")
        eng.init(pkg[0].build_model("resnet-50", batch=32))
        plans.append([(s.call_tag, str(s.sig.to_lexp())) for s in
                      eng.plan.steps])
        assert eng.get_info_log().startswith("wisdom: tuned ")
    assert plans[0] == plans[1]
    eng = make_engine(f"(engine=torch,device=cpu,wisdom_fn={wis})")
    eng.init(zoo.build_model("resnet-50", batch=32))
    default = make_engine("(engine=torch,device=cpu)")
    default.init(zoo.build_model("resnet-50", batch=32))
    assert [str(s.sig.to_lexp()) for s in eng.plan.steps] != \
        [str(s.sig.to_lexp()) for s in default.plan.steps]


# ---- engine=ref ----

@pytest.mark.parametrize("build", [zoo.build_model, resnet_micro])
def test_ref_engine_bit_equal_to_jax_ref(build):
    outs = []
    for pkg in (PORT, JAX):
        pipe = pkg[0].build_model("mini", batch=1) \
            if build is zoo.build_model else build(pkg)
        eng = pkg[1]("ref")
        eng.init(pipe)
        nodes = [n for n, nd in pipe.nodes.items()
                 if nd.dims is not None and nd.top_for]
        outs.append(eng.run_fwd(data_for(pipe, pkg), nodes))
    assert set(outs[0]) == set(outs[1]) and len(outs[0]) > 5
    for n in outs[0]:
        assert outs[0][n].v.dtype == outs[1][n].v.dtype
        np.testing.assert_array_equal(outs[0][n].v, outs[1][n].v)


# ---- the harness modes ----

def _capture(run, spec):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(spec, {})
    return buf.getvalue()


def test_compute_multi_on_mini_matches_tpu_archive(tmp_path):
    out = _capture(create_and_run_has_main, (
        f"(mode=test_compute_multi,model=mini,batch=1,all_vars=1,"
        f"boda_output_dir={tmp_path},"
        f"engines=(ref=(engine=ref),fused=(engine=torch,device=cpu,"
        f"keep_all_nodes=1),percall=(engine=torch,device=cpu,fuse=0)),"
        f"kg_digests_fn={DATA / 'tpu_digests/mini/digest-rtc.boda'})"))
    assert out.splitlines() == [
        "comp fused vs percall: PASS", "comp fused vs ref: PASS",
        "kg digests vs fused: PASS", "kg digests vs percall: PASS",
        "kg digests vs ref: PASS"]
    assert sorted(p.name for p in tmp_path.glob("digest-*.boda")) == [
        "digest-fused.boda", "digest-percall.boda", "digest-ref.boda"]


def test_compute_multi_reports_a_mismatch(tmp_path):
    with pytest.raises(RtErr, match="test_compute_multi: 1 mismatches"):
        _capture(create_and_run_has_main, (
            f"(mode=test_compute_multi,model=mini,batch=1,write_digests=0,"
            f"engines=(ref=(engine=ref),q=(engine=torch,device=cpu,"
            f"quantize=((name=prob,max_val=1,keep_bits=1)))))"))


def test_comp_ndas(tmp_path):
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    d = dims.Dims.make(a=3, b=4)
    for name, v in (("a", x), ("b", x * (1 + 1e-6)), ("c", x + 1)):
        (tmp_path / name).write_bytes(dims.NDA(d, v).bwrite())
    assert _capture(create_and_run_has_main, (
        f"(mode=comp_ndas,a_fn={tmp_path / 'a'},b_fn={tmp_path / 'b'})"
    )).strip() == "comp_ndas PASSED"
    with pytest.raises(RtErr, match="comp_ndas FAILED"):
        create_and_run_has_main(
            f"(mode=comp_ndas,a_fn={tmp_path / 'a'},b_fn={tmp_path / 'c'})",
            {})


@pytest.fixture()
def labeled_npy(tmp_path):
    rng = np.random.RandomState(0)
    imgs = rng.randn(10, 3, 32, 32).astype(np.float32)
    labels = rng.randint(0, 10, size=10).astype(np.int64)
    ifn, lfn = tmp_path / "imgs.npy", tmp_path / "labels.npy"
    np.save(ifn, imgs)
    np.save(lfn, labels)
    return ifn, lfn


@pytest.mark.parametrize("src", ["lmdb", "npy"])
def test_test_lmdb_matches_jax_mode(labeled_npy, src):
    ifn, lfn = labeled_npy
    spec = (f"src=(mode=lmdb-src,fn={DATA / 'lmdb-tiny'},mean=128)"
            if src == "lmdb" else
            f"src=(mode=labeled-npy-src,images_fn={ifn},labels_fn={lfn})")
    lines = []
    for run, eng in ((create_and_run_has_main, ",conv_fwd=(engine=torch,"
                                               "device=cpu)"),
                     (jhas_main.create_and_run_has_main, "")):
        out = _capture(run, f"(mode=test_lmdb,model=mini,top_k=4,"
                            f"in_dims=(dims=(img=4,chan=3,y=32,x=32)),"
                            f"{spec}{eng})")
        lines.append([ln for ln in out.splitlines() if "_acc=" in ln])
    assert lines[0] == lines[1] and len(lines[0]) == 1
    assert lines[0][0].startswith("top_4_acc=")
    assert lines[0][0].endswith("num_test=8" if src == "lmdb"
                                else "num_test=10")


def test_lmdb_src_reads_back_encoded_datums(tmp_path):
    from boda_tpu_torch.apps.eval_cls import encode_datum
    from boda_tpu_torch.io.data_stream import DataBlock
    from boda_tpu_torch.apps.eval_cls import LmdbSrc
    from boda_tpu_torch.utils.lmdbmini import write_lmdb
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, size=(5, 3, 6, 4)).astype(np.uint8)
    write_lmdb(tmp_path / "db", [(b"%08d" % i, encode_datum(im, i % 3))
                                 for i, im in enumerate(imgs)])
    src = LmdbSrc.init_from_lexp(
        f"(fn={tmp_path / 'db'},mean=128,scale=0.5)")
    src.data_stream_init()
    for i, im in enumerate(imgs):
        b = src.proc_block(DataBlock())
        np.testing.assert_array_equal(b.nda.v, (im.astype(np.float32) - 128)
                                      * 0.5)
        assert int(b.get_sdb("label").nda.v[0]) == i % 3
    assert not src.proc_block(DataBlock()).valid()
