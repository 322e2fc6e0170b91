"""The port's backward templates (BckConv, Spreading, bck_lrn in
ops/cuda/bck.py; sm_grad_and_loss, sum_loss_over_imgs in ops/cuda/
softmax.py) against the JAX templates and their float64 references, on the
steps graph/pipe.add_bck_ops gives a small net; and the twin of
tests/test_mxu_grad.py's test_autodiff_matches_add_bck_ops: the
backward-op plan on engine=ref against autograd of the bf16 fused program,
in the port, beside the JAX package's own numbers.

Tolerances: the templates in f32 at rtol 1e-5 (f32 summing order) against
the JAX templates and 1e-4 against the float64 references; the two
training paths at the JAX test's 3e-2 (loss) and 5e-2 (gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.core.dims import NDA as JNDA
from boda_tpu.engine.iface import make_engine as jmake_engine
from boda_tpu.engine.lower import lower_pipe as jlower_pipe
from boda_tpu.engine.lower import resolve_plan_weights as jresolve
from boda_tpu.engine.rtc_fwd import build_fused_forward
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.ops.cnn_variants import make_op_tune as jmake_op_tune
from boda_tpu.ops.registry import get_template as jget_template
from boda_tpu_torch.apps.train import batch_loss, train_forward
from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.engine.lower import lower_pipe
from boda_tpu_torch.engine.torch_fwd import weights_to_torch
from boda_tpu_torch.models.zoo import NetBuilder
from boda_tpu_torch.ops.cnn_variants import make_op_tune
from boda_tpu_torch.ops.registry import get_template

BCK = ("BckConv", "Spreading", "bck_lrn", "sm_grad_and_loss",
       "sum_loss_over_imgs")


def _mrd(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _net(mod, with_loss=True, lrn=True, avg=False):
    """A small net whose backward plan has every backward template: two
    convs (3x3 and a strided 3x3), a max or avg pool, an LRN, a 1x1 fc
    conv, the global pool and the loss."""
    b = mod("bnet", 2, 3, 12, 12)
    b.conv("conv1", 8, 3, 1, 1)
    b.pool("pool1", 3, 2, avg=avg)
    if lrn:
        b.lrn("norm1", local_size=3, alpha=1e-2, beta=0.75)
    b.conv("conv2", 6, 3, 2, 1)
    b.conv("fc", 4, 1, relu=False)
    b.pool("gpool", 0, 1, avg=True, global_=True)
    if with_loss:
        b.softmax_with_loss("loss")
    return b.done(seed=7)


def _bck_steps(avg=False):
    """{template: [(port sig, JAX sig), ...]} of the backward plan of the
    small net, lowered by both packages."""
    pipe, jpipe = _net(NetBuilder, avg=avg), _net(JNetBuilder, avg=avg)
    pipe.add_bck_ops()
    jpipe.add_bck_ops()
    plan = lower_pipe(pipe, make_op_tune("()"))
    jplan = jlower_pipe(jpipe, jmake_op_tune("()"))
    out = {}
    for s, js in zip(plan.steps, jplan.steps):
        assert s.call_tag == js.call_tag
        if s.func_name in BCK:
            out.setdefault(s.func_name, []).append((s.sig, js.sig))
    return out


def _inputs(tmpl, rfs, rng):
    """Seeded inputs of a template's in args (labels in range)."""
    ins = []
    for an in tmpl.in_args():
        if an not in rfs.nda_vals:
            continue
        d = rfs.get_dims(an)
        if an == "label":
            ins.append(rng.randint(0, rfs.get_dims("in")["chan"],
                                   size=d.shape).astype(np.float32))
        else:
            ins.append(rng.randn(*d.shape).astype(np.float32))
    return ins


@pytest.mark.parametrize("avg", [False, True])
def test_bck_templates_match_jax_and_ref(avg):
    steps = _bck_steps(avg)
    assert set(steps) == set(BCK)
    rng = np.random.RandomState(4)
    for name, pairs in steps.items():
        pt, jt = get_template(name), jget_template(name)
        for sig, jsig in pairs:
            rfs, jrfs = pt.check_args(sig), jt.check_args(jsig)
            assert str(rfs) == str(jrfs)
            assert pt.flops(rfs) == jt.flops(jrfs)
            ins = _inputs(pt, rfs, rng)
            if name == "Spreading" and not avg:
                # its `out` is the pool's output of `in` (the reference
                # masks the window positions equal to it)
                from boda_tpu_torch.ops.cuda.pool import Pool
                ins[1] = Pool.build(rfs)(torch.from_numpy(ins[0])).numpy()
            got = pt.build(rfs)(*map(torch.from_numpy, ins))
            want = jt.build(jrfs)(*ins)
            ref = pt.ref_impl(rfs, *ins)
            jref = jt.ref_impl(jrfs, *ins)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            jref = jref if isinstance(jref, tuple) else (jref,)
            for g, w, r, jr in zip(got, want, ref, jref):
                np.testing.assert_array_equal(np.asarray(r), np.asarray(jr))
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           rtol=1e-4, atol=1e-5)


def test_bck_plan_runs_on_engine_ref_and_matches_jax():
    # the whole backward-op plan on the port's engine=ref against the JAX
    # package's engine=ref, on the same inputs
    pipe, jpipe = _net(NetBuilder), _net(JNetBuilder)
    pipe.add_bck_ops()
    jpipe.add_bck_ops()
    rng = np.random.RandomState(3)
    d = pipe.get_data_img_dims()
    x = (rng.randn(*d.shape) * 0.1).astype(np.float32)
    ld = pipe.must_get_node("label").dims
    label = rng.randint(0, 4, size=ld.shape).astype(ld.dtype)
    names = ["conv1_filts_grad_loss", "conv2_filts_grad_loss",
             "fc_filts_grad_loss", "data_grad_loss", "loss"]
    eng, jeng = make_engine("ref"), jmake_engine("ref")
    eng.init(pipe)
    jeng.init(jpipe)
    got = eng.run_fwd({"data": NDA(d, x), "label": NDA(ld, label)}, names)
    want = jeng.run_fwd({"data": JNDA(jpipe.get_data_img_dims(), x),
                         "label": JNDA(jpipe.must_get_node("label").dims,
                                       label)}, names)
    for n in names:
        np.testing.assert_allclose(got[n].v, want[n].v, rtol=1e-6,
                                   atol=1e-9)


def test_autodiff_matches_add_bck_ops():
    """The two training paths agree in the port: the backward-op IR
    (graph/pipe.add_bck_ops -> BckConv/Spreading/... on engine=ref) and
    autograd of the bf16 fused program through ops/mxu_grad's VJP; same
    net, weights and loss semantics (sm_grad_and_loss: the SUM over images
    of -log softmax[label]), and the JAX package's autodiff beside it."""
    def build(mod, with_loss):
        b = mod("xnet", 2, 3, 12, 12)
        b.conv("conv1", 8, 3, 1, 1)
        b.pool("pool1", 2, 2)
        b.conv("fc", 4, 1, relu=False)
        b.pool("gpool", 0, 1, avg=True, global_=True)
        if with_loss:
            b.softmax_with_loss("loss")
        return b.done(seed=11)

    rng = np.random.RandomState(3)
    bpipe = build(NetBuilder, True)
    bpipe.add_bck_ops()
    d = bpipe.get_data_img_dims()
    x = (rng.randn(*d.shape) * 0.1).astype(np.float32)
    ld = bpipe.must_get_node("label").dims
    label = rng.randint(0, 4, size=ld.shape).astype(ld.dtype)
    eng = make_engine("ref")
    eng.init(bpipe)
    want = eng.run_fwd(
        {"data": NDA(d, x), "label": NDA(ld, label)},
        ["conv1_filts_grad_loss", "fc_filts_grad_loss", "loss"])
    loss_ref = float(want["loss"].v.sum())

    tune = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0)"
    fpipe = build(NetBuilder, False)
    plan = lower_pipe(fpipe, make_op_tune(tune), fused_storage=True)
    cpu = torch.device("cpu")
    w = {k: v.requires_grad_(True)
         for k, v in weights_to_torch(plan, fpipe.op_params, cpu).items()}
    li = torch.from_numpy(label.reshape(ld.shape[0]).astype(np.int64))
    loss = batch_loss(train_forward(plan, cpu, "gpool"), "data", "gpool",
                      True, w, torch.from_numpy(x), li) * ld.shape[0]
    g = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
    loss = float(loss.detach())
    assert _mrd(loss, loss_ref) < 3e-2
    assert _mrd(g["conv1_filts"], want["conv1_filts_grad_loss"].v) < 5e-2
    assert _mrd(g["fc_filts"], want["fc_filts_grad_loss"].v) < 5e-2

    # the JAX package's autodiff of the same program, as its test runs it
    jpipe = build(JNetBuilder, False)
    jplan = jlower_pipe(jpipe, jmake_op_tune(tune), fused_storage=True)
    jfwd = build_fused_forward(jplan)
    jw = jresolve(jplan, jpipe.op_params)
    jli = jnp.asarray(label.reshape(ld.shape[0]).astype(np.int32))

    def jloss(wv):
        logits = jfwd({"data": x}, wv)["gpool"][:, :, 0, 0] \
            .astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=1)
        return -jnp.sum(jnp.take_along_axis(logp, jli[:, None], axis=1))
    jv, jg = jax.value_and_grad(jloss)(jw)
    assert _mrd(loss, float(jv)) < 1e-5
    for k in ("conv1_filts", "fc_filts"):
        assert _mrd(g[k], jg[k]) < 2e-2, k


def test_templates_port_sigs_match():
    # the five templates the JAX package has for training are the port's
    # too, with its declared args and sig keys
    for name in BCK:
        pt, jt = get_template(name), jget_template(name)
        assert (pt.in_args(), pt.out_args(), pt.io_args()) == \
            (jt.in_args(), jt.out_args(), jt.io_args())
        assert (pt.sig_nda_keys, pt.sig_str_keys) == \
            (jt.sig_nda_keys, jt.sig_str_keys)
