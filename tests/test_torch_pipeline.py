"""The port's pipelines (boda_tpu_torch/parallel/{pipeline,_pipe_plan,
pp_modes}.py) on the CPU, against the JAX package's on the conftest's 8
virtual devices; the port's side runs over CPU slots.

Tolerances: gpipe_forward rtol 1e-5, atol 1e-6 (the JAX tests'); the
ResNet-50 gpipe_plan_forward rtol 1e-5 against the JAX function; the
training steps' loss and every weight gradient within 1e-4 (relative to
the largest gradient of each weight, the JAX tests' measure) of the JAX
package's at the same tune, the f32 vendor tune `(use_culibs=1)`: the
`mini` steps against the JAX pipeline functions, the ResNet-50 ones
against the JAX segments' sequential value_and_grad (which the JAX tests
hold the JAX pipelines to), and also against the JAX package's `()`
lowering, the one its own tests train through, at the same 1e-4.
"""

import numpy as np
import pytest
import torch

import boda_tpu_torch.modes  # noqa: F401  (register the port's modes)
from boda_tpu.core.error import RtErr as JRtErr
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.engine.lower import lower_pipe, resolve_plan_weights
from boda_tpu_torch.engine.segments import build_plan_segments
from boda_tpu_torch.engine.torch_fwd import _storage_out
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.cnn_variants import make_op_tune
from boda_tpu_torch.parallel.dryrun import TRAIN_TUNE
from boda_tpu_torch.parallel.mesh import Mesh
from boda_tpu_torch.parallel.pipeline import (gpipe_forward,
                                              gpipe_plan_forward,
                                              gpipe_plan_train_step,
                                              plan_train_step_1f1b,
                                              sched_1f1b,
                                              stack_stage_params)

CPU = torch.device("cpu")
RESNET_STAGES = ("stem:conv1+pool1+res2|s3:res3|s4:res4|"
                 "head:res5+pool5+fc1000-conv")
MINI_STAGES = "a:conv1|b:cccp1+pool1|c:conv2+drop|d:fc-conv+gpool"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a mesh or a pipeline runs many small ops one
    after another, and with several test processes on one machine torch's
    threads would mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(n, names=("pp",), shape=None):
    import jax
    from jax.sharding import Mesh as JMesh
    devs = np.array(jax.devices("cpu")[:n])
    return JMesh(devs.reshape(shape or (n,)), names)


def _pmesh(n, names=("pp",), shape=None):
    return Mesh(np.array([CPU] * n, dtype=object).reshape(shape or (n,)),
                names)


def _mlp_stage_jax(params, x):
    import jax.numpy as jnp
    return jnp.tanh(x @ params["w"] + params["b"])


def _mlp_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _stages(k, d, seed=0):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(d, d) * 0.3).astype(np.float32),
             "b": np.zeros(d, np.float32)} for _ in range(k)]


@pytest.mark.parametrize("pp,m", [(4, 8), (2, 3), (8, 1)])
def test_gpipe_forward_matches_jax(pp, m):
    from boda_tpu.parallel import pipeline as jpl
    stages = _stages(pp, 16)
    x = np.random.RandomState(1).randn(m, 4, 16).astype(np.float32)
    want = np.asarray(jpl.gpipe_forward(
        _mlp_stage_jax, jpl.stack_stage_params(stages), x, _jmesh(pp)))
    got = gpipe_forward(_mlp_stage, stack_stage_params(stages), x,
                        _pmesh(pp))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_gpipe_forward_on_an_axis_of_a_2d_mesh():
    """pp as one axis of a (dp, pp) mesh: every row runs the pipeline."""
    from boda_tpu.parallel import pipeline as jpl
    stages = _stages(4, 8, seed=3)
    x = np.random.RandomState(2).randn(5, 2, 8).astype(np.float32)
    want = np.asarray(jpl.gpipe_forward(
        _mlp_stage_jax, jpl.stack_stage_params(stages), x,
        _jmesh(8, ("dp", "pp"), (2, 4)), axis="pp"))
    got = gpipe_forward(_mlp_stage, stack_stage_params(stages), x,
                        _pmesh(8, ("dp", "pp"), (2, 4)), axis="pp")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_stack_stage_params_refusals():
    with pytest.raises(RtErr, match="no stages"):
        stack_stage_params([])
    with pytest.raises(RtErr, match="structures differ"):
        stack_stage_params([{"w": np.zeros(2)}, {"v": np.zeros(2)}])


def _segmented(model, tune, stages, **kw):
    """The port's (pipe, plan, weights, segments) and the JAX package's,
    lowered under tune (`()` where empty) and cut into the same stages."""
    from boda_tpu.engine.lower import lower_pipe as jlower
    from boda_tpu.engine.lower import resolve_plan_weights as jresolve
    from boda_tpu.engine.segments import build_plan_segments as jsegments
    from boda_tpu.models.zoo import build_model as jbuild
    from boda_tpu.ops.cnn_variants import make_op_tune as jtune
    out = []
    pipe = build_model(model, **kw)
    plan = lower_pipe(pipe, make_op_tune(tune) if tune else None)
    w = {n: torch.from_numpy(np.ascontiguousarray(v))
         for n, v in resolve_plan_weights(plan, pipe.op_params).items()}
    out.append((pipe, plan, w, build_plan_segments(plan, w, stages, CPU)))
    jpipe = jbuild(model, **kw)
    jplan = jlower(jpipe, jtune(tune) if tune else None)
    jw = jresolve(jplan, jpipe.op_params)
    out.append((jpipe, jplan, jw, jsegments(jplan, jw, stages)))
    return out


def test_gpipe_plan_forward_matches_jax():
    """ResNet-50 (32x32, b2, 16 classes) cut at its residual stages, M=3,
    under `()`: B1 and B2 in every stage."""
    from boda_tpu.parallel import pipeline as jpl
    (pipe, plan, w, segs), (_jp, jplan, jw, jsegs) = _segmented(
        "resnet-50", "", RESNET_STAGES + "+prob", batch=2, ysz=32, xsz=32,
        num_classes=16)
    d = pipe.get_data_img_dims()
    x_mb = (np.random.RandomState(0).randn(3, *d.shape) * 0.1
            ).astype(np.float32)
    got = gpipe_plan_forward(plan, segs, w, x_mb, _pmesh(4))
    want = np.asarray(jpl.gpipe_plan_forward(jplan, jsegs, jw, x_mb,
                                             _jmesh(4)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _loss_fns(plan, jplan, out_node):
    import jax
    import jax.numpy as jnp

    from boda_tpu.engine.rtc_fwd import _storage_out as jstorage_out

    def loss_fn(y_storage, labs):
        y = _storage_out(y_storage, plan.node_dims[out_node], plan)
        logp = torch.log_softmax(y[:, :, 0, 0].float(), dim=1)
        return -torch.take_along_dim(logp, labs.long()[:, None],
                                     dim=1).mean()

    def jloss_fn(y_storage, labs):
        y = jstorage_out(y_storage, jplan.node_dims[out_node], jplan)
        logp = jax.nn.log_softmax(y[:, :, 0, 0].astype(jnp.float32), axis=1)
        return -jnp.mean(jnp.take_along_axis(logp, labs[:, None], 1))
    return loss_fn, jloss_fn


def _jax_sequential(jplan, jsegs, jw, x_mb, labels, jloss_fn):
    import jax
    import jax.numpy as jnp

    from boda_tpu.engine.rtc_fwd import _storage_in as jstorage_in

    def seq_loss(w):
        tot = jnp.float32(0)
        for i in range(len(x_mb)):
            v = jstorage_in(x_mb[i], jplan)
            for s in jsegs:
                v = s.fn(v, *[w[n] for n in s.weight_names])
            tot = tot + jloss_fn(v, jnp.asarray(labels[i]))
        return tot
    return jax.jit(jax.value_and_grad(seq_loss))(
        {n: jw[n] for s in jsegs for n in s.weight_names})


def _assert_grads(loss, g, want_loss, want_g, tol=1e-4):
    assert abs(float(loss) - float(want_loss)) \
        <= tol * max(abs(float(want_loss)), 1e-6), \
        (float(loss), float(want_loss))
    assert set(g) == set(want_g)
    for n in sorted(want_g):
        a = g[n].double().numpy()
        b = np.asarray(want_g[n], np.float64)
        m = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert m < tol, (n, m)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_mini_train_steps_match_jax(schedule):
    """mini cut in 4 stages, M=6 > K=4 (steady-state 1F1B ticks): the port's
    step against the JAX package's step at the same tune."""
    from boda_tpu.parallel import pipeline as jpl
    (pipe, plan, w, segs), (_jp, jplan, jw, jsegs) = _segmented(
        "mini", TRAIN_TUNE, MINI_STAGES, batch=2)
    rng = np.random.RandomState(0)
    d = pipe.get_data_img_dims()
    M = 6
    x_mb = (rng.randn(M, *d.shape) * 0.5).astype(np.float32)
    labels = rng.randint(0, 10, size=(M, d.shape[0])).astype(np.int32)
    loss_fn, jloss_fn = _loss_fns(plan, jplan, "gpool")
    step, jstep = {"gpipe": (gpipe_plan_train_step,
                             jpl.gpipe_plan_train_step),
                   "1f1b": (plan_train_step_1f1b,
                            jpl.plan_train_step_1f1b)}[schedule]
    loss, g = step(plan, segs, w, x_mb, labels, _pmesh(4), loss_fn)
    want_loss, want_g = jstep(jplan, jsegs, jw, x_mb, labels, _jmesh(4),
                              jloss_fn)
    _assert_grads(loss, g, want_loss, want_g)


@pytest.fixture(scope="module")
def resnet50_case():
    """ResNet-50 (32x32, b2, 16 classes) cut at its residual stages, M=3:
    the port's plan under TRAIN_TUNE, its inputs and loss, and the JAX
    segments' sequential (loss, grads) at the same tune and at `()`."""
    (pipe, plan, w, segs), (_jp, jplan, jw, jsegs) = _segmented(
        "resnet-50", TRAIN_TUNE, RESNET_STAGES, batch=2, ysz=32, xsz=32,
        num_classes=16)
    _, (_jp0, jplan0, jw0, jsegs0) = _segmented(
        "resnet-50", "", RESNET_STAGES, batch=2, ysz=32, xsz=32,
        num_classes=16)
    rng = np.random.RandomState(0)
    d = pipe.get_data_img_dims()
    M = 3
    x_mb = (rng.randn(M, *d.shape) * 0.1).astype(np.float32)
    labels = rng.randint(0, 16, size=(M, d.shape[0])).astype(np.int32)
    loss_fn, jloss_fn = _loss_fns(plan, jplan, "fc1000-conv")
    _, jloss_fn0 = _loss_fns(plan, jplan0, "fc1000-conv")
    want = {"same": _jax_sequential(jplan, jsegs, jw, x_mb, labels,
                                    jloss_fn),
            "jax()": _jax_sequential(jplan0, jsegs0, jw0, x_mb, labels,
                                     jloss_fn0)}
    return plan, w, segs, x_mb, labels, loss_fn, want


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_resnet50_train_steps_match_jax(resnet50_case, schedule):
    """Each schedule's loss and grads against the JAX segments' sequential
    grads, at the port's tune and at the JAX package's `()`."""
    plan, w, segs, x_mb, labels, loss_fn, want = resnet50_case
    step = {"gpipe": gpipe_plan_train_step,
            "1f1b": plan_train_step_1f1b}[schedule]
    loss, g = step(plan, segs, w, x_mb, labels, _pmesh(4), loss_fn)
    for want_loss, want_g in want.values():
        _assert_grads(loss, g, want_loss, want_g)


def test_sched_1f1b_tables_equal_the_jax_package():
    from boda_tpu.parallel.pipeline import sched_1f1b as jsched
    for K in range(1, 9):
        for M in range(1, 13):
            T, act, mb = sched_1f1b(K, M)
            jT, jact, jmb = jsched(K, M)
            assert T == jT and act.dtype == jact.dtype
            np.testing.assert_array_equal(act, jact)
            np.testing.assert_array_equal(mb, jmb)


def test_errors_keep_the_jax_messages():
    """Each refusal of the pipelines, with the JAX package's message."""
    from boda_tpu.parallel import pipeline as jpl
    (pipe, plan, w, segs), (_jp, jplan, jw, jsegs) = _segmented(
        "mini", TRAIN_TUNE, MINI_STAGES, batch=2)
    d = pipe.get_data_img_dims()
    x = np.zeros((2, *d.shape), np.float32)
    lab = np.zeros((2, d.shape[0]), np.int32)
    loss_fn, jloss_fn = _loss_fns(plan, jplan, "gpool")
    bad_order = [0, 2, 1, 3]

    def variant(sg, first, **kw):
        """sg's segments, the first or last one remade with kw changed:
        each package's own PlanSegment class."""
        k = 0 if first else -1
        s0 = sg[k]
        f = dict(name=s0.name, steps=s0.steps, fn=s0.fn,
                 weight_names=s0.weight_names, in_node=s0.in_node,
                 out_node=s0.out_node, flops=s0.flops,
                 zero_init=s0.zero_init)
        f.update(kw)
        out = list(sg)
        out[k] = type(s0)(**f)
        return out
    # the last stage also claims the first stage's filter; the first stage
    # reads a node the plan does not have
    dup = variant(segs, False, weight_names=segs[-1].weight_names
                  + (segs[0].weight_names[0],))
    jdup = variant(jsegs, False, weight_names=jsegs[-1].weight_names
                   + (jsegs[0].weight_names[0],))
    nowhere = variant(segs, True, in_node="nowhere")
    jnowhere = variant(jsegs, True, in_node="nowhere")
    cases = [
        (lambda: gpipe_plan_forward(plan, segs, w, x, _pmesh(2)),
         lambda: jpl.gpipe_plan_forward(jplan, jsegs, jw, x, _jmesh(2))),
        (lambda: gpipe_plan_forward(plan, [segs[i] for i in bad_order], w,
                                    x, _pmesh(4)),
         lambda: jpl.gpipe_plan_forward(jplan, [jsegs[i] for i in bad_order],
                                        jw, x, _jmesh(4))),
        (lambda: gpipe_plan_forward(plan, segs, w, x[:0], _pmesh(4)),
         lambda: jpl.gpipe_plan_forward(jplan, jsegs, jw, x[:0], _jmesh(4))),
        (lambda: gpipe_forward(None, {}, x[:0], _pmesh(4)),
         lambda: jpl.gpipe_forward(None, {}, x[:0], _jmesh(4))),
        (lambda: gpipe_plan_forward(plan, nowhere, w, x, _pmesh(4)),
         lambda: jpl.gpipe_plan_forward(jplan, jnowhere, jw, x, _jmesh(4))),
        (lambda: gpipe_plan_forward(plan, dup, w, x, _pmesh(4)),
         lambda: jpl.gpipe_plan_forward(jplan, jdup, jw, x, _jmesh(4))),
    ]
    for step, jstep in ((gpipe_plan_train_step, jpl.gpipe_plan_train_step),
                        (plan_train_step_1f1b, jpl.plan_train_step_1f1b)):
        cases += [
            (lambda s=step: s(plan, segs, w, x, lab[:1], _pmesh(4), loss_fn),
             lambda s=jstep: s(jplan, jsegs, jw, x, lab[:1], _jmesh(4),
                               jloss_fn)),
            (lambda s=step: s(plan, segs, w, x[:0], lab[:0], _pmesh(4),
                              loss_fn),
             lambda s=jstep: s(jplan, jsegs, jw, x[:0], lab[:0], _jmesh(4),
                               jloss_fn)),
            (lambda s=step: s(plan, dup, w, x, lab, _pmesh(4), loss_fn),
             lambda s=jstep: s(jplan, jdup, jw, x, lab, _jmesh(4),
                               jloss_fn))]
    for port, jax_ in cases:
        with pytest.raises(JRtErr) as want:
            jax_()
        with pytest.raises(RtErr) as got:
            port()
        assert str(got.value) == str(want.value)


def test_training_through_the_hand_kernels_is_refused():
    """Under `()` the stages run B1/B2, which have no backward: both
    training schedules raise before the first tick, naming the step."""
    pipe = build_model("mini", batch=2)
    plan = lower_pipe(pipe)
    w = {n: torch.from_numpy(np.ascontiguousarray(v))
         for n, v in resolve_plan_weights(plan, pipe.op_params).items()}
    segs = build_plan_segments(plan, w, MINI_STAGES, CPU)
    x = np.zeros((2, *pipe.get_data_img_dims().shape), np.float32)
    lab = np.zeros((2, 2), np.int32)
    for step in (gpipe_plan_train_step, plan_train_step_1f1b):
        with pytest.raises(RtErr, match="which has no backward"):
            step(plan, segs, w, x, lab, _pmesh(4), lambda y, lb: y.sum())


def test_pp_test_mode(monkeypatch, capsys):
    """The pp_test CLI self-check passes both schedules on 4 CPU slots
    (the JAX test's lines: tests/test_pipeline.py:374-382)."""
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    monkeypatch.setenv("BODA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("BODA_TORCH_LOCAL_DEVICES", "1")
    create_and_run_has_main(
        "(mode=pp_test,model=mini,microbatches=5,schedule=both,"
        "local_devices=8)", {})
    out = capsys.readouterr().out
    assert "pp_test gpipe model=mini pp=4 M=5: PASSED" in out
    assert "pp_test 1f1b model=mini pp=4 M=5: PASSED" in out


def test_pp_test_refusals(monkeypatch):
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    monkeypatch.setenv("BODA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("BODA_TORCH_LOCAL_DEVICES", "2")
    for spec, err in [
            ("(mode=pp_test,schedule=zigzag)", "unknown schedule 'zigzag'"),
            ("(mode=pp_test,model=vgg-19)", "no default stage spec"),
            ("(mode=pp_test,pp=3)", "yields 4 segments != pp=3"),
            ("(mode=pp_test)", r"2 devices < pp=4 \(use --local-devices\)")]:
        with pytest.raises(RtErr, match=err):
            create_and_run_has_main(spec, {})
