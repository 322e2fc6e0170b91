"""The port's training path (apps/train.py: build_train_step, cnet_train and
its solver features, the snapshot and weights writers; apps/cnet_bench.py
train_bench; engine/segments.py remat) against the JAX package on the CPU.

- The step on `mini`: SGD, momentum, Adam, with clipping, weight decay and
  param mults: losses and weights within mrd 1e-4 of the JAX step under
  the f32 tune (use_culibs=1) over three steps (f32 summing order); the
  gradients within mrd 2e-2 under the bf16 headline tune (bf16 rounds at
  other places than XLA does: the cotangent chain's order of sums).
- The solver features as twins of tests/test_synth_train.py's
  TestTrainFeatures, TestClipGradients, TestWeightDecay, TestParamMults
  and TestLrPolicy, with the same assertions.
- The files: snapshot, trained-weights artifact, caffemodel and prototxt
  bytes equal to the JAX writers' on the same contents, and each package
  reading the other's snapshot to resume.
- Remat (torch.utils.checkpoint segments) gives the plain gradients, and
  a resumed run the uninterrupted run's losses and weights, bit for bit.
"""

import numpy as np
import pytest
import torch

import boda_tpu.apps.eval_cls  # noqa: F401 (registers shapes-src/lmdb-src)
import boda_tpu.apps.train as jtrain
import boda_tpu_torch.apps.eval_cls  # noqa: F401
import boda_tpu_torch.modes  # noqa: F401 (registers cnet_train)
from boda_tpu.core.has_main import create_and_run_has_main as jrun
from boda_tpu.engine.lower import lower_pipe as jlower_pipe
from boda_tpu.engine.lower import resolve_plan_weights as jresolve
from boda_tpu.engine.rtc_fwd import build_fused_forward
from boda_tpu.graph import caffe_io as jcaffe_io
from boda_tpu.models.zoo import build_model as jbuild_model
from boda_tpu.ops.cnn_variants import make_op_tune as jmake_op_tune
from boda_tpu_torch.apps import train
from boda_tpu_torch.apps.train import (batch_loss, build_train_step,
                                       init_opt_state, train_forward,
                                       train_top)
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.has_main import create_and_run_has_main
from boda_tpu_torch.engine.lower import lower_pipe
from boda_tpu_torch.engine.segments import build_remat_forward, \
    parse_stages_spec
from boda_tpu_torch.engine.torch_fwd import weights_to_torch
from boda_tpu_torch.graph import caffe_io
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.cnn_variants import make_op_tune

CPU = torch.device("cpu")
F32 = "(use_culibs=1)"
HEADLINE = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"


def _mrd(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def run_mode(s):
    return create_and_run_has_main(s, global_vars={})


def _mini_batches(n_steps, batch=4, seed=0):
    pipe = build_model("mini", batch=batch)
    d = pipe.get_data_img_dims()
    rng = np.random.RandomState(seed)
    return [((rng.randn(*d.shape) * 0.1).astype(np.float32),
             rng.randint(0, 10, size=(batch,)).astype(np.int32))
            for _ in range(n_steps)]


def _port_steps(tune, batches, **kw):
    pipe = build_model("mini", batch=batches[0][0].shape[0])
    plan = lower_pipe(pipe, make_op_tune(tune), fused_storage=True,
                      train_dropout=False)
    top, from_logits = train_top(pipe, plan)
    step = build_train_step(train_forward(plan, CPU, top), "data", top,
                            from_logits=from_logits, **kw)
    w = weights_to_torch(plan, pipe.op_params, CPU)
    vel = init_opt_state(kw.get("optimizer", "sgd"), w)
    losses = []
    for x, lb in batches:
        loss, w, vel = step(w, vel, torch.from_numpy(x),
                            torch.from_numpy(lb))
        losses.append(float(loss))
    return losses, {k: v.numpy() for k, v in w.items()}


def _jax_steps(tune, batches, **kw):
    pipe = jbuild_model("mini", batch=batches[0][0].shape[0])
    plan = jlower_pipe(pipe, jmake_op_tune(tune), fused_storage=True)
    top = "prob"
    top_op = next(op for op in pipe.ops.values() if top in op.tops)
    top = top_op.bots[0]
    step = jtrain.build_train_step(
        build_fused_forward(plan, extra_out_nodes=(top,)), "data", top,
        from_logits=True, **kw)
    w = jresolve(plan, pipe.op_params)
    vel = jtrain.init_opt_state(kw.get("optimizer", "sgd"), w)
    losses = []
    for x, lb in batches:
        loss, w, vel = step(w, vel, x, lb)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in w.items()}


STEP_KW = {
    "sgd": dict(lr=0.05, optimizer="sgd"),
    "momentum": dict(lr=0.05, optimizer="momentum", momentum=0.9,
                     weight_decay=1e-3),
    "adam": dict(lr=0.01, optimizer="adam"),
    "sgd-clip-mults": dict(lr=0.2, optimizer="sgd", clip_gradients=0.5,
                           weight_decay=5e-3,
                           param_mults={"conv1_filts": (0.0, 0.0),
                                        "fc-conv_filts": (2.0, 0.5)}),
}


@pytest.mark.parametrize("name", list(STEP_KW))
def test_train_steps_match_jax_f32(name):
    batches = _mini_batches(3)
    pl, pw = _port_steps(F32, batches, **STEP_KW[name])
    jl, jw = _jax_steps(F32, batches, **STEP_KW[name])
    assert _mrd(pl, jl) < 1e-4, (pl, jl)
    assert set(pw) == set(jw)
    for k in pw:
        assert _mrd(pw[k], jw[k]) < 1e-4, k
    if name == "sgd-clip-mults":  # lr_mult 0 freezes the blob exactly
        pipe = build_model("mini", batch=4)
        np.testing.assert_array_equal(pw["conv1_filts"],
                                      pipe.op_params["conv1_filts"].v)


def test_headline_gradients_match_jax():
    # one batch under the bf16 headline tune: the port's gradients (the
    # ops/mxu_grad VJP) against the JAX package's (mxu_conv's)
    import jax
    import jax.numpy as jnp
    (x, lb), = _mini_batches(1)
    pipe = build_model("mini", batch=4)
    plan = lower_pipe(pipe, make_op_tune(HEADLINE), fused_storage=True,
                      train_dropout=False)
    top, _ = train_top(pipe, plan)
    w = {k: v.requires_grad_(True)
         for k, v in weights_to_torch(plan, pipe.op_params, CPU).items()}
    loss = batch_loss(train_forward(plan, CPU, top), "data", top, True, w,
                      torch.from_numpy(x), torch.from_numpy(lb))
    g = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))

    jpipe = jbuild_model("mini", batch=4)
    jplan = jlower_pipe(jpipe, jmake_op_tune(HEADLINE), fused_storage=True)
    jfwd = build_fused_forward(jplan, extra_out_nodes=(top,))

    def jloss(wv):
        p = jfwd({"data": x}, wv)[top]
        p = p.mean(axis=(2, 3)).astype(jnp.float32)
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(p, axis=1), jnp.asarray(lb)[:, None], 1))
    jv, jg = jax.value_and_grad(jloss)(jresolve(jplan, jpipe.op_params))
    assert abs(float(loss.detach()) - float(jv)) < 1e-4
    assert set(g) == set(jg)
    for k in g:
        assert _mrd(g[k], jg[k]) < 2e-2, k


def test_grad_q8_sites_train_like_jax():
    # the grad_q8 preset's knob on mini's eligible convs: the int8 weight
    # gradients (wgrad_q8's plain version on the CPU) within the JAX
    # package's own bound against the bf16 VJP (6e-2), and the port's
    # grad_q8 step against the JAX package's
    batches = _mini_batches(2)
    pipe = build_model("mini", batch=4)
    pats = {op.tag: HEADLINE[:-1] + ",grad_q8=1)" for op in pipe.ops.values()
            if op.type == "Convolution"
            and op.get_dims("filts")["in_chan"] >= 16}
    assert pats
    kw = dict(lr=0.05, optimizer="sgd")

    def port(op_tunes):
        plan = lower_pipe(pipe, make_op_tune(HEADLINE), op_tunes=op_tunes,
                          fused_storage=True, train_dropout=False)
        top, fl = train_top(pipe, plan)
        step = build_train_step(train_forward(plan, CPU, top), "data", top,
                                from_logits=fl, **kw)
        w = weights_to_torch(plan, pipe.op_params, CPU)
        for x, lb in batches:
            loss, w, _ = step(w, {}, torch.from_numpy(x),
                              torch.from_numpy(lb))
        return plan, float(loss), {k: v.numpy() for k, v in w.items()}
    plan, lq, wq = port({t: make_op_tune(s) for t, s in pats.items()})
    assert sum(s.sig.get_u32_or("grad_q8", 0) for s in plan.steps) == \
        len(pats)
    _, lb_, wb = port(None)
    for k in wb:
        assert _mrd(wq[k], wb[k]) < 6e-2, k
    jpipe = jbuild_model("mini", batch=4)
    jplan = jlower_pipe(jpipe, jmake_op_tune(HEADLINE), op_tunes={
        t: jmake_op_tune(s) for t, s in pats.items()}, fused_storage=True)
    top = "fc-conv"
    jstep = jtrain.build_train_step(
        build_fused_forward(jplan, extra_out_nodes=(top,)), "data", top,
        from_logits=True, **kw)
    jw = jresolve(jplan, jpipe.op_params)
    for x, lb in batches:
        jl, jw, _ = jstep(jw, {}, x, lb)
    assert abs(lq - float(jl)) < 1e-3
    for k in wq:
        assert _mrd(wq[k], np.asarray(jw[k])) < 2e-2, k


def _zoo_net(mod):
    """A net with a concat of two branches (the in-place copy into its
    buffer), an LRN, a seeded train-mode dropout, an eltwise sum and a max
    pool: the non-conv templates a training forward differentiates."""
    b = mod("znet", 2, 3, 12, 12)
    b.conv("c1", 8, 3, 1, 1)
    b.lrn("n1", local_size=3, alpha=1e-2, beta=0.75)
    b.pool("p1", 3, 2)
    b.conv("ba", 6, 1, in_node="p1")
    b.conv("bb", 6, 3, 1, 1, in_node="p1")
    b.concat("cat", ["ba", "bb"])
    b.dropout("drop", 0.3)
    b.conv("bc", 12, 1, relu=False, in_node="p1")
    b.eltwise("sum", ["cat", "bc"])
    b.conv("fc", 5, 1, relu=False)
    b.pool("gpool", 0, 1, avg=True, global_=True)
    return b.done(seed=3)


@pytest.mark.parametrize("tune,toler", [(F32, 1e-4), (HEADLINE, 2e-2)])
def test_concat_lrn_dropout_net_trains_like_jax(tune, toler):
    from boda_tpu.engine.lower import DROP_SEED_NODE as JSEED
    from boda_tpu.models.zoo import NetBuilder as JNetBuilder
    from boda_tpu_torch.engine.lower import DROP_SEED_NODE
    from boda_tpu_torch.models.zoo import NetBuilder
    rng = np.random.RandomState(6)
    x = (rng.randn(2, 3, 12, 12) * 0.5).astype(np.float32)
    lb = np.array([1, 4], np.int32)
    kw = dict(lr=0.1, optimizer="momentum")
    pipe = _zoo_net(NetBuilder)
    plan = lower_pipe(pipe, make_op_tune(tune), fused_storage=True,
                      train_dropout=True)
    assert DROP_SEED_NODE in plan.input_nodes
    assert {"copy", "lrn", "dropout", "eltwise"} <= \
        {st.func_name for st in plan.steps}
    step = build_train_step(train_forward(plan, CPU, "gpool"), "data",
                            "gpool", from_logits=True,
                            seed_node=DROP_SEED_NODE, **kw)
    w = weights_to_torch(plan, pipe.op_params, CPU)
    vel = init_opt_state("momentum", w)
    jpipe = _zoo_net(JNetBuilder)
    jplan = jlower_pipe(jpipe, jmake_op_tune(tune), fused_storage=True,
                        train_dropout=True)
    jstep = jtrain.build_train_step(build_fused_forward(jplan), "data",
                                    "gpool", from_logits=True,
                                    seed_node=JSEED, **kw)
    jw = jresolve(jplan, jpipe.op_params)
    jv = jtrain.init_opt_state("momentum", jw)
    for i in range(2):
        loss, w, vel = step(w, vel, torch.from_numpy(x),
                            torch.from_numpy(lb), None, 7 + i)
        jl, jw, jv = jstep(jw, jv, x, lb, None, np.int32(7 + i))
        assert abs(float(loss) - float(jl)) < toler * max(abs(float(jl)), 1)
    for k in w:
        assert _mrd(w[k].numpy(), np.asarray(jw[k])) < toler, k


# ---------------------------------------------------- cnet_train's features

class TestTrainFeatures:
    def _train(self, tmp_path, extra, steps=4):
        run_mode(f"(mode=cnet_train,model=mini,batch=4,steps={steps},"
                 f"lr=0.05,seed=5,log_every=2,device=cpu,"
                 f"boda_output_dir={tmp_path},{extra})")

    def test_chunked_steps_match_single(self, tmp_path, capsys):
        """steps_per_call=2 consumes the same data and gives the same
        losses as single steps, exactly (the same ops, one readback)."""
        self._train(tmp_path, "op_tune=(use_culibs=1),loss_out_fn=l1.txt")
        self._train(tmp_path, "op_tune=(use_culibs=1),loss_out_fn=l2.txt,"
                    "steps_per_call=2")
        capsys.readouterr()
        l1 = np.loadtxt(tmp_path / "l1.txt")
        l2 = np.loadtxt(tmp_path / "l2.txt")
        np.testing.assert_array_equal(l1, l2)

    def test_chunk_divisibility_errors(self, tmp_path):
        with pytest.raises(RtErr, match="multiple of"):
            self._train(tmp_path, "steps_per_call=3")
        with pytest.raises(RtErr, match="snapshot_every"):
            self._train(tmp_path, "steps_per_call=2,snapshot_every=3")

    def test_warmup_scales_first_steps(self, tmp_path, capsys):
        self._train(tmp_path, "op_tune=(use_culibs=1),loss_out_fn=a.txt")
        self._train(tmp_path, "op_tune=(use_culibs=1),loss_out_fn=b.txt,"
                    "warmup_steps=8")
        capsys.readouterr()
        a = np.loadtxt(tmp_path / "a.txt")
        b = np.loadtxt(tmp_path / "b.txt")
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5)
        assert not np.allclose(a[1:], b[1:], rtol=1e-4)

    def test_zero_init_pats(self, tmp_path, capsys):
        self._train(tmp_path, "zero_init_pats=(a=conv2),loss_out_fn=z.txt")
        out = capsys.readouterr().out
        assert "zero-initialized filts of 1 op(s)" in out
        with pytest.raises(RtErr, match="matched no"):
            self._train(tmp_path, "zero_init_pats=(a=nosuchconv)")

    SRC = ("stream=(mode=shapes-src,num_imgs=10,ysz=32,xsz=32,"
           "num_classes=10,seed=2,mean=128,scale=0.015625)")

    def test_device_data_matches_streaming(self, tmp_path, capsys):
        self._train(tmp_path, f"op_tune=(use_culibs=1),{self.SRC},"
                    "loss_out_fn=h.txt", steps=6)
        capsys.readouterr()
        self._train(tmp_path, f"op_tune=(use_culibs=1),{self.SRC},"
                    "loss_out_fn=dv.txt,device_data=1,steps_per_call=3",
                    steps=6)
        out = capsys.readouterr().out
        assert "staged 10 u8 images" in out
        h = np.loadtxt(tmp_path / "h.txt")
        dv = np.loadtxt(tmp_path / "dv.txt")
        np.testing.assert_allclose(h, dv, rtol=1e-4, atol=1e-6)

    def test_device_data_eval_counts_match_direct_fwd(self, tmp_path,
                                                      capsys):
        """the evaluator's num_pos equals a direct recomputation (the
        inference forward on the val images with the exported artifact's
        weights), over a set that is not a multiple of the batch."""
        from boda_tpu_torch.apps.train import load_weights_into_pipe
        from boda_tpu_torch.engine.torch_fwd import build_forward
        from boda_tpu_torch.io.synth import render_shapes
        ev = ("eval_stream=(mode=shapes-src,num_imgs=9,start_ix=40,"
              "ysz=32,xsz=32,num_classes=10,seed=2,mean=128,"
              "scale=0.015625)")
        src = self.SRC.replace("num_imgs=10", "num_imgs=12")
        self._train(tmp_path, f"op_tune=(use_culibs=1),{src},{ev},"
                    "device_data=1,artifact_out_fn=w.boda", steps=6)
        out = capsys.readouterr().out
        m = [ln for ln in out.splitlines() if "top_1_acc=" in ln]
        assert len(m) == 1 and "num_test=9" in m[0]
        got_pos = int(m[0].split("num_pos=")[1].split()[0])
        pipe = build_model("mini", batch=4)
        load_weights_into_pipe(pipe, tmp_path / "w.boda")
        plan = lower_pipe(pipe, make_op_tune("(use_culibs=1)"))
        fwd = build_forward(plan, CPU)
        w = weights_to_torch(plan, pipe.op_params, CPU)
        imgs, labels = render_shapes(range(40, 49), 32, 32, 10, 2)
        x = (imgs.astype(np.float32) - 128.0) / 64.0
        pos = 0
        with torch.no_grad():
            for i0 in range(0, 9, 4):
                xb = np.zeros((4, 3, 32, 32), np.float32)
                nb = min(4, 9 - i0)
                xb[:nb] = x[i0:i0 + nb]
                p = fwd({"data": torch.from_numpy(xb)}, w)["prob"].numpy()
                pred = p.reshape(4, -1).argmax(axis=1)
                pos += int((pred[:nb] == labels[i0:i0 + nb]).sum())
        assert got_pos == pos

    def test_device_data_snapshot_resume(self, tmp_path, capsys):
        self._train(tmp_path, f"op_tune=(use_culibs=1),{self.SRC},"
                    "device_data=1,steps_per_call=2,loss_out_fn=full.txt",
                    steps=6)
        self._train(tmp_path, f"op_tune=(use_culibs=1),{self.SRC},"
                    "device_data=1,steps_per_call=2,snapshot_every=4,"
                    "snapshot_fn=s.boda", steps=4)
        capsys.readouterr()
        self._train(tmp_path, f"op_tune=(use_culibs=1),{self.SRC},"
                    f"device_data=1,steps_per_call=2,resume_fn="
                    f"{tmp_path}/s.boda,loss_out_fn=res.txt", steps=6)
        out = capsys.readouterr().out
        assert "resumed from" in out
        full = np.loadtxt(tmp_path / "full.txt")
        res = np.loadtxt(tmp_path / "res.txt")
        np.testing.assert_array_equal(full, res)

    def test_device_data_requires_stream(self, tmp_path):
        with pytest.raises(RtErr, match="device_data=1 requires a stream"):
            self._train(tmp_path, "device_data=1")

    def test_artifact_round_trip(self, tmp_path, capsys):
        from boda_tpu_torch.apps.train import (load_weights_into_pipe,
                                               read_weights_artifact)
        self._train(tmp_path, "artifact_out_fn=w.boda,op_tune=(use_culibs=1)")
        capsys.readouterr()
        w = read_weights_artifact(tmp_path / "w.boda")
        assert "conv1_filts" in w and w["conv1_filts"].dtype == np.float32
        pipe = build_model("mini", batch=4)
        init = pipe.op_params["conv1_filts"].v.copy()
        load_weights_into_pipe(pipe, tmp_path / "w.boda")
        assert not np.array_equal(pipe.op_params["conv1_filts"].v, init)
        pipe2 = build_model("mini", batch=2)  # batch-mismatched net is fine
        load_weights_into_pipe(pipe2, tmp_path / "w.boda")
        with pytest.raises(RtErr, match="not a boda_tpu trained-weights"):
            read_weights_artifact(__file__)

    def test_runs_on_the_card_by_default(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RtErr, match="device 'cuda' requested"):
            run_mode(f"(mode=cnet_train,model=mini,batch=2,steps=1,"
                     f"boda_output_dir={tmp_path})")
        with pytest.raises(RtErr, match="device 'cuda' requested"):
            run_mode("(mode=train_bench,model=mini,batch=2)")


class TestClipGradients:
    def test_clip_bounds_update_norm(self, tmp_path, capsys):
        base = (f"(mode=cnet_train,model=mini,batch=4,steps=2,lr=0.2,"
                f"seed=5,log_every=1,op_tune=(use_culibs=1),device=cpu,"
                f"boda_output_dir={tmp_path}")
        run_mode(base + ",loss_out_fn=unc.txt)")
        run_mode(base + ",clip_gradients=0.01,loss_out_fn=cl.txt)")
        capsys.readouterr()
        unc = np.loadtxt(tmp_path / "unc.txt")
        cl = np.loadtxt(tmp_path / "cl.txt")
        np.testing.assert_allclose(unc[0], cl[0], rtol=1e-5)
        assert np.isfinite(cl).all()
        assert abs(unc[1] - cl[1]) > 1e-6


def _toy_fwd(names):
    def fwd(ins, w):
        return {"p": sum(ins["data"] @ w[n] for n in names)}
    return fwd


def _toy_step(names, x, labels, w0, vel=None, n=1, **kw):
    step = build_train_step(_toy_fwd(names), "data", "p", from_logits=True,
                            **kw)
    w = {k: torch.from_numpy(v) for k, v in w0.items()}
    vel = init_opt_state(kw.get("optimizer", "sgd"), w) if vel is None \
        else vel
    for _ in range(n):
        loss, w, vel = step(w, vel, torch.from_numpy(x),
                            torch.from_numpy(labels))
    return float(loss), {k: v.numpy() for k, v in w.items()}, vel


class TestWeightDecay:
    def test_caffe_l2_semantics(self):
        rng = np.random.RandomState(3)
        w0 = {"fc": rng.randn(8, 5).astype(np.float32)}
        x = rng.randn(4, 8).astype(np.float32)
        labels = np.array([0, 2, 4, 1], np.int32)
        lr, wd = 0.1, 0.03
        l0, w1p, _ = _toy_step(["fc"], x, labels, w0, lr=lr)
        l1, w1d, _ = _toy_step(["fc"], x, labels, w0, lr=lr,
                               weight_decay=wd)
        np.testing.assert_allclose(l0, l1, rtol=1e-6)
        np.testing.assert_allclose(w1d["fc"], w1p["fc"] - lr * wd * w0["fc"],
                                   rtol=1e-5, atol=1e-6)

    def test_momentum_ordering(self):
        rng = np.random.RandomState(7)
        w0 = {"fc": rng.randn(6, 4).astype(np.float32)}
        x = rng.randn(3, 6).astype(np.float32)
        labels = np.array([1, 3, 0], np.int32)
        kw = dict(lr=0.05, optimizer="momentum", momentum=0.9)
        _, _, vel1 = _toy_step(["fc"], x, labels, w0, weight_decay=0.02,
                               **kw)
        _, _, vel1p = _toy_step(["fc"], x, labels, w0, **kw)
        np.testing.assert_allclose(vel1["v"]["fc"].numpy(),
                                   vel1p["v"]["fc"].numpy()
                                   + 0.02 * w0["fc"], rtol=1e-5, atol=1e-6)


class TestParamMults:
    def _w0(self, seed):
        rng = np.random.RandomState(seed)
        w0 = {"a": rng.randn(6, 5).astype(np.float32),
              "b": rng.randn(6, 5).astype(np.float32)}
        return w0, rng.randn(3, 6).astype(np.float32), \
            np.array([0, 4, 2], np.int32)

    def test_lr_mult_freezes_and_decay_mult_excludes(self):
        w0, x, labels = self._w0(11)
        lr, wd = 0.1, 0.05
        _, w1r, _ = _toy_step(["a", "b"], x, labels, w0, lr=lr,
                              weight_decay=wd)
        _, w1m, _ = _toy_step(["a", "b"], x, labels, w0, lr=lr,
                              weight_decay=wd,
                              param_mults={"a": (0.0, 0.0),
                                           "b": (2.0, 0.0)})
        np.testing.assert_array_equal(w1m["a"], w0["a"])
        g_b = (w0["b"] - w1r["b"]) / lr - wd * w0["b"]
        np.testing.assert_allclose(w1m["b"], w0["b"] - 2 * lr * g_b,
                                   rtol=1e-5, atol=1e-6)

    def test_frozen_blob_keeps_zero_momentum_state(self):
        w0, x, labels = self._w0(13)
        _, w1, v1 = _toy_step(["a", "b"], x, labels, w0, n=3, lr=0.1,
                              optimizer="momentum", weight_decay=0.01,
                              param_mults={"a": (0.0, 0.0)})
        np.testing.assert_array_equal(w1["a"], w0["a"])
        np.testing.assert_array_equal(v1["v"]["a"].numpy(), 0.0)
        assert v1["v"]["b"].abs().max() > 0

    def test_toy_steps_match_jax(self):
        # the same toy steps through the JAX step (f32 jnp matmuls)
        w0, x, labels = self._w0(17)
        kw = dict(lr=0.1, optimizer="adam", weight_decay=0.01,
                  clip_gradients=0.3, param_mults={"a": (0.5, 2.0)})
        pl, pw, _ = _toy_step(["a", "b"], x, labels, w0, n=3, **kw)
        jstep = jtrain.build_train_step(
            lambda ins, w: {"p": ins["data"] @ w["a"]
                            + ins["data"] @ w["b"]}, "data", "p",
            from_logits=True, **kw)
        jw, jv = dict(w0), jtrain.init_opt_state("adam", w0)
        for _ in range(3):
            jl, jw, jv = jstep(jw, jv, x, labels)
        assert abs(pl - float(jl)) < 1e-5
        for k in pw:
            assert _mrd(pw[k], np.asarray(jw[k])) < 1e-5, k


class TestLrPolicy:
    def _losses(self, tmp_path, fn, extra=""):
        run_mode(f"(mode=cnet_train,model=mini,batch=4,steps=4,lr=0.1,"
                 f"seed=5,log_every=1,op_tune=(use_culibs=1),device=cpu,"
                 f"loss_out_fn={fn},boda_output_dir={tmp_path}{extra})")
        return np.loadtxt(tmp_path / fn)

    def test_step_policy_matches_fixed_before_boundary(self, tmp_path,
                                                       capsys):
        fixed = self._losses(tmp_path, "f.txt")
        s4 = self._losses(tmp_path, "s4.txt",
                          ",lr_policy=step,stepsize=4,gamma=0.1")
        np.testing.assert_allclose(fixed, s4, rtol=1e-6)
        s2 = self._losses(tmp_path, "s2.txt",
                          ",lr_policy=step,stepsize=2,gamma=0.1")
        np.testing.assert_allclose(fixed[:3], s2[:3], rtol=1e-5)
        assert abs(fixed[3] - s2[3]) > 1e-7
        ms = self._losses(tmp_path, "ms.txt",
                          ",lr_policy=multistep,stepvalue=2,gamma=0.1")
        capsys.readouterr()
        np.testing.assert_allclose(s2, ms, rtol=1e-6)

    def test_policy_validation(self, tmp_path):
        with pytest.raises(RtErr, match="unknown lr_policy"):
            self._losses(tmp_path, "x.txt", ",lr_policy=cosine")
        with pytest.raises(RtErr, match="stepsize"):
            self._losses(tmp_path, "x.txt", ",lr_policy=step")
        with pytest.raises(RtErr, match="stepvalue"):
            self._losses(tmp_path, "x.txt", ",lr_policy=multistep")


def test_cnet_train_matches_jax(tmp_path, capsys):
    # the mode against the JAX mode on the same synthetic batches (the
    # snapshot's numpy RandomState), f32 tune, momentum with decay
    extra = ("model=mini,batch=4,steps=3,lr=0.05,seed=5,optimizer=momentum,"
             "weight_decay=1e-3,op_tune=(use_culibs=1)")
    run_mode(f"(mode=cnet_train,{extra},device=cpu,loss_out_fn=p.txt,"
             f"boda_output_dir={tmp_path})")
    jrun(f"(mode=cnet_train,{extra},loss_out_fn=j.txt,"
         f"boda_output_dir={tmp_path})", global_vars={})
    capsys.readouterr()
    assert _mrd(np.loadtxt(tmp_path / "p.txt"),
                np.loadtxt(tmp_path / "j.txt")) < 1e-4


# ------------------------------------------------------------------ files

def _opt_contents(optimizer, rng):
    w = {"conv1_filts": rng.randn(4, 3, 3, 3).astype(np.float32),
         "conv1_biases": rng.randn(4).astype(np.float32)}
    vel = jtrain.init_opt_state(optimizer, w)
    vel = {k: ({n: rng.randn(*a.shape).astype(np.float32)
                for n, a in v.items()} if isinstance(v, dict)
               else np.float32(3)) for k, v in vel.items()}
    return w, vel


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
def test_snapshot_bytes_equal_jax(tmp_path, optimizer):
    rng = np.random.RandomState(9)
    w, vel = _opt_contents(optimizer, rng)
    rs = np.random.RandomState(4)
    rs.randn(5)
    kw = dict(step=7, optimizer=optimizer, consumed=28, weights=w, vel=vel,
              losses=[2.5, 2.25, 1.75], rng_state=rs.get_state())
    train.write_snapshot(tmp_path / "p.boda", **kw)
    jtrain.write_snapshot(tmp_path / "j.boda", **kw)
    assert (tmp_path / "p.boda").read_bytes() == \
        (tmp_path / "j.boda").read_bytes()
    for reader in (train.read_snapshot, jtrain.read_snapshot):
        snap = reader(tmp_path / "p.boda")
        assert snap["step"] == 7 and snap["losses"] == [2.5, 2.25, 1.75]
        r2 = np.random.RandomState()
        r2.set_state(snap["rng_state"])
        assert r2.randn() == rs.randn()
        rs.set_state(kw["rng_state"])
        opt = train._unflatten_opt(optimizer, snap["weights"],
                                   snap["opt_flat"])
        assert train._flatten_opt(opt).keys() == \
            train._flatten_opt(vel).keys()
    with pytest.raises(RtErr, match="not a boda_tpu snapshot"):
        train.read_snapshot(__file__)
    (tmp_path / "t.boda").write_bytes((tmp_path / "p.boda").read_bytes()[:-9])
    with pytest.raises(RtErr, match="truncated or corrupt"):
        train.read_snapshot(tmp_path / "t.boda")


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_artifact_bytes_equal_jax(tmp_path, dtype):
    rng = np.random.RandomState(2)
    w = {"b": (rng.randn(3, 5) * 10).astype(np.float32),
         "a": rng.randn(7).astype(np.float32)}
    w["a"][:3] = [0.0, -0.0, 1e-40]  # zero, signed zero, subnormal
    train.write_weights_artifact(tmp_path / "p.boda", w, dtype=dtype,
                                 meta="m")
    jtrain.write_weights_artifact(tmp_path / "j.boda", w, dtype=dtype,
                                  meta="m")
    assert (tmp_path / "p.boda").read_bytes() == \
        (tmp_path / "j.boda").read_bytes()


def test_caffemodel_and_prototxt_bytes_equal_jax(tmp_path):
    for model in ("mini", "googlenet_conv_lrn"):
        pipe, jpipe = build_model(model, batch=1), jbuild_model(model,
                                                                batch=1)
        caffe_io.write_caffemodel(pipe, tmp_path / "p.caffemodel")
        jcaffe_io.write_caffemodel(jpipe, tmp_path / "j.caffemodel")
        caffe_io.write_prototxt(pipe, tmp_path / "p.prototxt")
        jcaffe_io.write_prototxt(jpipe, tmp_path / "j.prototxt")
        for ext in ("caffemodel", "prototxt"):
            assert (tmp_path / f"p.{ext}").read_bytes() == \
                (tmp_path / f"j.{ext}").read_bytes(), (model, ext)
    # the written net imports back with its weights
    back = caffe_io.read_model(tmp_path / "p.prototxt",
                               tmp_path / "p.caffemodel")
    for k, v in pipe.op_params.items():
        np.testing.assert_array_equal(back.op_params[k].v, v.v)


def test_cnet_train_writes_caffemodel_prototxt_artifact(tmp_path, capsys):
    run_mode(f"(mode=cnet_train,model=mini,batch=2,steps=2,device=cpu,"
             f"weights_out_fn=w.caffemodel,prototxt_out_fn=n.prototxt,"
             f"artifact_out_fn=a.boda,boda_output_dir={tmp_path})")
    out = capsys.readouterr().out
    assert "wrote trained weights to w.caffemodel" in out
    back = caffe_io.read_model(tmp_path / "n.prototxt",
                               tmp_path / "w.caffemodel")
    art = train.read_weights_artifact(tmp_path / "a.boda")
    for k, v in art.items():
        # the artifact is the caffemodel's f32 weights rounded to bf16
        np.testing.assert_array_equal(
            torch.from_numpy(back.op_params[k].v).bfloat16().float().numpy(),
            v)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_resume_across_packages(tmp_path, capsys, direction):
    """Two steps in one package, its snapshot, two more in the other: the
    losses of an uninterrupted four-step run (f32 tune; the packages sum
    in other orders, hence 1e-4)."""
    base = ("model=mini,batch=4,lr=0.05,seed=5,optimizer=adam,"
            "op_tune=(use_culibs=1)")
    port = f"device=cpu,boda_output_dir={tmp_path}"
    jax_ = f"boda_output_dir={tmp_path}"
    first, second = (jrun, run_mode) if direction == "jax_to_port" \
        else (run_mode, jrun)
    a1, a2 = (jax_, port) if direction == "jax_to_port" else (port, jax_)

    def go(fn, s):
        return fn(s, global_vars={}) if fn is jrun else fn(s)
    go(first, f"(mode=cnet_train,{base},steps=4,loss_out_fn=full.txt,{a1})")
    go(first, f"(mode=cnet_train,{base},steps=2,snapshot_every=2,"
              f"snapshot_fn=s.boda,{a1})")
    go(second, f"(mode=cnet_train,{base},steps=4,resume_fn="
               f"{tmp_path}/s.boda,loss_out_fn=res.txt,{a2})")
    capsys.readouterr()
    full = np.loadtxt(tmp_path / "full.txt")
    res = np.loadtxt(tmp_path / "res.txt")
    np.testing.assert_array_equal(full[:2], res[:2])
    assert _mrd(res, full) < 1e-4


def test_resume_is_bit_identical(tmp_path, capsys):
    base = (f"(mode=cnet_train,model=mini,batch=4,lr=0.05,seed=5,"
            f"optimizer=momentum,train_dropout=1,device=cpu,"
            f"boda_output_dir={tmp_path}")
    full = run_mode(base + ",steps=4)")
    run_mode(base + ",steps=2,snapshot_every=2,snapshot_fn=s.boda)")
    res = run_mode(base + f",steps=4,resume_fn={tmp_path}/s.boda)")
    capsys.readouterr()
    assert full.losses == res.losses
    assert all(torch.equal(full.weights[k], res.weights[k])
               for k in full.weights)


# ------------------------------------------------------------------ remat

def test_remat_gradients_equal_plain():
    # the checkpointed forward recomputes each stage in the backward: the
    # same gradients, and the same loss, as the whole-net forward
    pipe = build_model("resnet-50", batch=1, ysz=64, xsz=64)
    plan = lower_pipe(pipe, make_op_tune(HEADLINE), fused_storage=True,
                      train_dropout=False)
    w = {k: v.requires_grad_(True)
         for k, v in weights_to_torch(plan, pipe.op_params, CPU).items()}
    spec = ("stem:conv1+pool1|s2:res2|s3:res3|s4:res4|s5:res5|"
            "head:pool5+fc1000-conv")
    fwd = build_remat_forward(plan, w, spec, CPU)
    assert fwd.out_node == "fc1000-conv" and fwd.dropped_tail == ("prob",)
    assert [g for g, _ in parse_stages_spec(spec)][0] == "stem"
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 3, 64, 64)
                         .astype(np.float32) * 0.1)
    lb = torch.tensor([3])
    grads = []
    for f in (fwd, train_forward(plan, CPU, "fc1000-conv")):
        loss = batch_loss(f, "data", "fc1000-conv", True, w, x, lb)
        grads.append((loss.detach(), torch.autograd.grad(
            loss, list(w.values()))))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


def test_remat_refuses_dropout_and_gaps():
    pipe = build_model("mini", batch=2)
    plan = lower_pipe(pipe, make_op_tune(HEADLINE), fused_storage=True,
                      train_dropout=True)
    w = weights_to_torch(plan, pipe.op_params, CPU)
    with pytest.raises(RtErr, match="exactly one external activation"):
        build_remat_forward(plan, w, "all:conv1+cccp1+pool1+conv2+drop+"
                                     "fc-conv", CPU)
    plan = lower_pipe(pipe, make_op_tune(HEADLINE), fused_storage=True)
    with pytest.raises(RtErr, match="not covered"):
        build_remat_forward(plan, w, "a:conv1|b:fc-conv", CPU)


def test_train_bench_runs_on_the_cpu(capsys):
    for extra in ("", ",remat=1,remat_stages=all:conv1+cccp1+pool1+"
                      "conv2+drop+fc-conv+pool2"):
        run_mode(f"(mode=train_bench,model=mini,batch=2,device=cpu,"
                 f"iters=1,reps=1,optimizer=adam{extra})")
        out = capsys.readouterr().out
        assert "train_bench mini b2 bf16 storage=nhwc opt=adam lr=0.01" \
            in out and "frac_roofline=n/a" in out and "device=cpu" in out
    with pytest.raises(RtErr, match="train_dropout=1 is not supported"):
        run_mode("(mode=train_bench,model=mini,device=cpu,remat=1,"
                 "train_dropout=1)")


@pytest.mark.slow
class TestLearnsHeldOut:
    def test_mini_trains_to_heldout_accuracy(self, tmp_path, capsys):
        """The full solver stack (momentum, warmup, clipping, per-step
        dropout masks, device_data staging, inference-lowered eval) trains
        mini on procedural shapes to >= 4x chance held-out top-1 (twin of
        tests/test_synth_train.py's, slow there too)."""
        run_mode(
            f"(mode=cnet_train,model=mini,batch=32,steps=1600,"
            f"steps_per_call=50,lr=0.1,optimizer=momentum,"
            f"warmup_steps=100,clip_gradients=2.0,log_every=400,"
            f"eval_every=1600,device_data=1,device=cpu,"
            f"stream=(mode=shapes-src,num_imgs=2000,ysz=32,xsz=32,"
            f"num_classes=10,seed=1,mean=128,scale=0.015625),"
            f"eval_stream=(mode=shapes-src,num_imgs=200,start_ix=50000,"
            f"ysz=32,xsz=32,num_classes=10,seed=1,mean=128,"
            f"scale=0.015625),boda_output_dir={tmp_path})")
        out = capsys.readouterr().out
        import re
        m = re.search(r"eval @ step 1600: top_1_acc=([\d.]+)", out)
        assert m, out
        assert float(m.group(1)) >= 0.40, out


class TestGooglenetTrainedArtifact:
    """The second topology's trained artifact (tests/data/googlenet-
    shapes40.boda, trained by the JAX package's cnet_train) on the port."""

    _FN = "googlenet-shapes40.boda"

    def _fn(self):
        from pathlib import Path
        return Path(__file__).parent / "data" / self._FN

    def test_artifact_loads_onto_net(self):
        from boda_tpu_torch.apps.train import load_weights_into_pipe
        pipe = build_model("googlenet_conv", batch=1, num_classes=40)
        load_weights_into_pipe(pipe, str(self._fn()))
        w = pipe.op_params["loss3/classifier-conv_filts"].v
        assert float(np.abs(w).max()) > 0.05

    @pytest.mark.slow
    def test_heldout_accuracy_cpu(self):
        """Twin of tests/test_synth_train.py's gate (13/16, passed by one
        image there) on a wider eval set: 64 held-out shapes (the training
        eval split: seed=0, start_ix=100000) at 224² through the fused
        engine on the CPU, >= 56/64 top-1 (observed 60/64; chance 1/40)."""
        from boda_tpu_torch.apps.train import load_weights_into_pipe
        from boda_tpu_torch.engine.torch_fwd import build_forward
        from boda_tpu_torch.io.synth import render_shapes
        n = 64
        pipe = build_model("googlenet_conv", batch=n, num_classes=40)
        load_weights_into_pipe(pipe, str(self._fn()))
        imgs, labels = render_shapes(range(100000, 100000 + n),
                                     224, 224, 40, 0)
        x = (imgs.astype(np.float32) - 128.0) / 64.0
        plan = lower_pipe(pipe, make_op_tune("(use_culibs=1)"),
                          fused_storage=True)
        fwd = build_forward(plan, CPU)
        w = weights_to_torch(plan, pipe.op_params, CPU)
        with torch.no_grad():
            prob = fwd({"data": torch.from_numpy(x)}, w)[
                pipe.get_single_top_node().name].numpy()
        top1 = prob.reshape(n, -1).argmax(axis=1)
        assert (top1 == labels).sum() >= 56, (top1, labels)
