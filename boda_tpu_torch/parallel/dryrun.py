"""The multi-slot dry run: the port of __graft_entry__.dryrun_multichip.

dryrun_multichip(n) builds an n-slot ('dp','mp') mesh of this process's
slots (core/device.local_devices: BODA_TORCH_LOCAL_DEVICES slots of the
card, or of the CPU under the CPU ask), runs one sharded training step
(fwd + softmax-CE loss + grads + SGD update) of a tiny all-conv net with
real data- and model-parallel layouts, then the flagship (ResNet-50, small
batch and spatial size) sharded dp x mp against one slot, one sharded bf16
training step of it, and the pipelines: GPipe forward and training step
on ResNet-50 stages and the 1F1B training step on `mini` (n >= 4), or a
homogeneous GPipe (n < 4).

Every training step here lowers under the f32 vendor tune TRAIN_TUNE where
the JAX package lowers with `()`: the port's hand kernels B1 and B2
(k1conv, conv, ipconv, tconv) are inference-only, as they are on the TPU
(ops/mxu_grad.INFERENCE_ONLY), and the JAX package trains through `()` on
the CPU only through its jnp fallback. The forward checks keep `()`.
"""

from __future__ import annotations

import numpy as np
import torch

# the tune of the port's training self-checks (pp_test, mh_test --train=1,
# the dry run's tiny net and pipelines): every conv on the vendor library,
# which trains through ops/mxu_grad, in f32
TRAIN_TUNE = "(use_culibs=1)"
# the tune of the flagship training step (the JAX dry run's): the bf16
# headline tune, whose convs carry the mixed-precision VJP
HEADLINE_TUNE = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"


def _device(device=None) -> torch.device:
    from ..core.device import get_device, local_devices
    return get_device(str(device)) if device is not None \
        else local_devices()[0]


def _fused_for(name: str, tune: str = "", device=None, **kw):
    """(pipe, plan, fwd, weights) of zoo model `name` (builder kwargs kw)
    lowered under `tune` (fused storage where a tune is given), its
    build_forward on `device` (default: the first slot) and its weights
    there."""
    from ..engine.lower import lower_pipe
    from ..engine.torch_fwd import build_forward, weights_to_torch
    from ..models.zoo import build_model
    from ..ops.cnn_variants import make_op_tune
    dev = _device(device)
    pipe = build_model(name, **kw)
    plan = lower_pipe(pipe, make_op_tune(tune) if tune else None,
                      fused_storage=bool(tune))
    fwd = build_forward(plan, dev)
    weights = weights_to_torch(plan, pipe.op_params, dev)
    return pipe, plan, fwd, weights


def _mesh_train_step(plan, mesh, data_node: str, top: str, lr: float = 0.01):
    """build_train_step over the mesh forward (grads summed across ranks
    where the mesh spans processes)."""
    from ..apps.train import build_train_step
    from ..engine.torch_fwd import build_forward
    from .mesh import sum_over_ranks
    fwd = build_forward(plan, mesh=mesh)
    return build_train_step(fwd, data_node, top, lr=lr,
                            grad_reduce=lambda g: sum_over_ranks(mesh, g))


def dryrun_multichip(n_devices: int) -> None:
    """One sharded training step on a tiny all-conv net over an n-slot mesh
    (img over 'dp', conv filter out_chans over 'mp'), then the flagship
    checks and the pipelines."""
    from ..core.device import local_devices
    from ..engine.lower import lower_pipe
    from ..engine.torch_fwd import weights_to_torch
    from ..models.zoo import NetBuilder
    from ..ops.cnn_variants import make_op_tune
    from .mesh import make_mesh

    devices = local_devices()
    dev = devices[0]
    mp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices=n_devices, mp=mp, devices=devices)
    dp = mesh.shape["dp"]

    # tiny all-conv net: batch divisible by dp, chans divisible by mp
    b = NetBuilder("dryrun", batch=2 * dp, chans=3, ysz=16, xsz=16)
    b.conv("conv1", 16, 3, 1, 1)
    b.conv("conv2a", 16, 3, 1, 1)
    c2a = b.cur
    b.cur = "conv1"
    b.conv("conv2b", 16, 1, relu=False)
    b.eltwise("res2", [b.cur, c2a])
    b.relu("res2_relu")
    b.pool("pool", 2, 2)
    b.conv("fc-conv", 8, 1, relu=False)
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.softmax("prob")
    pipe = b.done(seed=7)

    plan = lower_pipe(pipe, make_op_tune(TRAIN_TUNE))
    weights = weights_to_torch(plan, pipe.op_params, dev)
    step = _mesh_train_step(plan, mesh, "data", "prob")
    d = pipe.get_data_img_dims()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*d.shape).astype(np.float32)).to(dev)
    labels = torch.from_numpy(
        rng.randint(0, 8, size=(d["img"],)).astype(np.int32)).to(dev)
    loss, new_w, _ = step(weights, {}, x, labels)
    loss = float(loss)
    assert np.isfinite(loss), f"dryrun loss not finite: {loss}"
    # one more step with updated weights: values must change (grads flowed)
    loss2, _, _ = step(new_w, {}, x, labels)
    assert float(loss2) != loss, "dryrun: loss unchanged after SGD step"
    print(f"dryrun_multichip OK: mesh=({dp},{mp}) loss {loss:.5f} -> "
          f"{float(loss2):.5f}")

    # --- flagship: ResNet-50 sharded over dp x mp vs one slot ---
    mrd = flagship_sharded_vs_single(mesh, dev)
    print(f"dryrun_multichip OK: resnet-50 sharded mesh=({dp},{mp}) "
          f"vs single-device mrd={mrd:.2e}")

    # --- flagship TRAINING step, sharded, bf16 compute (mxu_grad VJP) ---
    flagship_sharded_train_step(mesh)
    print(f"dryrun_multichip OK: resnet-50 bf16 TRAINING step sharded "
          f"mesh=({dp},{mp}) (mixed-precision custom-VJP grads)")

    # --- pipeline parallelism: ResNet-50 stages over a pp mesh ---
    if n_devices >= 4:
        _gpipe_resnet50(devices)
        print("dryrun_multichip OK: gpipe pp=4 resnet-50 stages match "
              "sequential")
        _gpipe_train_resnet50(devices)
        print("dryrun_multichip OK: gpipe pp=4 resnet-50 TRAINING step "
              "(microbatch grad accumulation) grads match sequential")
        _train_1f1b(devices)
        print("dryrun_multichip OK: 1F1B pp=4 TRAINING step (depth-K "
              "activation buffers, static schedule) grads match sequential")
    else:
        _gpipe_smoke(devices)
        print(f"dryrun_multichip OK: gpipe pp={min(4, n_devices)} matches "
              f"sequential")


def flagship_sharded_vs_single(mesh, single_device, batch: int = 0,
                               ysz: int = 32) -> float:
    """Run ResNet-50 inference sharded (img->dp, weight out_chan->mp) on
    `mesh` and unsharded on `single_device`; return the max relative
    difference between the two 'prob' outputs (must be ~0)."""
    from ..engine.torch_fwd import build_forward

    dp = mesh.shape["dp"]
    pipe, plan, fwd, weights = _fused_for(
        "resnet-50", device=single_device, batch=batch or 2 * dp, ysz=ysz,
        xsz=ysz)
    d = pipe.get_data_img_dims()
    x = torch.from_numpy(np.random.RandomState(0).randn(*d.shape)
                         .astype(np.float32) * 0.1).to(single_device)
    with torch.no_grad():
        got = build_forward(plan, mesh=mesh)({"data": x}, weights)["prob"]
        want = fwd({"data": x}, weights)["prob"]
    mrd = float((got.double() - want.double()).abs().max()
                / want.double().abs().max().clamp_min(1e-12))
    assert bool(torch.isfinite(got).all()), \
        "sharded resnet-50 produced non-finite values"
    assert mrd < 1e-4, f"sharded vs single-device resnet-50 mrd {mrd:.3e} " \
                       f"too large"
    return mrd


def flagship_sharded_train_step(mesh, ysz: int = 32) -> None:
    """One ResNet-50 TRAINING step (softmax-CE + SGD) sharded over the
    mesh, under the bf16 headline tune: the mixed-precision conv VJP
    (ops/mxu_grad) under the mesh's sharding."""
    dp = mesh.shape["dp"]
    dev = mesh.device(mesh.local_positions()[0])
    pipe, plan, _fwd, weights = _fused_for(
        "resnet-50", tune=HEADLINE_TUNE, device=dev, batch=2 * dp, ysz=ysz,
        xsz=ysz)
    d = pipe.get_data_img_dims()
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(*d.shape) * 0.1).astype(np.float32)
                         ).to(dev)
    labels = torch.from_numpy(rng.randint(0, 1000, size=(d["img"],))
                              .astype(np.int32)).to(dev)
    step = _mesh_train_step(plan, mesh, "data", "prob")
    loss, new_w, _ = step(weights, {}, x, labels)
    assert np.isfinite(float(loss)), f"sharded train loss: {loss}"
    loss2, _, _ = step(new_w, {}, x, labels)
    assert float(loss2) != float(loss), "sharded train: loss unchanged"


def _segmented(model: str, tune: str, stages: str, dev, **kw):
    """(pipe, plan, weights on dev, segments) of a zoo model lowered under
    tune (`()` where empty), cut into `stages`."""
    from ..engine.lower import lower_pipe
    from ..engine.segments import build_plan_segments
    from ..engine.torch_fwd import weights_to_torch
    from ..models.zoo import build_model
    from ..ops.cnn_variants import make_op_tune
    pipe = build_model(model, **kw)
    plan = lower_pipe(pipe, make_op_tune(tune) if tune else None)
    weights = weights_to_torch(plan, pipe.op_params, dev)
    return pipe, plan, weights, build_plan_segments(plan, weights, stages,
                                                    dev)


def _seq_loss_and_grads(plan, segs, weights, x_mb, labels, loss_fn, dev):
    """The segments run one after the other on each microbatch: the loss
    summed over microbatches and its gradient for every stage weight."""
    from ..engine.torch_fwd import _storage_in
    names = [n for s in segs for n in s.weight_names]
    wr = {n: weights[n].detach().requires_grad_(True) for n in names}
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(len(x_mb)):
        v = _storage_in(torch.from_numpy(x_mb[i]).to(dev),
                        plan.node_dims[segs[0].in_node], plan)
        for s in segs:
            v = s.fn(v, *[wr[n] for n in s.weight_names])
        tot = tot + loss_fn(v, torch.from_numpy(labels[i]).to(dev))
    grads = torch.autograd.grad(tot, [wr[n] for n in names])
    return tot.detach(), dict(zip(names, grads))


def _logits_loss(plan, out_node: str):
    """loss_fn(y_storage, labels): softmax cross-entropy of the out node's
    logits, the batch mean."""
    from ..engine.torch_fwd import _storage_out

    def loss_fn(y, labs):
        y = _storage_out(y, plan.node_dims[out_node], plan)
        logp = torch.log_softmax(y[:, :, 0, 0].float(), dim=1)
        return -torch.take_along_dim(logp, labs.long()[:, None],
                                     dim=1).mean()
    return loss_fn


def _assert_matches(loss_pp, g_pp, want_loss, want_g) -> None:
    assert abs(float(loss_pp) - float(want_loss)) \
        <= 1e-4 * max(abs(float(want_loss)), 1e-6), \
        (float(loss_pp), float(want_loss))
    assert set(g_pp) == set(want_g)
    for n in sorted(want_g):
        a, b = g_pp[n].double(), want_g[n].double()
        m = float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))
        assert m < 1e-4, (n, m)


RESNET_STAGES = ("stem:conv1+pool1+res2|s3:res3|s4:res4|"
                 "head:res5+pool5+fc1000-conv")


def _gpipe_resnet50(devices) -> None:
    """ResNet-50 segmented at its residual-stage boundaries (4 pp stages
    with different activation shapes and weights) through the
    heterogeneous GPipe under `()` (B1 and B2 in every stage): must match
    the same segments run one after the other."""
    from ..engine.torch_fwd import _storage_in
    from .mesh import Mesh
    from .pipeline import gpipe_plan_forward

    dev = devices[0]
    pipe, plan, weights, segs = _segmented(
        "resnet-50", "", RESNET_STAGES + "+prob", dev, batch=2, ysz=32,
        xsz=32, num_classes=16)
    mesh = Mesh(devices[:4], ("pp",))
    d = pipe.get_data_img_dims()
    x_mb = (np.random.RandomState(0).randn(3, *d.shape) * 0.1
            ).astype(np.float32)
    got = gpipe_plan_forward(plan, segs, weights, x_mb, mesh)
    with torch.no_grad():
        for i in range(3):
            v = _storage_in(torch.from_numpy(x_mb[i]).to(dev),
                            plan.node_dims["data"], plan)
            for s in segs:
                v = s.fn(v, *[weights[n] for n in s.weight_names])
            torch.testing.assert_close(got[i], v, rtol=1e-5, atol=1e-6)


def _gpipe_train_resnet50(devices) -> None:
    """GPipe microbatch gradient accumulation over the ResNet-50 segments
    (under TRAIN_TUNE): loss and weight grads must match the sequential
    segments'."""
    from .mesh import Mesh
    from .pipeline import gpipe_plan_train_step

    dev = devices[0]
    pipe, plan, weights, segs = _segmented(
        "resnet-50", TRAIN_TUNE, RESNET_STAGES, dev, batch=2, ysz=32,
        xsz=32, num_classes=16)
    mesh = Mesh(devices[:4], ("pp",))
    d = pipe.get_data_img_dims()
    rng = np.random.RandomState(0)
    M = 3
    x_mb = (rng.randn(M, *d.shape) * 0.1).astype(np.float32)
    labels = rng.randint(0, 16, size=(M, d.shape[0])).astype(np.int32)
    loss_fn = _logits_loss(plan, "fc1000-conv")
    loss_pp, g_pp = gpipe_plan_train_step(plan, segs, weights, x_mb, labels,
                                          mesh, loss_fn)
    _assert_matches(loss_pp, g_pp, *_seq_loss_and_grads(
        plan, segs, weights, x_mb, labels, loss_fn, dev))


def _train_1f1b(devices) -> None:
    """1F1B training on the 4-stage `mini` (M=6 > K=4: steady-state
    one-forward-one-backward ticks), under TRAIN_TUNE: the same loss and
    grads as the sequential segments."""
    from .mesh import Mesh
    from .pipeline import plan_train_step_1f1b

    dev = devices[0]
    pipe, plan, weights, segs = _segmented(
        "mini", TRAIN_TUNE,
        "a:conv1|b:cccp1+pool1|c:conv2+drop|d:fc-conv+gpool", dev, batch=2)
    mesh = Mesh(devices[:4], ("pp",))
    d = pipe.get_data_img_dims()
    rng = np.random.RandomState(0)
    M = 6
    x_mb = (rng.randn(M, *d.shape) * 0.5).astype(np.float32)
    labels = rng.randint(0, 10, size=(M, d.shape[0])).astype(np.int32)
    loss_fn = _logits_loss(plan, "gpool")
    loss_pp, g_pp = plan_train_step_1f1b(plan, segs, weights, x_mb, labels,
                                         mesh, loss_fn)
    _assert_matches(loss_pp, g_pp, *_seq_loss_and_grads(
        plan, segs, weights, x_mb, labels, loss_fn, dev))


def _gpipe_smoke(devices) -> None:
    """A homogeneous conv pipeline (up to 4 same-shape stages) over a 'pp'
    mesh against the stages run one after the other."""
    import torch.nn.functional as F

    from .mesh import Mesh
    from .pipeline import gpipe_forward, stack_stage_params

    pp = 4 if len(devices) >= 4 else len(devices)
    mesh = Mesh(devices[:pp], ("pp",))
    rng = np.random.RandomState(5)
    c = 8
    stages = [{"w": (rng.randn(c, c, 3, 3) * 0.1).astype(np.float32)}
              for _ in range(pp)]

    def stage_fn(p, x):  # x: (mb, c, y, x) same-shape conv stage
        return torch.tanh(F.conv2d(x, p["w"], padding=1))

    x = rng.randn(3, 2, c, 8, 8).astype(np.float32)  # (M, mb, c, y, x)
    got = gpipe_forward(stage_fn, stack_stage_params(stages), x, mesh)
    want = torch.from_numpy(x).to(devices[0])
    for s in stages:
        w = torch.from_numpy(s["w"]).to(devices[0])
        want = torch.stack([stage_fn({"w": w}, xi) for xi in want])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
