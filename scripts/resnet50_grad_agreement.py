"""How far the bf16 headline tune's weight gradients lie from the f32
tune's, in the JAX package and in the port, on the CPU: the trained
40-class ResNet-50 (tests/data/resnet50-shapes40.boda) at 224², the first
batch of chip_smoke.py's train phase (shapes-src seed 2, mean 128, scale
1/64), one batch mean of softmax cross-entropy on the logits. Prints, per
package, the step-1 losses of both tunes and, over the 108 weight blobs,
the largest per-blob mrd, the median one, the relative L2 of the whole
gradient and the least per-blob cosine: the numbers chip_smoke.py's
gradient gates rest on. The same for the grad_q8 preset over the headline
tune (tune/presets.resnet_grad_q8_site_tunes: int8 weight gradients at the
res3-5 branch2b and res5 branch2c convs) against the f32 tune.

Usage:
    JAX_PLATFORMS=cpu python scripts/resnet50_grad_agreement.py [batch]
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

HEADLINE = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"
F32 = "(use_culibs=1)"
WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                       "resnet50-shapes40.boda")


def batch(n):
    from boda_tpu.io.synth import render_shapes
    imgs, labels = render_shapes(range(n), 224, 224, 40, 2)
    return ((imgs.astype(np.float32) - 128.0) * 0.015625,
            np.asarray(labels, np.int32))


def jax_grads(tune, x, labels, q8=False):
    import jax
    import jax.numpy as jnp
    from boda_tpu.apps.train import load_weights_into_pipe
    from boda_tpu.engine.lower import lower_pipe, resolve_plan_weights
    from boda_tpu.engine.rtc_fwd import build_fused_forward
    from boda_tpu.models.zoo import build_model
    from boda_tpu.ops.cnn_variants import make_op_tune
    from boda_tpu.tune.presets import resnet_grad_q8_site_tunes
    pipe = build_model("resnet-50", batch=len(x), ysz=224, xsz=224,
                       num_classes=40)
    load_weights_into_pipe(pipe, WEIGHTS)
    plan = lower_pipe(pipe, make_op_tune(tune), fused_storage=True,
                      op_tunes=(resnet_grad_q8_site_tunes(pipe, tune) if q8
                                else None))
    top = next(op for op in pipe.ops.values() if "prob" in op.tops).bots[0]
    fwd = build_fused_forward(plan, extra_out_nodes=(top,))
    li = jnp.asarray(labels)

    def loss(w):
        p = fwd({"data": x}, w)[top].mean(axis=(2, 3)).astype(jnp.float32)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(p, axis=1),
                                             li[:, None], axis=1))
    v, g = jax.jit(jax.value_and_grad(loss))(
        resolve_plan_weights(plan, pipe.op_params))
    return float(v), {k: np.asarray(a, np.float64) for k, a in g.items()}


def port_grads(tune, x, labels, q8=False):
    import torch
    from boda_tpu_torch.apps.train import batch_loss, load_weights_into_pipe, \
        train_forward, train_top
    from boda_tpu_torch.engine.lower import lower_pipe
    from boda_tpu_torch.engine.torch_fwd import weights_to_torch
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.ops.cnn_variants import make_op_tune
    from boda_tpu_torch.tune.presets import resnet_grad_q8_site_tunes
    cpu = torch.device("cpu")
    pipe = build_model("resnet-50", batch=len(x), ysz=224, xsz=224,
                       num_classes=40)
    load_weights_into_pipe(pipe, WEIGHTS)
    plan = lower_pipe(pipe, make_op_tune(tune), fused_storage=True,
                      train_dropout=False,
                      op_tunes=(resnet_grad_q8_site_tunes(pipe, tune) if q8
                                else None))
    top, _ = train_top(pipe, plan)
    w = {k: v.requires_grad_(True)
         for k, v in weights_to_torch(plan, pipe.op_params, cpu).items()}
    loss = batch_loss(train_forward(plan, cpu, top), "data", top, True, w,
                      torch.from_numpy(x), torch.from_numpy(labels))
    g = torch.autograd.grad(loss, list(w.values()))
    return float(loss.detach()), {k: v.double().numpy()
                                  for k, v in zip(w, g)}


def report(name, lh, gh, lf, gf, sites=()):
    ks = sorted(gf)
    mrd = {k: np.abs(gh[k] - gf[k]).max() / max(np.abs(gf[k]).max(), 1e-30)
           for k in ks}
    cos = {k: gh[k].ravel() @ gf[k].ravel()
           / (np.linalg.norm(gh[k]) * np.linalg.norm(gf[k])) for k in ks}
    a = np.concatenate([gh[k].ravel() for k in ks])
    b = np.concatenate([gf[k].ravel() for k in ks])
    worst, least = max(mrd, key=mrd.get), min(cos, key=cos.get)
    print(f"{name}: loss {lh:.6f} (f32 tune {lf:.6f}); {len(ks)} blobs: "
          f"max mrd {mrd[worst]:.4f} ({worst}), median "
          f"{sorted(mrd.values())[len(ks) // 2]:.4f}, relative L2 "
          f"{np.linalg.norm(a - b) / np.linalg.norm(b):.4f}, least cosine "
          f"{cos[least]:.5f} ({least})", flush=True)
    if sites:
        ks = [k for k in ks if k.rsplit("_", 1)[0] in sites]
        least = min(ks, key=cos.get)
        print(f"{name}: the {len(ks)} blobs of the grad_q8 sites: max mrd "
              f"{max(mrd[k] for k in ks):.4f}, least cosine "
              f"{cos[least]:.5f} ({least})", flush=True)


def q8_sites():
    """The op tags of the grad_q8 preset on ResNet-50."""
    import re
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.tune.presets import RESNET_GRAD_Q8_SITE_PATS
    pipe = build_model("resnet-50", batch=1, num_classes=40)
    return {op.tag for op in pipe.ops.values() if op.type == "Convolution"
            and any(re.fullmatch(p, op.tag) for p in RESNET_GRAD_Q8_SITE_PATS)}


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    x, labels = batch(n)
    for name, fn in (("jax", jax_grads), ("port", port_grads)):
        lf, gf = fn(F32, x, labels)
        lh, gh = fn(HEADLINE, x, labels)
        report(f"{name} b{n}", lh, gh, lf, gf)
        del gh
        lq, gq = fn(HEADLINE, x, labels, q8=True)
        report(f"{name} b{n} grad_q8", lq, gq, lf, gf, q8_sites())


if __name__ == "__main__":
    main()
