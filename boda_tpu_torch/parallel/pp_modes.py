"""CLI self-check for the pipeline-parallel layer (`pp_test`): the port of
boda_tpu/parallel/pp_modes.py.

`pp_test` segments a lowered plan, runs the GPipe and/or 1F1B training
schedules over a `pp` mesh of slots, and verifies loss + weight grads
against the sequential segments. The plan is lowered under the f32 vendor
tune (dryrun.TRAIN_TUNE): the JAX mode lowers with `()`, whose hand
kernels B1 and B2 have no backward in the port (ops/mxu_grad), as on the
TPU. The sequential reference runs the same plan.

Run on the card with BODA_TORCH_LOCAL_DEVICES=K slots, or
`--local-devices=K` for K slots on the CPU (as `mh_test`)."""

from __future__ import annotations

from ..core.config import Attr
from ..core.error import RtErr
from ..core.has_main import HasMain, mode

_DEFAULT_STAGES = {
    "mini": "a:conv1|b:cccp1+pool1|c:conv2+drop|d:fc-conv+gpool",
    "resnet-50": "stem:conv1+pool1+res2|s3:res3|s4:res4|"
                 "head:res5+pool5+fc1000-conv",
}


@mode("pp_test", help="pipeline-parallel self-check: GPipe/1F1B training "
                      "schedules over a pp mesh vs sequential grads")
class PpTest(HasMain):
    model = Attr(str, default="mini")
    model_opts = Attr(str, default="", help="extra model-builder kwargs "
                                            "as a lexp")
    batch = Attr(int, default=2, help="per-microbatch image count")
    stages = Attr(str, default="",
                  help="stage spec (default: per-model table)")
    pp = Attr(int, default=4, help="pipeline stages = mesh 'pp' size")
    microbatches = Attr(int, default=6)
    schedule = Attr(str, default="both", help="gpipe | 1f1b | both")
    local_devices = Attr(int, default=0,
                         help="if >0: run on the CPU with this many slots "
                              "(the check without a multi-chip host)")
    tol = Attr(float, default=1e-4, help="max rel grad diff vs sequential")

    def main(self):
        if self.local_devices:
            from .multihost import force_local_cpu_devices
            force_local_cpu_devices(self.local_devices)
        import numpy as np
        import torch

        from ..core.device import local_devices
        from ..engine.lower import lower_pipe, resolve_plan_weights
        from ..engine.segments import build_plan_segments
        from ..engine.torch_fwd import _storage_in, _storage_out
        from ..graph.modes import _load_pipe
        from ..ops.cnn_variants import make_op_tune
        from .dryrun import TRAIN_TUNE
        from .mesh import Mesh
        from .pipeline import gpipe_plan_train_step, plan_train_step_1f1b

        if self.schedule not in ("gpipe", "1f1b", "both"):
            raise RtErr(f"pp_test: unknown schedule '{self.schedule}'")
        stages = self.stages or _DEFAULT_STAGES.get(self.model)
        if not stages:
            raise RtErr(f"pp_test: no default stage spec for model "
                        f"'{self.model}' — pass --stages")
        devices = local_devices()
        dev = devices[0]
        pipe = _load_pipe(self)
        plan = lower_pipe(pipe, make_op_tune(TRAIN_TUNE))
        weights = {n: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   for n, v in resolve_plan_weights(
                       plan, pipe.op_params).items()}
        segs = build_plan_segments(plan, weights, stages, dev)
        if len(segs) != self.pp:
            raise RtErr(f"pp_test: stage spec yields {len(segs)} "
                        f"segments != pp={self.pp}")
        if len(devices) < self.pp:
            raise RtErr(f"pp_test: {len(devices)} devices < pp={self.pp} "
                        f"(use --local-devices)")
        mesh = Mesh(devices[:self.pp], ("pp",))
        out_node = segs[-1].out_node
        n_cls = plan.node_dims[out_node]["chan"]
        d = pipe.get_data_img_dims()
        M = self.microbatches
        rng = np.random.RandomState(0)
        x_mb = (rng.randn(M, *d.shape) * 0.3).astype(np.float32)
        labels = rng.randint(0, n_cls, size=(M, d.shape[0])).astype(np.int32)

        def loss_fn(y_storage, labs):
            y = _storage_out(y_storage, plan.node_dims[out_node], plan)
            logp = torch.log_softmax(y[:, :, 0, 0].float(), dim=1)
            return -torch.take_along_dim(logp, labs.long()[:, None],
                                         dim=1).mean()

        names = [n for s in segs for n in s.weight_names]
        wr = {n: weights[n].detach().requires_grad_(True) for n in names}
        tot = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(M):
            v = _storage_in(torch.from_numpy(x_mb[i]).to(dev),
                            plan.node_dims[segs[0].in_node], plan)
            for s in segs:
                v = s.fn(v, *[wr[n] for n in s.weight_names])
            tot = tot + loss_fn(v, torch.from_numpy(labels[i]).to(dev))
        want_loss = float(tot.detach())
        want_g = dict(zip(names, torch.autograd.grad(
            tot, [wr[n] for n in names])))

        steps = {"gpipe": gpipe_plan_train_step,
                 "1f1b": plan_train_step_1f1b}
        sched = [self.schedule] if self.schedule != "both" \
            else ["gpipe", "1f1b"]
        fails = []  # (name, loss_rd, grad_mrd) of each FAILING schedule
        for name in sched:
            loss_pp, g_pp = steps[name](
                plan, segs, weights, x_mb, labels, mesh, loss_fn)
            l_rd = abs(float(loss_pp) - want_loss) \
                / max(abs(want_loss), 1e-12)
            g_mrd = 0.0
            for n in sorted(want_g):
                if n not in g_pp:
                    continue
                a = g_pp[n].double()
                b = want_g[n].double()
                g_mrd = max(g_mrd, float((a - b).abs().max()
                                         / b.abs().max().clamp_min(1e-12)))
            ok = l_rd <= self.tol and g_mrd <= self.tol \
                and set(g_pp) == set(want_g)
            if not ok:
                fails.append((name, l_rd, g_mrd))
            print(f"pp_test {name} model={self.model} pp={self.pp} "
                  f"M={M}: {'PASSED' if ok else 'FAILED'} "
                  f"({len(want_g)} weight grads vs sequential)")
        if fails:
            raise RtErr("pp_test: FAILED " + "; ".join(
                f"{n} (loss_rd={lr:.2e} grad_mrd={gm:.2e})"
                for n, lr, gm in fails))
