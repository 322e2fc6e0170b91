"""The reference network executor `engine=ref`: the caffe_fwd.cc equivalent.

The port's copy of boda_tpu/engine/ref_fwd.py. A known-good executor behind
the same engine interface, independent of the torch path: it lowers the
pipe and runs each step's float64 numpy ref_impl in plan order, reading
the weights from pipe.op_params. It is the numerical ground truth of the
multi-engine digest tests (test_compute_multi), and it runs on the host
by design: it is the reference, not an entry point meant for the card.
"""

from __future__ import annotations

import numpy as np

from ..core.config import Attr, register
from ..core.dims import NDA
from ..core.error import RtErr
from ..core.timers import timer
from ..graph.pipe import ConvPipe
from ..ops.cnn_variants import OpTune
from ..ops.registry import get_template
from .iface import ConvFwd
from .lower import lower_pipe


@register(ConvFwd, "ref", help="independent numpy float64 reference executor")
class RefFwd(ConvFwd):
    op_tune = Attr(OpTune, default="(use_culibs=1)",
                   help="tune used for lowering (variant pick is irrelevant "
                        "to ref numerics but kept for plan parity)")
    train_dropout = Attr(bool, default=False)
    det_drop_seed = Attr(int, default=0)

    def init(self, pipe: ConvPipe) -> None:
        self.pipe = pipe
        self.plan = lower_pipe(pipe, self.op_tune, fuse_relu=True,
                               train_dropout=self.train_dropout)
        if self.det_drop_seed:
            for s in self.plan.steps:
                if s.sig.func_name == "dropout":
                    s.sig.set_u32("det_drop_seed", self.det_drop_seed)
        self._steps = []
        for s in self.plan.steps:
            tmpl = get_template(s.sig.func_name)
            rfs = tmpl.check_args(s.sig)
            self._steps.append((tmpl, rfs, s))
        missing = [n for n in self.plan.weight_nodes if n not in pipe.op_params]
        if missing:
            raise RtErr(f"ref_fwd init: missing weights for {sorted(missing)}")

    def run_fwd(self, to_set: dict[str, NDA], to_get: list[str]) -> dict[str, NDA]:
        with timer("ref_run_fwd"):
            vals: dict[str, np.ndarray] = {
                n: self.pipe.op_params[n].v for n in self.plan.weight_nodes}
            for k, v in to_set.items():
                vals[k] = v.v
            for tmpl, rfs, s in self._steps:
                ins = []
                for an in tmpl.in_args() + tmpl.io_args():
                    if an not in s.arg_nodes:
                        continue
                    node = s.arg_nodes[an]
                    if node not in vals:  # INOUT target first touch
                        d = self.plan.node_dims[node]
                        vals[node] = np.zeros(d.shape, d.dtype)
                    ins.append(vals[node])
                outs = tmpl.ref_impl(rfs, *ins)
                if not isinstance(outs, (tuple, list)):
                    outs = (outs,)
                for an, ov in zip(tmpl.out_args() + tmpl.io_args(), outs):
                    if an in s.arg_nodes:
                        vals[s.arg_nodes[an]] = np.asarray(ov)
        out = {}
        for n in to_get:
            if n not in vals:
                raise RtErr(f"ref run_fwd: requested node '{n}' not produced")
            dims = self.plan.node_dims[n]
            out[n] = NDA(dims, np.asarray(vals[n], dtype=dims.dtype).reshape(dims.shape))
        return out
