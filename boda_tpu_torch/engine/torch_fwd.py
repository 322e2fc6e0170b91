"""The torch network executor: the port of boda_tpu/engine/rtc_fwd.py.

`TorchFwd` is the ConvFwd engine `engine=torch`. At init it lowers the pipe
(engine/lower.lower_pipe, the port's copy of the JAX package's lowering:
variant pick, ReLU fusion and the NHWC/bf16 fused-storage pass), builds each step
from the port's templates, and puts the weights on the device once. A
forward runs the steps eagerly in plan order on that device.

Per-op tunes by tag regex (op_tunes_pat) and calibrated static int8
activation scales (act_scales_fn) run the selective-precision presets, as
in the JAX engine (rtc_fwd.py:202-222). Left out so far (the config
refuses them as unused values): per-call mode and its timing, stats,
quantize hooks, nan_check, the mesh, wisdom and device-side input
preprocessing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import Attr, register
from ..core.device import get_device
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.timers import timer
from ..graph.pipe import ConvPipe
from ..ops.cnn_variants import OpTune, make_op_tune
from ..ops.cuda.util import torch_dtype
from ..ops.registry import get_template
from .iface import ConvFwd
from .lower import Plan, lower_pipe, resolve_plan_weights


def weights_to_torch(plan: Plan, op_params: dict, device: torch.device,
                     dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """The plan's weights (resolve_plan_weights: numpy) as tensors on
    `device`, floating ones cast to `dtype` when given. The single place
    where the pipe's numpy parameters become tensors."""
    out = {}
    for n, v in resolve_plan_weights(plan, op_params).items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[n] = t.to(device)
    return out


def _storage_dtype(dims: Dims, plan: Plan) -> torch.dtype:
    dt = torch_dtype(dims.dtype)
    if plan.storage_nhwc and len(dims.shape) == 4 and plan.edge_prec == "bf16" \
            and dt.is_floating_point:
        return torch.bfloat16
    return dt


def _storage_in(v: torch.Tensor, dims: Dims, plan: Plan) -> torch.Tensor:
    """Logical (NCHW, node dtype) input -> the plan's storage form."""
    if plan.storage_nhwc and v.dim() == 4:
        v = v.to(_storage_dtype(dims, plan)).permute(0, 2, 3, 1).contiguous()
    return v


def _storage_out(v: torch.Tensor, dims: Dims, plan: Plan) -> torch.Tensor:
    """Storage-form tensor -> logical (NCHW, node dtype) output."""
    if plan.storage_nhwc and v.dim() == 4:
        v = v.permute(0, 3, 1, 2)
    return v.to(torch_dtype(dims.dtype)).contiguous()


def produced_nodes(plan: Plan) -> set[str]:
    """The nodes a forward of `plan` can return: its inputs and every node a
    step writes. A fused step (fused_stem, resblock) writes only its last
    member's output, so the interior nodes of the fused ops are not here."""
    out = set(plan.input_nodes)
    for s in plan.steps:
        tmpl = get_template(s.func_name)
        out.update(node for an, node in s.arg_nodes.items()
                   if an in tmpl.out_args() + tmpl.io_args())
    return out


def build_forward(plan: Plan, device: torch.device,
                  keep_all_nodes: bool = False):
    """The whole-net function fwd(inputs, weights, out_nodes=(),
    step_hook=None) -> dict, counterpart of rtc_fwd.build_fused_forward.

    inputs: every node of plan.input_nodes, as logical (NCHW, node dtype)
    tensors on `device`; names, shapes, dtypes and device are checked.
    weights: weights_to_torch(plan, ...). Returns the plan's outputs plus
    `out_nodes` (every produced node under keep_all_nodes), logical form.
    When the plan's fused-storage pass is on, the conversion to and from
    NHWC / the edge dtype happens once, at this boundary. step_hook, when
    given, is called with each step and returns a context manager that the
    step runs in (a per-step timer, for instance)."""
    fns = []
    for s in plan.steps:
        tmpl = get_template(s.func_name)
        fns.append((tmpl.build(tmpl.check_args(s.sig)), tmpl, s))
    node_dims = plan.node_dims
    weight_set = set(plan.weight_nodes)
    want_inputs = set(plan.input_nodes)

    def _check_inputs(inputs: dict):
        got = set(inputs)
        if got != want_inputs:
            raise RtErr(f"build_forward: inputs {sorted(got)} != the plan's "
                        f"input nodes {sorted(want_inputs)}")
        for n, v in inputs.items():
            nd = node_dims[n]
            if not isinstance(v, torch.Tensor):
                raise RtErr(f"build_forward: input '{n}' is a "
                            f"{type(v).__name__}, not a torch.Tensor")
            if tuple(v.shape) != tuple(nd.shape):
                raise RtErr(f"build_forward: input '{n}' shape "
                            f"{tuple(v.shape)} != the plan's logical dims "
                            f"{tuple(nd.shape)} ({nd})")
            if v.dtype != torch_dtype(nd.dtype):
                raise RtErr(f"build_forward: input '{n}' dtype {v.dtype} != "
                            f"{torch_dtype(nd.dtype)}")
            if v.device != device:
                raise RtErr(f"build_forward: input '{n}' on {v.device}, "
                            f"the engine runs on {device}")

    def fwd(inputs: dict, weights: dict, out_nodes=(), step_hook=None) -> dict:
        _check_inputs(inputs)
        vals = dict(weights)
        for n, v in inputs.items():
            vals[n] = _storage_in(v, node_dims[n], plan)
        for fn, tmpl, s in fns:
            ins = []
            for an in tmpl.in_args() + tmpl.io_args():
                if an not in s.arg_nodes:
                    continue
                node = s.arg_nodes[an]
                if node not in vals:
                    what = "weight node" if node in weight_set else "node"
                    raise RtErr(f"build_forward: {what} '{node}' read by "
                                f"step {s.call_tag} has no value (weights "
                                f"from another plan, or no earlier step "
                                f"writes it)")
                ins.append(vals[node])
            if step_hook is None:
                outs = fn(*ins)
            else:
                with step_hook(s):
                    outs = fn(*ins)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for an, ov in zip(tmpl.out_args() + tmpl.io_args(), outs):
                if an in s.arg_nodes:
                    vals[s.arg_nodes[an]] = ov
        names = list(plan.output_nodes)
        if keep_all_nodes:
            names += [n for n in vals if n not in weights and n not in inputs
                      and n in node_dims and n not in names]
        names += [n for n in out_nodes if n not in names]
        missing = [n for n in names if n not in vals]
        if missing:
            raise RtErr(f"build_forward: node(s) {missing} are not produced "
                        f"by any step")
        return {n: _storage_out(vals[n], node_dims[n], plan) for n in names}

    return fwd


@register(ConvFwd, "torch", help="PyTorch executor with hand-written CUDA "
                                 "kernels (sm_90a)")
class TorchFwd(ConvFwd):
    op_tune = Attr(OpTune, default="()", help="default tuning record")
    fuse = Attr(bool, default=True,
                help="fused storage: with layout=nhwc every inter-op edge "
                     "is stored NHWC (bf16 under prec=bf16)")
    keep_all_nodes = Attr(bool, default=False,
                          help="return every produced node (for digest "
                               "comparison)")
    force_zero_bias = Attr(bool, default=False,
                           help="zero every bias blob at init (debug "
                                "determinism hook; reference rtc_fwd.cc:59)")
    device = Attr(str, default="cuda", help="torch device: cuda[:i] or cpu")
    op_tunes_pat = Attr(dict[str, str], default=None,
                        help="per-op tune overrides by TAG REGEX, e.g. "
                             "(res3.*_branch2b=(use_culibs=1,prec=bf16,"
                             "layout=nhwc,quant8=1)) — runs the selective-"
                             "precision presets through any engine mode "
                             "(run_cnet, cls_agree)")
    act_scales_fn = Attr(str, default="",
                         help="calibrated static int8 activation scales "
                              "(tune/presets save_act_scales output) "
                              "applied onto the per-op tunes")

    def _op_tunes(self, pipe: ConvPipe) -> dict[str, OpTune] | None:
        """The per-op tunes: each op whose tag a regex of op_tunes_pat
        matches whole gets that regex's tune (a later regex wins), then the
        static act scales of act_scales_fn go onto them."""
        op_tunes = None
        if self.op_tunes_pat:
            import re
            pats = {}
            for pat, spec in self.op_tunes_pat.items():
                rx = re.compile(pat)
                t = make_op_tune(spec)
                for op in pipe.ops.values():
                    if rx.fullmatch(op.tag):
                        pats[op.tag] = t
            op_tunes = pats or None
        if self.act_scales_fn:
            if not op_tunes:
                raise RtErr("act_scales_fn requires per-op tunes "
                            "(op_tunes_pat or wisdom_fn) naming the "
                            "quant8 sites the scales apply to")
            from ..tune.presets import load_act_scales
            op_tunes = load_act_scales(self.act_scales_fn, op_tunes)
        return op_tunes

    def init(self, pipe: ConvPipe) -> None:
        self.pipe = pipe
        self.dev = get_device(self.device)
        with timer("torch_fwd_init"):
            self.plan = lower_pipe(pipe, self.op_tune,
                                   op_tunes=self._op_tunes(pipe),
                                   fuse_relu=True, fused_storage=self.fuse)
            self.fwd = build_forward(self.plan, self.dev,
                                     keep_all_nodes=self.keep_all_nodes)
            self._produced = produced_nodes(self.plan)
            self.weights = weights_to_torch(self.plan, pipe.op_params,
                                            self.dev)
            if self.force_zero_bias:
                self.weights = {n: (torch.zeros_like(v)
                                    if n.endswith("biases") else v)
                                for n, v in self.weights.items()}

    def run_fwd(self, to_set: dict[str, NDA],
                to_get: list[str]) -> dict[str, NDA]:
        want = [n for n in to_get if n not in self.weights]
        # checked before the forward runs, with the JAX engine's message
        # (rtc_fwd.py:482-499)
        bad = [n for n in want if n not in self._produced]
        if bad:
            raise RtErr(f"run_fwd: node(s) {bad} are not produced by any "
                        f"step (eliminated by fusion?)")
        with timer("run_fwd"):
            inputs = {n: torch.from_numpy(np.ascontiguousarray(v.v)).to(self.dev)
                      for n, v in to_set.items()}
            with torch.no_grad():
                outs = self.fwd(inputs, self.weights, out_nodes=want)
            return {n: NDA(self.plan.node_dims[n],
                           (self.weights[n] if n in self.weights
                            else outs[n]).cpu().numpy())
                    for n in to_get}
