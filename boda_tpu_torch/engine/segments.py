"""Plan segmentation: partition a lowered Plan into sequential stage
segments, each a function over the fused program's interior storage form
(the same NHWC/bf16 edges as the whole-net forward), and the
gradient-checkpointed forward built on them.

The port's copy of boda_tpu/engine/segments.py. jax.checkpoint becomes
torch.utils.checkpoint (use_reentrant=False): a backward stores only the
stage-boundary activations and runs each stage's forward again for its
gradient. A segment takes exactly one activation input, so a plan with a
seeded dropout (its seed is a second input) does not segment.
"""

from __future__ import annotations

from ..core.error import RtErr


class PlanSegment:
    """One stage: `fn(x, *ws) -> y` where x is the in_node's value in
    storage form, ws are the `weight_names` values (resolve_plan_weights
    order), and y is the out_node's storage-form value."""

    __slots__ = ("name", "steps", "fn", "weight_names", "in_node",
                 "out_node", "flops", "zero_init")

    def __init__(self, name, steps, fn, weight_names, in_node, out_node,
                 flops, zero_init):
        self.name = name
        self.steps = steps
        self.fn = fn
        self.weight_names = weight_names
        self.in_node = in_node
        self.out_node = out_node
        self.flops = flops
        self.zero_init = zero_init


def parse_stages_spec(spec: str) -> list[tuple[str, tuple[str, ...]]]:
    """'name:prefix[+prefix...]|...' → [(name, prefixes), ...]."""
    groups = []
    for part in spec.split("|"):
        name, _, prefs = part.partition(":")
        groups.append((name, tuple(p for p in prefs.split("+") if p)))
    return groups


def build_plan_segments(plan, weights: dict, stages_spec: str, device,
                        what: str = "plan segmentation"):
    """Partition plan.steps into stage segments by call-tag prefix.

    Each segment must consume exactly ONE external activation node (its
    input); shortcut edges must stay in-segment. Empty groups are dropped.
    A concat's buffer (the INOUT target of its copy steps) is made as zeros
    on `device` inside the segment, as build_forward makes it. Returns
    [PlanSegment, ...] in spec order."""
    from ..ops.registry import get_template
    from .torch_fwd import _storage_zeros

    groups = parse_stages_spec(stages_spec)

    def group_of(tag):
        for name, prefs in groups:
            if any(tag.startswith(p) for p in prefs):
                return name
        return None

    segs: dict[str, list] = {name: [] for name, _ in groups}
    for s in plan.steps:
        g = group_of(s.call_tag)
        if g is not None:
            segs[g].append(s)

    out = []
    for name, _prefs in groups:
        seg = segs[name]
        if not seg:
            continue
        built = []
        seg_weights: list[str] = []
        produced: set[str] = set()
        consumed: list[str] = []
        zero_init: list[str] = []
        for s in seg:
            tmpl = get_template(s.sig.func_name)
            rfs = tmpl.check_args(s.sig)
            built.append((tmpl.build(rfs), tmpl, s))
            io_args = set(tmpl.io_args())
            for an in tmpl.in_args() + tmpl.io_args():
                n = s.arg_nodes.get(an)
                if n is None or n in produced:
                    continue
                if n in weights:
                    if n not in seg_weights:
                        seg_weights.append(n)
                elif an in io_args and s.sig.func_name == "copy":
                    # first touch is the Concat write-slice target (copy
                    # ignores prior content at its chan range): zero-init
                    # in-seg, exactly as build_forward does on first touch.
                    # Other io first-touchers (in-place relu/dropout) READ
                    # content — those stay external
                    zero_init.append(n)
                    produced.add(n)
                else:
                    if n not in consumed:
                        consumed.append(n)
            for an in tmpl.out_args() + tmpl.io_args():
                if an in s.arg_nodes:
                    produced.add(s.arg_nodes[an])
        if len(consumed) != 1:
            raise RtErr(f"{what}: stage '{name}' must consume exactly one "
                        f"external activation node, got "
                        f"{consumed or '[none]'} — adjust the stages= "
                        f"grouping so shortcut edges stay in-stage")
        in_node = consumed[0]
        out_node = [s.arg_nodes[an] for fn, tmpl, s in built[::-1]
                    for an in tmpl.out_args() + tmpl.io_args()
                    if an in s.arg_nodes][0]
        flops = sum(get_template(s.sig.func_name).flops(
            get_template(s.sig.func_name).check_args(s.sig)) for s in seg)

        def seg_fn(x, *ws, _built=tuple(built), _wn=tuple(seg_weights),
                   _in=in_node, _zi=tuple(zero_init), _out=out_node):
            vals = dict(zip(_wn, ws))
            vals[_in] = x
            for n in _zi:  # INOUT targets (concat out buffers)
                vals[n] = _storage_zeros(plan.node_dims[n], plan, device)
            for fn, tmpl, s in _built:
                ins = [vals[s.arg_nodes[an]]
                       for an in tmpl.in_args() + tmpl.io_args()
                       if an in s.arg_nodes]
                outs = fn(*ins)
                if not isinstance(outs, (tuple, list)):
                    outs = (outs,)
                for an, ov in zip(tmpl.out_args() + tmpl.io_args(), outs):
                    if an in s.arg_nodes:
                        vals[s.arg_nodes[an]] = ov
            return vals[_out]

        out.append(PlanSegment(name, seg, seg_fn, tuple(seg_weights),
                               in_node, out_node, flops, tuple(zero_init)))
    return out


def build_remat_forward(plan, weights: dict, stages_spec: str, device):
    """Gradient-checkpointed forward: the plan's stages chained with
    torch.utils.checkpoint around each segment, so a backward stores only
    the stage-boundary activations and recomputes each stage's interior
    during its grad — the recompute-vs-store lever for training (memory
    for about one extra forward of FLOPs).

    fwd(inputs, weights) -> {out_node: logical NCHW value}: the final
    segment's out node only; trailing plan steps not covered by any stage
    group (e.g. a softmax when training from logits) are dropped.
    Non-trailing coverage gaps are an error, as is a covered step with no
    backward (ops/mxu_grad.check_trainable)."""
    from torch.utils.checkpoint import checkpoint

    from ..ops.mxu_grad import check_trainable
    from .torch_fwd import _storage_in, _storage_out

    segments = build_plan_segments(plan, weights, stages_spec, device,
                                   what="build_remat_forward")
    if not segments:
        raise RtErr("build_remat_forward: stage spec matched no steps")
    covered = {id(s) for ps in segments for s in ps.steps}
    uncov = [s for s in plan.steps if id(s) not in covered]
    # only a contiguous TAIL may be uncovered (dropped post-logits ops)
    last_ix = max(i for i, s in enumerate(plan.steps) if id(s) in covered)
    bad = [s.call_tag for s in plan.steps[:last_ix] if id(s) not in covered]
    if bad:
        raise RtErr(f"build_remat_forward: steps not covered by any stage "
                    f"group (and not trailing): {bad}")
    for prev, nxt in zip(segments, segments[1:]):
        if nxt.in_node != prev.out_node:
            raise RtErr(f"build_remat_forward: stage '{nxt.name}' input "
                        f"'{nxt.in_node}' != previous stage "
                        f"'{prev.name}' output '{prev.out_node}' — "
                        f"stages must chain")
    check_trainable([s for ps in segments for s in ps.steps],
                    "build_remat_forward")
    dropped = [s.call_tag for s in uncov]

    def fwd(inputs: dict, weights: dict):
        first = segments[0].in_node
        if first not in inputs:
            raise RtErr(f"build_remat_forward: missing input '{first}'")
        x = _storage_in(inputs[first], plan.node_dims[first], plan)
        for ps in segments:
            try:
                ws = [weights[n] for n in ps.weight_names]
            except KeyError as e:
                raise RtErr(f"build_remat_forward: weight node {e} missing "
                            f"from the weights dict (resolve_plan_weights "
                            f"on THIS plan)")
            x = checkpoint(ps.fn, x, *ws, use_reentrant=False)
        out = segments[-1].out_node
        return {out: _storage_out(x, plan.node_dims[out], plan)}

    fwd.out_node = segments[-1].out_node
    fwd.dropped_tail = tuple(dropped)
    return fwd
