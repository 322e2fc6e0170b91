"""Graph → kernel-call lowering (shared by the rtc and ref engines).

Capability parity with the reference's gen_ops_rec/gen_op lowering
(rtc_fwd.cc:263-465): a topo walk emitting one or more kernel-template
calls per graph op, with

  * ReLU-into-conv fusion (rtc_fwd.cc:488-493) via conv_has_relu,
  * Concat → N `copy` calls at chan offsets (rtc_fwd.cc:267-280),
  * Split → N `split_copy` calls (:281-294),
  * Eltwise → chained binary calls,
  * SoftmaxWithLoss → grad+loss then loss-sum calls (:365-374),
  * in-place ReLU/Dropout steps on their node (:330-358),
  * temp-node synthesis for multi-call lowerings.

Each Step carries a full op signature with *template* arg names, so
KernelTemplate.check_args sees exactly what CUCL check_args saw.

The port's copy of boda_tpu/engine/lower.py, reading the port's template
registry (ops/registry.py): a plan names only templates the port has.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.dims import Dims
from ..core.error import RtErr
from ..graph.pipe import ConvOp, ConvPipe
from ..ops.cnn_variants import OpTune, add_cnn_codegen_annotations
from ..ops.op_base import OpBase

# fed input node carrying the per-step dropout seed (train_dropout=1)
DROP_SEED_NODE = "det_drop_seed"
from ..ops.registry import get_template


@dataclass
class Step:
    """One kernel call: template sig + template-arg→graph-node mapping."""

    sig: OpBase                      # full sig with template arg names
    arg_nodes: dict[str, str]        # template arg name → node name
    call_tag: str
    temps: dict[str, Dims] = field(default_factory=dict)  # extra nodes to alloc

    @property
    def func_name(self) -> str:
        return self.sig.func_name


@dataclass
class Plan:
    steps: list[Step]
    node_dims: dict[str, Dims]       # every node (incl. temps) → dims
    input_nodes: list[str]           # data/label nodes to be fed
    weight_nodes: list[str]          # nodes fed from pipe.op_params
    output_nodes: list[str]          # sink nodes
    # fused-storage pass state: when storage_nhwc, every 4-d activation
    # edge inside the fused program is stored NHWC (edge_prec: its dtype,
    # "" = logical node dtype); boundaries convert once (rtc_fwd fwd)
    storage_nhwc: bool = False
    edge_prec: str = ""
    # weight-prequantization pass: derived node → (source weight node,
    # "q8" int8 tensor | "q8s" per-out_chan f32 scale vector). Engines
    # resolve these via resolve_plan_weights at init.
    weight_transforms: dict = field(default_factory=dict)


def _sig_from_op(op: ConvOp, arg_map: dict[str, str], pipe: ConvPipe,
                 func_name: Optional[str] = None) -> tuple[OpBase, dict[str, str]]:
    """Build a template sig: params from op + dims for each mapped arg."""
    sig = OpBase(dict(op.str_vals), {k: v for k, v in op.nda_vals.items()})
    # drop graph-arg dims recorded under coi names; re-add under template names
    for coi_n in op.coi().bots + op.coi().tops:
        sig.nda_vals.pop(coi_n, None)
    for tmpl_arg, node in arg_map.items():
        sig.set_dims(tmpl_arg, pipe.must_get_node(node).dims)
    if func_name:
        sig.set_func_name(func_name)
    return sig, dict(arg_map)


def lower_pipe(pipe: ConvPipe, tune: Optional[OpTune] = None,
               op_tunes: Optional[dict[str, OpTune]] = None,
               fuse_relu: bool = True,
               train_dropout: bool = False,
               fused_storage: bool = False) -> Plan:
    tune = tune or OpTune.init_from_lexp("()")
    steps: list[Step] = []
    node_dims = {n: nd.dims for n, nd in pipe.nodes.items() if nd.dims is not None}
    weight_nodes: list[str] = []
    for op in pipe.ops.values():
        # bots = [in, filts(, biases)] — a bias-less conv still has a
        # weight at bots[1]; misclassifying it as an input would make the
        # fused path zero-fill it on first touch (silently wrong numerics)
        if op.type in ("Convolution", "Deconvolution", "InnerProduct") and len(op.bots) >= 2:
            weight_nodes += op.bots[1:3]
    input_nodes = [n for n in sorted(pipe.bots) if n not in weight_nodes]
    output_nodes = sorted(pipe.tops)

    for n, d in node_dims.items():
        if 0 in d.shape:
            raise RtErr(f"lowering: node '{n}' has zero-sized dims {d.pretty()} "
                        "(input spatial size too small for this net)")
    for op in pipe.topo_order():
        # annotation writes func_name/work/prec on the op; each lowering
        # re-annotates, and Steps carry signature *copies*, so this is safe
        add_cnn_codegen_annotations(op, tune, op_tunes)
        steps += _lower_op(pipe, op, tune, fuse_relu, train_dropout)
        # in-place ops attached to this op's primary output node
        out_node = pipe.must_get_node(op.tops[0])
        for ip in out_node.in_place_ops:
            if fuse_relu and ip.type == "ReLU" \
                    and op.type in ("Convolution", "Deconvolution",
                                    "InnerProduct") \
                    and out_node.in_place_ops[0] is ip:
                continue  # fused into the conv/deconv step
            steps += _lower_in_place(pipe, ip, train_dropout)
    if getattr(tune, "fuse_resblock", False):
        steps = _fuse_resblocks(steps, node_dims, set(output_nodes), tune)
    if getattr(tune, "fuse_stem", False):
        steps = _fuse_stem(steps, node_dims, set(output_nodes), tune)
    if getattr(tune, "fuse_siblings", False):
        steps = _fuse_sibling_convs(
            steps, node_dims,
            mixed=getattr(tune, "fuse_mixed_siblings", False))
    for s in steps:
        node_dims.update(s.temps)
    if any(s.arg_nodes.get("seed") == DROP_SEED_NODE for s in steps):
        # seeded train-mode dropout: the seed is a fed scalar input
        node_dims[DROP_SEED_NODE] = Dims([("v", 1)], tn="int32_t")
        input_nodes.append(DROP_SEED_NODE)
    plan = Plan(steps, node_dims, input_nodes, weight_nodes, output_nodes)
    _prequant_int8_weights(plan)
    if fused_storage and tune.layout == "nhwc":
        _apply_fused_storage(plan, tune)
        if plan.storage_nhwc and getattr(tune, "q8_edges", False):
            _apply_int8_edges(plan)
    return plan


def _q8_weight(w) -> tuple:
    """Per-out_chan symmetric int8 weight quantization — the same math
    _quantize_conv_operands applies in-program (f32 ops, half-even
    rounding), hoisted to engine init. Returns (wq int8 OIHW-shaped,
    per-out_chan f32 scale vector)."""
    import numpy as np
    wf = np.asarray(w, np.float32)
    axes = tuple(range(1, wf.ndim))
    sw = (np.max(np.abs(wf), axis=axes, keepdims=True) / np.float32(127.0)
          + np.float32(1e-30)).astype(np.float32)
    wq = np.clip(np.round(wf / sw), -127, 127).astype(np.int8)
    return wq, sw.reshape(-1)


def _prequant_int8_weights(plan: Plan) -> None:
    """Hoist int8 WEIGHT quantization out of the per-call program: weight
    scales are input-independent (per-out_chan absmax of the weight
    itself), so quantizing on every forward re-reads and re-rounds every
    quantized filter for nothing — measured as the whole reason the
    vgg fc6 int8 site lost (103M params re-quantized per call,
    ROUND3_NOTES session 8). Each quant8 conv step's filts arg is
    rewritten to a derived int8 node + an f32 scale-vector node, both
    resolved from op_params at engine init (resolve_plan_weights); the
    templates see prequant_w=1 and skip the in-program weight quant.
    Halves the quantized filters' HBM footprint as a side effect."""
    from ..ops.cuda.conv import SIBS
    for s in plan.steps:
        if not s.sig.get_u32_or("quant8", 0):
            continue
        if s.func_name not in ("xla_conv", "xla_conv2"):
            continue
        if s.sig.get_u32_or("no_prequant", 0):
            # per-site opt-out (OpTune prequant_w=0): keep in-program
            # weight quant — measured better on small-weight huge-K convs
            s.sig.nda_vals.pop("no_prequant", None)
            continue
        fas = ["filts"] if s.func_name == "xla_conv" else \
            [f"filts_{t}" for t in SIBS if f"filts_{t}" in s.arg_nodes]
        for fa in fas:
            wnode = s.arg_nodes[fa]
            wd = plan.node_dims[wnode]
            qn, sn = wnode + "__q8", wnode + "__q8s"
            plan.node_dims[qn] = wd.with_tn("int8_t")
            plan.node_dims[sn] = Dims.make(tn="float",
                                           out_chan=wd["out_chan"])
            plan.weight_transforms[qn] = (wnode, "q8")
            plan.weight_transforms[sn] = (wnode, "q8s")
            s.arg_nodes[fa] = qn
            s.arg_nodes[fa + "_scale"] = sn
            s.sig.set_dims(fa, plan.node_dims[qn])
            s.sig.set_dims(fa + "_scale", plan.node_dims[sn])
        s.sig.set_u32("prequant_w", 1)
    if not plan.weight_transforms:
        return
    referenced = {n for s in plan.steps for n in s.arg_nodes.values()}
    plan.weight_nodes = (
        [n for n in plan.weight_nodes if n in referenced]
        + [n for n in plan.weight_transforms if n in referenced])


def resolve_plan_weights(plan: Plan, op_params: dict) -> dict:
    """plan.weight_nodes → numpy values: raw op_params plus the
    prequantization pass's derived nodes (shared per-source cache so each
    weight quantizes once)."""
    import numpy as np
    out: dict = {}
    qcache: dict = {}
    missing = []
    for n in plan.weight_nodes:
        tr = plan.weight_transforms.get(n)
        if tr is not None:
            src, kind = tr
            if src not in op_params:
                missing.append(src)
                continue
            if src not in qcache:
                v = op_params[src]
                qcache[src] = _q8_weight(v.v if hasattr(v, "v") else v)
            out[n] = qcache[src][0 if kind == "q8" else 1]
        elif n in op_params:
            v = op_params[n]
            out[n] = v.v if hasattr(v, "v") else np.asarray(v)
        else:
            missing.append(n)
    if missing:
        raise RtErr(f"missing weights for {sorted(set(missing))}")
    return out


def _apply_fused_storage(plan: Plan, tune) -> None:
    """Storage pass: mark every step io_layout=nhwc (+ edge_prec) so the
    fused program keeps activations NHWC in compute dtype end-to-end —
    no per-op wrapping transposes, no f32 edge round-trips. Only applies
    when every template in the plan declares nhwc_ok (else the plan keeps
    the wrapper-transpose behavior, which is always correct)."""
    if not all(get_template(s.func_name).nhwc_ok for s in plan.steps):
        return
    ep = ""
    if tune.prec == "bf16" and getattr(tune, "edge_prec", "") != "f32":
        ep = "bf16"
    for s in plan.steps:
        s.sig.str_vals["io_layout"] = "nhwc"
        if ep:
            s.sig.str_vals["edge_prec"] = ep
    plan.storage_nhwc = True
    plan.edge_prec = ep


def _apply_int8_edges(plan: Plan) -> None:
    """int8 storage edges (OpTune q8_edges, storage-NHWC plans only).

    The static-int8 preset's per-site activation quantize is a separate
    bandwidth-bound kernel per site: the producer conv writes the bf16
    activation, a clamp/round/convert pass re-reads and re-writes it as
    int8, then the consumer conv reads the int8 (measured 2.05 ms of the
    7.6 ms resnet-50 b128 int8 step — cnet_xprof, ROUND4_NOTES). When
    EVERY consumer of a node is a static-scale prequantized-int8 xla_conv
    and its single producer is an xla_conv, the edge itself can be stored
    int8: the producer quantizes in its (already-fused) epilogue
    (out_q8 + out_scale) and each consumer skips its in-program quantize
    (in_q8) — the separate pass disappears and the edge's HBM write/read
    drop from bf16 to int8 bytes. Same quantization arithmetic up to one
    int8 code at bucket boundaries: the producer quantizes its f32
    accumulator, where the replaced per-site pass quantized the
    bf16-ROUNDED stored edge (test_q8_edges_pass_flips_and_guards pins
    the resulting <=0.02 prob delta) — not bit-identical.
    (TPU-native extension of the reference's per-layer quantize hooks,
    rtc_fwd.cc:28-37 — same hook point, opposite goal: theirs emulated
    low precision for accuracy studies, this removes redundant passes.)"""
    prod: dict[str, list[Step]] = {}
    cons: dict[str, list[Step]] = {}
    for s in plan.steps:
        tmpl = get_template(s.func_name)
        for an in tmpl.out_args() + tmpl.io_args():
            if an in s.arg_nodes:
                prod.setdefault(s.arg_nodes[an], []).append(s)
        for an in tmpl.in_args() + tmpl.io_args():
            if an in s.arg_nodes:
                cons.setdefault(s.arg_nodes[an], []).append(s)
    skip = set(plan.input_nodes) | set(plan.output_nodes) \
        | set(plan.weight_nodes)
    for n, readers in cons.items():
        if n in skip or len(prod.get(n, ())) != 1:
            continue
        p = prod[n][0]
        if p.func_name != "xla_conv" or p.sig.get_u32_or("out_q8", 0):
            continue
        # every reader: a static-scale prequantized int8 xla_conv whose
        # MAIN input (not filts/biases) is this node
        scales = []
        ok = True
        for r in readers:
            if (r.func_name != "xla_conv"
                    or r.arg_nodes.get("in") != n
                    or not r.sig.get_u32_or("quant8", 0)
                    or not r.sig.get_u32_or("prequant_w", 0)
                    or "act_scale" not in r.sig.nda_vals):
                ok = False
                break
            scales.append(float(r.sig.nda_vals["act_scale"].item()))
        if not ok or not scales or max(scales) != min(scales) \
                or scales[0] <= 0:
            continue  # mixed consumers or inconsistent calibration: keep
        from ..core.dims import NDA as _NDA
        p.sig.set_u32("out_q8", 1)
        p.sig.nda_vals["out_scale"] = _NDA.scalar(scales[0], "float")
        for r in readers:
            r.sig.set_u32("in_q8", 1)


def _fuse_sibling_convs(steps: list[Step], node_dims,
                        mixed: bool = False) -> list[Step]:
    """Horizontal fusion: up to four conv steps sharing the same input
    node and stride (ResNet stage-boundary projection pairs; googlenet
    inception 1x1 branches) become one `xla_conv2` step whose filters
    concatenate on out_chan — narrow-N siblings widen onto the MXU lanes
    and the input streams from HBM once (measured: res2a pair 0.91 ->
    0.21 ms isolated, b128 bf16). Per-sibling ReLU flags preserved.

    With `mixed`, kernel sizes may also differ when the embed invariant
    holds — equal (2*pad - kern) per axis — in which case the smaller
    kernel runs center-embedded in the larger with its pad adjusted (a
    1x1 pad-0 conv IS a 3x3 pad-1 conv with the weight zero-padded to
    the center: exact arithmetic, just more MACs). Off by default: the
    squeezenet fire expand pairs it targets LOSE on-chip (8.48 vs 4.17
    ms b128 — the embedded-MAC waste dominates at those tiny shapes)."""
    from ..ops.cuda.conv import SIBS

    def sib_key(s: Step):
        # s2d_conv excluded: its phase-transform semantics differ from the
        # plain conv xla_conv2 computes
        if s.func_name not in ("xla_conv", "k1conv", "conv"):
            return None
        if "biases" not in s.arg_nodes:
            return None  # keep the template's paired-args form simple
        sig = s.sig
        fd = sig.get_dims("filts")
        st = sig.get_dims_or_none("stride")
        pd = sig.get_dims_or_none("in_pad")
        sy, sx = (st["y"], st["x"]) if st is not None else (1, 1)
        py, px = (pd["y"], pd["x"]) if pd is not None else (0, 0)
        # (2p - k) equal per axis <=> same output size from the shared
        # input, same window alignment, same kernel parity — the exact
        # condition for center-embedding mixed kernel sizes; without
        # `mixed` the kernel/pad themselves join the key (exact match)
        geo = (2 * py - fd["y"], 2 * px - fd["x"]) if mixed \
            else (fd["y"], fd["x"], py, px)
        parts = [s.arg_nodes["in"], (sy, sx), geo, fd["in_chan"]]
        parts.append(sig.str_vals.get("prec", ""))
        parts.append(sig.get_u32_or("quant8", 0))
        return tuple(parts)

    groups: dict = {}
    for i, s in enumerate(steps):
        k = sib_key(s)
        if k is not None:
            groups.setdefault(k, []).append(i)
    merged: dict[int, list[int]] = {}   # first idx -> member idxs
    drop: set[int] = set()
    for idxs in groups.values():
        for j in range(0, len(idxs) - 1, len(SIBS)):
            grp = idxs[j:j + len(SIBS)]
            if len(grp) >= 2:
                merged[grp[0]] = grp
                drop.update(grp[1:])

    out: list[Step] = []
    for i, s in enumerate(steps):
        if i in drop:
            continue
        if i not in merged:
            out.append(s)
            continue
        members = [steps[m] for m in merged[i]]
        sig = OpBase({"type": "xla_conv2", "func_name": "xla_conv2"})
        sig.set_dims("in", s.sig.get_dims("in"))
        arg_nodes = {"in": s.arg_nodes["in"]}
        for tag, m in zip(SIBS, members):
            sig.nda_vals[f"filts_{tag}"] = m.sig.nda_vals["filts"]
            sig.nda_vals[f"biases_{tag}"] = m.sig.nda_vals["biases"]
            sig.nda_vals[f"out_{tag}"] = m.sig.nda_vals["out"]
            arg_nodes[f"filts_{tag}"] = m.arg_nodes["filts"]
            arg_nodes[f"biases_{tag}"] = m.arg_nodes["biases"]
            arg_nodes[f"out_{tag}"] = m.arg_nodes["out"]
            if m.sig.get_u32_or("conv_has_relu", 0):
                sig.set_u32(f"relu_{tag}", 1)
        if "stride" in s.sig.nda_vals:
            sig.nda_vals["stride"] = s.sig.nda_vals["stride"]
        # fused geometry = the largest member kernel; every member's pad
        # plus its embed margin lands on the same fused pad (sib_key)
        fds = [m.sig.get_dims("filts") for m in members]
        ky_f = max(d["y"] for d in fds)
        kx_f = max(d["x"] for d in fds)
        pd0 = s.sig.get_dims_or_none("in_pad")
        p0y, p0x = (pd0["y"], pd0["x"]) if pd0 is not None else (0, 0)
        sig.set_null_dims("kern_sz", y=ky_f, x=kx_f)
        py_f = p0y + (ky_f - fds[0]["y"]) // 2
        px_f = p0x + (kx_f - fds[0]["x"]) // 2
        if py_f or px_f:
            sig.set_null_dims("in_pad", y=py_f, x=px_f)
        if s.sig.get_u32_or("quant8", 0):
            sig.set_u32("quant8", 1)
            if any(m.sig.get_u32_or("no_prequant", 0) for m in members):
                sig.set_u32("no_prequant", 1)
            # calibrated static act scales: the siblings share one input
            # node so their scales agree by construction (max = defensive)
            scales = [float(m.sig.nda_vals["act_scale"].item())
                      for m in members if "act_scale" in m.sig.nda_vals]
            if scales:
                from ..core.dims import NDA as _NDA
                sig.nda_vals["act_scale"] = _NDA.scalar(max(scales), "float")
        if all(m.sig.get_u32_or("grad_q8", 0) for m in members):
            # int8 wgrad (training) survives fusion only when EVERY
            # member opted in — the fused step has ONE weight gradient
            sig.set_u32("grad_q8", 1)
        for k in ("prec", "layout"):
            if k in s.sig.str_vals:
                sig.str_vals[k] = s.sig.str_vals[k]
        out.append(Step(sig, arg_nodes,
                        "+".join(m.call_tag for m in members)))
    return out


def _fuse_stem(steps: list[Step], node_dims, outputs: set,
               tune) -> list[Step]:
    """Fuse [thin-channel conv s2 (+fused ReLU), maxpool s2] into one
    `fused_stem` step (ops/pallas/stem.py) — the ResNet/VGG stem. The
    conv activation (the net's largest tensor) then never touches HBM."""
    uses: dict[str, int] = {}
    for s in steps:
        for node in s.arg_nodes.values():
            uses[node] = uses.get(node, 0) + 1
    out: list[Step] = []
    i = 0
    while i < len(steps):
        ok = False
        if i + 1 < len(steps):
            s1, s2 = steps[i], steps[i + 1]
            st = s1.sig.get_dims_or_none("stride")
            pst = s2.sig.get_dims_or_none("stride")
            ppd = s2.sig.get_dims_or_none("in_pad")
            fdims = s1.sig.get_dims_or_none("filts")
            ok = (s1.func_name in ("xla_conv", "s2d_conv", "conv")
                  and s1.sig.get_u32_or("conv_has_relu", 0) == 1
                  and st is not None and st["y"] == 2 and st["x"] == 2
                  and fdims is not None and fdims["in_chan"] <= 4
                  and s2.func_name == "pool"
                  and s2.sig.str_vals.get("avg_pool") not in ("1",)
                  and pst is not None and pst["y"] == 2 and pst["x"] == 2
                  and (ppd is None or (ppd["y"] == 0 and ppd["x"] == 0))
                  and s2.arg_nodes["in"] == s1.arg_nodes["out"]
                  and uses.get(s1.arg_nodes["out"], 0) == 2
                  and s1.arg_nodes["out"] not in outputs
                  # per-op quant8/prec overrides don't propagate into the
                  # fused sig — leave such a stem unfused
                  and not s1.sig.get_u32_or("quant8", 0)
                  and s1.sig.str_vals.get("prec", tune.prec) == tune.prec)
        if ok:
            s1, s2 = steps[i], steps[i + 1]
            sig = OpBase({"type": "fused_stem", "func_name": "fused_stem"})
            sig.set_dims("in", node_dims[s1.arg_nodes["in"]])
            sig.set_dims("filts", node_dims[s1.arg_nodes["filts"]])
            arg_nodes = {"in": s1.arg_nodes["in"],
                         "filts": s1.arg_nodes["filts"],
                         "out": s2.arg_nodes["out"]}
            if "biases" in s1.arg_nodes:
                sig.set_dims("biases", node_dims[s1.arg_nodes["biases"]])
                arg_nodes["biases"] = s1.arg_nodes["biases"]
            sig.set_dims("out", node_dims[s2.arg_nodes["out"]])
            for k in ("in_pad", "stride", "kern_sz"):
                if k in s1.sig.nda_vals:
                    sig.nda_vals[k] = s1.sig.nda_vals[k]
            sig.nda_vals["pool_kern"] = s2.sig.nda_vals["kern_sz"]
            sig.nda_vals["pool_stride"] = s2.sig.nda_vals["stride"]
            if "in_pad" in s2.sig.nda_vals:
                sig.nda_vals["pool_pad"] = s2.sig.nda_vals["in_pad"]
            sig.set_u32("conv_has_relu", 1)
            if tune.prec:
                sig.str_vals["prec"] = tune.prec
            out.append(Step(sig, arg_nodes, s1.call_tag + "__stem"))
            i += 2
        else:
            out.append(steps[i])
            i += 1
    return out


def _fuse_resblocks(steps: list[Step], node_dims, outputs: set,
                    tune) -> list[Step]:
    """Fuse [conv1x1+relu, conv3x3s1p1+relu, conv1x1, eltwise-add, relu]
    step runs into one `resblock` step (identity-shortcut bottlenecks;
    see ops/pallas/resblock.py). Interior nodes must be single-use."""
    # consumer counts over all steps (interior nodes must only feed the chain)
    uses: dict[str, int] = {}
    for s in steps:
        for a, node in s.arg_nodes.items():
            uses[node] = uses.get(node, 0) + 1

    def is_conv(s, k, pad, relu):
        if s.func_name not in ("xla_conv", "conv", "tconv", "k1conv"):
            return False
        ks = s.sig.get_dims_or_none("kern_sz")
        st = s.sig.get_dims_or_none("stride")
        pd = s.sig.get_dims_or_none("in_pad")
        if ks is None or ks["y"] != k or ks["x"] != k:
            return False
        if st is not None and (st["y"] != 1 or st["x"] != 1):
            return False
        if (pd["y"] if pd is not None else 0) != pad:
            return False
        return (s.sig.get_u32_or("conv_has_relu", 0) == 1) == relu

    out: list[Step] = []
    i = 0
    while i < len(steps):
        win = steps[i:i + 5]
        ok = False
        if len(win) == 5:
            s1, s2, s3, s4, s5 = win
            ok = (is_conv(s1, 1, 0, True) and is_conv(s2, 3, 1, True)
                  and is_conv(s3, 1, 0, False)
                  and s4.func_name == "eltwise"
                  and s4.sig.str_vals.get("ew_op", "SUM") == "SUM"
                  and s5.func_name == "relu"
                  # per-op quant8/prec overrides (selective-int8 preset,
                  # wisdom tunes) don't propagate into the fused sig —
                  # leave such members unfused rather than silently
                  # running them at the global precision
                  and not any(s.sig.get_u32_or("quant8", 0)
                              or s.sig.str_vals.get("prec", tune.prec
                                                    ) != tune.prec
                              for s in (s1, s2, s3)))
            if ok:
                x = s1.arg_nodes["in"]
                u, v, w_node = (s1.arg_nodes["out"], s2.arg_nodes["out"],
                                s3.arg_nodes["out"])
                ok = (s2.arg_nodes["in"] == u and s3.arg_nodes["in"] == v
                      and {s4.arg_nodes["a"], s4.arg_nodes["b"]} == {x, w_node}
                      and s5.arg_nodes["inout"] == s4.arg_nodes["out"]
                      and node_dims[x].shape == node_dims[s4.arg_nodes["out"]].shape
                      and all(uses.get(nd, 0) == 2 and nd not in outputs
                              for nd in (u, v, w_node)))
                # u/v/w each appear twice: once as producer out, once as input
        if ok:
            s1, s2, s3, s4, s5 = win
            sig = OpBase({"type": "resblock", "func_name": "resblock"})
            sig.set_dims("in", node_dims[s1.arg_nodes["in"]])
            sig.set_dims("w1", node_dims[s1.arg_nodes["filts"]])
            sig.set_dims("b1", node_dims[s1.arg_nodes["biases"]])
            sig.set_dims("w2", node_dims[s2.arg_nodes["filts"]])
            sig.set_dims("b2", node_dims[s2.arg_nodes["biases"]])
            sig.set_dims("w3", node_dims[s3.arg_nodes["filts"]])
            sig.set_dims("b3", node_dims[s3.arg_nodes["biases"]])
            sig.set_dims("out", node_dims[s4.arg_nodes["out"]])
            sig.set_u32("relu_out", 1)
            if tune.prec:
                sig.str_vals["prec"] = tune.prec
            out.append(Step(sig, {"in": s1.arg_nodes["in"],
                                  "w1": s1.arg_nodes["filts"],
                                  "b1": s1.arg_nodes["biases"],
                                  "w2": s2.arg_nodes["filts"],
                                  "b2": s2.arg_nodes["biases"],
                                  "w3": s3.arg_nodes["filts"],
                                  "b3": s3.arg_nodes["biases"],
                                  "out": s4.arg_nodes["out"]},
                            s4.call_tag + "__resblock"))
            i += 5
        else:
            out.append(steps[i])
            i += 1
    return out


def _lower_op(pipe: ConvPipe, op: ConvOp, tune: OpTune, fuse_relu: bool,
              train_dropout: bool) -> list[Step]:
    t = op.type
    if t == "Data":
        return []
    if t in ("Convolution", "Deconvolution"):
        arg_map = {"in": op.bots[0], "filts": op.bots[1], "out": op.tops[0]}
        if len(op.bots) > 2:
            arg_map["biases"] = op.bots[2]
        sig, am = _sig_from_op(op, arg_map, pipe)
        out_node = pipe.must_get_node(op.tops[0])
        if fuse_relu and out_node.in_place_ops and out_node.in_place_ops[0].type == "ReLU":
            sig.set_u32("conv_has_relu", 1)
        return [Step(sig, am, op.tag)]
    if t == "InnerProduct":
        arg_map = {"in": op.bots[0], "filts": op.bots[1], "out": op.tops[0]}
        if len(op.bots) > 2:
            arg_map["biases"] = op.bots[2]
        sig, am = _sig_from_op(op, arg_map, pipe, func_name="ipconv")
        ind = pipe.must_get_node(op.bots[0]).dims
        sig.set_null_dims("kern_sz", y=ind["y"], x=ind["x"])
        sig.set_null_dims("stride", y=1, x=1)
        sig.set_null_dims("in_pad", y=0, x=0)
        out_node = pipe.must_get_node(op.tops[0])
        if fuse_relu and out_node.in_place_ops and out_node.in_place_ops[0].type == "ReLU":
            sig.set_u32("conv_has_relu", 1)
        return [Step(sig, am, op.tag)]
    if t in ("Pooling",):
        ind = pipe.must_get_node(op.bots[0]).dims
        sig, am = _sig_from_op(op, {"in": op.bots[0], "out": op.tops[0]}, pipe)
        ks = op.kern_sz()
        if ks.is_zeros():  # global pooling
            sig.set_null_dims("kern_sz", y=ind["y"], x=ind["x"])
        sig.str_vals["avg_pool"] = str(op.get_u32_or("avg_pool", 0))
        sig.nda_vals.pop("avg_pool", None)
        return [Step(sig, am, op.tag)]
    if t == "LRN":
        sig, am = _sig_from_op(op, {"in": op.bots[0], "out": op.tops[0]}, pipe)
        return [Step(sig, am, op.tag)]
    if t == "Softmax":
        sig, am = _sig_from_op(op, {"in": op.bots[0], "out": op.tops[0]}, pipe,
                               func_name="softmax")
        return [Step(sig, am, op.tag)]
    if t == "SoftmaxWithLoss":
        in_dims = pipe.must_get_node(op.bots[0]).dims
        pel_loss = f"{op.tag}__pel_loss"
        pel_dims = Dims.make(tn=in_dims.tn, img=in_dims["img"], y=in_dims["y"], x=in_dims["x"])
        sig1 = OpBase({"type": t, "func_name": "sm_grad_and_loss"})
        sig1.set_dims("in", in_dims)
        sig1.set_dims("label", pipe.must_get_node(op.bots[1]).dims)
        sig1.set_dims("in_grad", pipe.must_get_node(op.tops[0]).dims)
        sig1.set_dims("loss", pel_dims)
        s1 = Step(sig1, {"in": op.bots[0], "label": op.bots[1],
                         "in_grad": op.tops[0], "loss": pel_loss},
                  op.tag, temps={pel_loss: pel_dims})
        sig2 = OpBase({"type": t, "func_name": "sum_loss_over_imgs"})
        sig2.set_dims("loss", pel_dims)
        loss_out = Dims.make(tn=in_dims.tn, n=1)
        sig2.set_dims("loss_sum", loss_out)
        s2 = Step(sig2, {"loss": pel_loss, "loss_sum": op.tops[1]},
                  f"{op.tag}__sum")
        return [s1, s2]
    if t in ("Concat",):
        out_dims = pipe.must_get_node(op.tops[0]).dims
        steps = []
        ocix = 0
        for i, b in enumerate(op.bots):
            bd = pipe.must_get_node(b).dims
            sig = OpBase({"type": t, "func_name": "copy"})
            sig.set_dims("in", bd)
            sig.set_dims("out", out_dims)
            sig.set_u32("ocix", ocix)
            steps.append(Step(sig, {"in": b, "out": op.tops[0]}, f"{op.tag}__{i}"))
            ocix += bd["chan"]
        return steps
    if t == "Split":
        # Concat-bck: tops partition the input chans (running icix offsets);
        # Eltwise-bck: each top is a full-chan copy (icix stays 0)
        in_dims = pipe.must_get_node(op.bots[0]).dims
        steps = []
        icix = 0
        for i, tp in enumerate(op.tops):
            td = pipe.must_get_node(tp).dims
            sig = OpBase({"type": t, "func_name": "split_copy"})
            sig.set_dims("in", in_dims)
            sig.set_dims("out", td)
            sig.set_u32("icix", icix)
            steps.append(Step(sig, {"in": op.bots[0], "out": tp}, f"{op.tag}__{i}"))
            if td["chan"] < in_dims["chan"]:
                icix += td["chan"]
        return steps
    if t == "Eltwise":
        out = op.tops[0]
        out_dims = pipe.must_get_node(out).dims
        ew_op = op.str_vals.get("ew_op", "SUM")
        steps = []
        acc = op.bots[0]
        for i, b in enumerate(op.bots[1:]):
            sig = OpBase({"type": t, "func_name": "eltwise", "ew_op": ew_op})
            sig.set_dims("a", pipe.must_get_node(acc).dims if i == 0 else out_dims)
            sig.set_dims("b", pipe.must_get_node(b).dims)
            sig.set_dims("out", out_dims)
            steps.append(Step(sig, {"a": acc, "b": b, "out": out}, f"{op.tag}__{i}"))
            acc = out
        return steps
    if t == "Reduce":
        # partial-grad summation (add_bck_ops): chained binary adds — XLA
        # fuses the chain into one kernel inside the jitted program
        out = op.tops[0]
        out_dims = pipe.must_get_node(out).dims
        steps = []
        acc = op.bots[0]
        for i, b in enumerate(op.bots[1:]):
            sig = OpBase({"type": t, "func_name": "eltwise", "ew_op": "SUM"})
            sig.set_dims("a", pipe.must_get_node(acc).dims if i == 0 else out_dims)
            sig.set_dims("b", pipe.must_get_node(b).dims)
            sig.set_dims("out", out_dims)
            steps.append(Step(sig, {"a": acc, "b": b, "out": out}, f"{op.tag}__{i}"))
            acc = out
        return steps
    if t == "Spreading":
        sig, am = _sig_from_op(op, {"out": op.bots[0], "out_grad": op.bots[1],
                                    "in": op.bots[2], "in_grad": op.tops[0]}, pipe)
        sig.str_vals["avg_pool"] = str(op.get_u32_or("avg_pool", 0))
        sig.nda_vals.pop("avg_pool", None)
        return [Step(sig, am, op.tag)]
    if t == "BckConv":
        sig, am = _sig_from_op(op, {"in": op.bots[0], "filts": op.bots[1],
                                    "out_grad": op.bots[3],
                                    "in_grad": op.tops[0],
                                    "filts_grad": op.tops[1],
                                    "biases_grad": op.tops[2]}, pipe)
        return [Step(sig, am, op.tag)]
    if t == "BckLRN":
        sig, am = _sig_from_op(op, {"in": op.bots[0], "out_grad": op.bots[2],
                                    "in_grad": op.tops[0]}, pipe)
        return [Step(sig, am, op.tag)]
    if t in ("Scale", "BatchNorm", "Accuracy"):
        raise RtErr(f"op type '{t}' requires import-time folding (caffe_io) "
                    "and should not reach lowering")
    raise RtErr(f"lowering: unhandled op type '{t}'")


def _lower_in_place(pipe: ConvPipe, ip: ConvOp, train_dropout: bool) -> list[Step]:
    node = ip.bots[0]
    dims = pipe.must_get_node(node).dims
    if ip.type == "ReLU":
        sig = OpBase({"type": "ReLU", "func_name": "relu"})
        sig.set_dims("inout", dims)
        return [Step(sig, {"inout": node}, ip.tag)]
    if ip.type in ("Dropout", "BckDropout"):
        sig = OpBase({"type": ip.type, "func_name": "dropout",
                      "drop_mode": "train" if train_dropout else "infer"})
        sig.set_dims("inout", dims)
        if "dropout_ratio" in ip.nda_vals:
            sig.nda_vals["dropout_ratio"] = ip.nda_vals["dropout_ratio"]
        args = {"inout": node}
        if train_dropout:
            # per-STEP mask: the seed is a fed input node (the solver
            # passes the global step index), so each training step draws
            # a fresh mask — caffe's per-iteration redraw semantics
            # (dropout_layer.cpp), not a trace-time constant
            sig.set_dims("seed", Dims([("v", 1)], tn="int32_t"))
            args["seed"] = DROP_SEED_NODE
        return [Step(sig, args, ip.tag)]
    if ip.type == "ZeroIfNonPos":
        sig = OpBase({"type": ip.type, "func_name": "ZeroIfNonPos"})
        # 'in' is the FORWARD activation (bots[1]) — declare ITS dims,
        # not the grad node's (same-shaped for ReLU-bck today, but the
        # sig must describe the tensor the arg actually receives)
        sig.set_dims("in", pipe.must_get_node(ip.bots[1]).dims)
        sig.set_dims("grad", dims)
        sig.set_dims("out", dims)
        return [Step(sig, {"in": ip.bots[1], "grad": node, "out": node}, ip.tag)]
    raise RtErr(f"unhandled in-place op type '{ip.type}'")
