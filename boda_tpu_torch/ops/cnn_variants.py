"""Per-op variant selection + tuning knobs: the cnn_op.cc equivalent.

Capability parity with op_tune_t + add_cnn_codegen_annotations
(cnn_op.H:10-32, cnn_op.cc:16-68): a tune record (selectable per-op) picks
the kernel variant (func_name) for each graph op from its shape and the
enabled-variant flags, and attaches block-shape `work` dims. The reference
rewrote arg dims to blocked layouts and inserted transposes; on TPU the
variant builders own their internal layouts (NHWC etc.) and XLA handles the
data movement, so annotation = variant pick + work dims + fusion flags.

Tune record text form (wisdom-file compatible keys):
  (use_culibs=1)                  — force vendor (XLA) kernels
  (k1conv=1,ipconv=1,tconv=1)     — enable variants
  (MNb=..., Kb=..., prec=bf16)    — block shapes / precision

The port's copy of boda_tpu/ops/cnn_variants.py.
"""

from __future__ import annotations

from typing import Optional, Union

from ..core.config import Attr, Config
from ..core.dims import Dims
from ..core.error import RtErr
from ..core.lexp import Lexp
from .op_base import OpBase


class OpTune(Config):
    """Tuning knobs (reference: op_tune_t cnn_op.H:10-32)."""

    use_culibs = Attr(bool, default=False, help="use vendor (stock XLA) kernels")
    k1conv = Attr(bool, default=True, help="enable 1x1-conv-as-matmul variant")
    ipconv = Attr(bool, default=True, help="enable inner-product variant")
    tconv = Attr(bool, default=True, help="enable spatial-tiled conv variant")
    tconv_max_ksz = Attr(list[int], default="11 11", help="max kernel for tconv")
    Mb = Attr(int, default=0, help="matmul M block (0=auto)")
    Nb = Attr(int, default=0, help="matmul N block (0=auto)")
    Kb = Attr(int, default=0, help="matmul K block (0=auto)")
    prec = Attr(str, default="", help="'' (f32) or 'bf16' compute precision")
    layout = Attr(str, default="", help="'' (nchw) or 'nhwc' internal conv "
                  "layout; in the fused whole-program path nhwc enables the "
                  "storage pass: every inter-op edge is stored NHWC with NO "
                  "per-op transposes (TPU convs are feature-minor)")
    edge_prec = Attr(str, default="", help="inter-op edge storage dtype in "
                     "the fused nhwc path: '' = follow prec (bf16 edges when "
                     "prec=bf16 — halves HBM traffic on memory-bound nets); "
                     "'f32' forces f32 edges")
    fuse_siblings = Attr(bool, default=False,
                         help="horizontally fuse sibling convs sharing "
                              "one input (ResNet projection pairs) into "
                              "one wide conv (xla_conv2): narrow-N "
                              "siblings widen onto the MXU lanes and the "
                              "input streams from HBM once")
    fuse_mixed_siblings = Attr(
        bool, default=False,
        help="with fuse_siblings: also fuse siblings whose KERNEL SIZES "
             "differ but whose (2*pad - kern) matches per axis, center-"
             "embedding the smaller kernel (exact arithmetic, extra MACs). "
             "Measured LOSS on squeezenet fire expand pairs (8.48 vs 4.17 "
             "ms b128 — the 1.8x embedded-MAC waste is not recouped at "
             "those tiny shapes), so off by default; capability kept for "
             "shapes where the wasted taps are cheap")
    fuse_stem = Attr(bool, default=False,
                     help="fuse the thin-channel stride-2 stem conv "
                          "(+ReLU) and its maxpool into one Pallas kernel "
                          "(ops/pallas/stem.py): phase-stacked in-VMEM "
                          "im2col; the conv1 activation never touches HBM")
    fuse_resblock = Attr(bool, default=False,
                         help="fuse identity-shortcut bottlenecks "
                              "(1x1-3x3-1x1+add+relu) into one Pallas "
                              "kernel (VMEM-resident block)")
    quant8 = Attr(bool, default=False,
                  help="int8 conv execution: dynamic per-tensor activation "
                       "quantization + per-out_chan weight quantization "
                       "inside each conv (int8 MXU matmul, f32 rescale; "
                       "edges keep prec/edge_prec). The TPU-native "
                       "extension of the reference's fixed-point quantize "
                       "hooks (rtc_fwd.cc:28-37)")
    act_scale = Attr(float, default=0.0,
                     help="with quant8: CALIBRATED activation absmax for "
                          "this site (static quantization — skips the "
                          "per-call dynamic max reduction); 0 = dynamic. "
                          "Produced by tune/presets.calibrate_int8_act_scales")
    prequant_w = Attr(bool, default=True,
                      help="with quant8: pre-quantize this site's weights "
                           "at engine init (int8 weights + per-oc scales "
                           "as program inputs) instead of in-program — the "
                           "default and the big-weight win (vgg fc sites "
                           "flipped loss->win); 0 = in-program weight "
                           "quant (measured better on nin's small-weight "
                           "huge-K convs: 1.34 vs 1.42 ms)")
    grad_q8 = Attr(bool, default=False,
                   help="TRAINING: compute this site's weight-gradient "
                        "contraction on the int8 MXU (dynamic per-tensor "
                        "activation scale + per-out-channel cotangent "
                        "scale, int8x8->int32 conv, f32 rescale — "
                        "ops/mxu_grad._wgrad_q8); the input gradient "
                        "stays bf16. Forward numerics unchanged. "
                        "Honored on xla_conv/xla_conv2 NHWC sites")
    q8_edges = Attr(bool, default=False,
                    help="BASE-tune knob (fused-storage NHWC plans): store "
                         "an activation edge as int8 when all its readers "
                         "are static-scale prequantized int8 convs — the "
                         "producer conv quantizes in its epilogue and the "
                         "readers skip their per-site quantize pass "
                         "(engine/lower._apply_int8_edges)")
    pool_bwd_gather = Attr(
        bool, default=False,
        help="max-pool backward via the gather-form first-argmax custom "
             "VJP (ops/pallas/pool) instead of XLA's SelectAndScatter. "
             "Measured 9x SLOWER on the TPU (21.1 vs 2.34 ms, pool1 "
             "b128 — scripts/poolbwd_probe.py) so off by default; a win "
             "only where scatter is the slow path (CPU-class backends)")
    s2d = Attr(bool, default=True,
               help="space-to-depth first-layer transform: stride-2 "
                    "thin-channel convs (conv1 7x7 s2 C<=4) run as "
                    "stride-1 convs over 2x2-phase-stacked input "
                    "(exact; thin channels waste the MXU)")

    def to_lexp(self) -> Lexp:
        # serialize EVERY non-default knob (vs a pristine instance): wisdom
        # records key tunes by this string, so a dropped field (quant8,
        # act_scale, s2d, fuse_*) would collapse distinct tunes into one
        # wisdom key and silently lose the knob on re-application
        dflt = _default_op_tune()
        l = Lexp.empty_list()
        for k in type(self)._attrs:
            v = getattr(self, k)
            if v == getattr(dflt, k):
                continue
            if isinstance(v, bool):
                l.add_key_val(k, "1" if v else "0")
            elif isinstance(v, list):
                l.add_key_val(k, " ".join(str(x) for x in v))
            else:
                l.add_key_val(k, str(v))
        return l

    def __str__(self):
        return str(self.to_lexp())


_DEFAULT_OP_TUNE: Optional[OpTune] = None


def _default_op_tune() -> OpTune:
    global _DEFAULT_OP_TUNE
    if _DEFAULT_OP_TUNE is None:
        _DEFAULT_OP_TUNE = OpTune.init_from_lexp("()")
    return _DEFAULT_OP_TUNE


def make_op_tune(spec: Union[str, None] = None) -> OpTune:
    if spec is None or spec == "":
        spec = "()"
    return OpTune.init_from_lexp(spec)


# map caffe-ish op type → default template name for non-conv ops
_SIMPLE_TEMPLATE = {
    "Pooling": "pool",
    "LRN": "lrn",
    "Softmax": "softmax",
    "SoftmaxWithLoss": "sm_grad_and_loss",
    "ReLU": "relu",
    "Dropout": "dropout",
    "BckDropout": "dropout",
    "Scale": "scale",
    "Eltwise": "eltwise",
    "Concat": "copy",
    "Split": "split_copy",
    "Reduce": "reduce",
    "ZeroIfNonPos": "ZeroIfNonPos",
    "Spreading": "Spreading",
    "BckLRN": "bck_lrn",
    "BckConv": "BckConv",
    "sgemm": "sgemm",
}


def _set_or_pop_str(op: OpBase, key: str, val: str) -> None:
    if val:
        op.str_vals[key] = val
    else:
        op.str_vals.pop(key, None)


def _set_or_pop_dims(op: OpBase, key: str, dims) -> None:
    if dims is not None:
        op.set_dims(key, dims)
    else:
        op.nda_vals.pop(key, None)


def add_cnn_codegen_annotations(op: OpBase, tune: OpTune,
                                op_tunes: Optional[dict[str, OpTune]] = None) -> None:
    """Select func_name (+ work dims / prec) for one op (reference:
    add_cnn_codegen_annotations cnn_op.cc:16; per-op tune override map
    cnn_op.cc:75 via op_tunes keyed by op type or tag)."""
    t = tune
    if op_tunes:
        key = getattr(op, "tag", None) or op.str_vals.get("tag") or op.type
        t = op_tunes.get(key, op_tunes.get(op.type, tune))
    if op.type in ("Convolution", "Deconvolution"):
        ind = op.get_dims("in")
        fd = op.get_dims("filts")
        st = op.get_dims_or_none("stride")
        sy, sx = (st["y"], st["x"]) if st else (1, 1)
        grouped = op.get_u32_or("groups", 1) > 1
        if grouped:
            # a grouped conv runs on the vendor template under any tune:
            # its own kernel there (B8) or the vendor conv; no B1/B2
            # template, fused stem or resblock takes one
            fn = "xla_conv"
        elif op.type != "Deconvolution" and t.s2d and sy == 2 and sx == 2 \
                and fd["in_chan"] <= 4 and fd["y"] >= 3 and fd["x"] >= 3:
            # first-layer transform beats both hand and vendor paths on
            # TPU regardless of use_culibs (it lowers to an XLA conv)
            fn = "s2d_conv"
        elif op.type == "Deconvolution":
            # real transposed-conv template (lhs_dilation); routing this to
            # xla_conv would silently compute a plain conv
            fn = "deconv"
        elif t.use_culibs:
            fn = "xla_conv"
        elif t.ipconv and fd["y"] == ind["y"] and fd["x"] == ind["x"] \
                and op.get_dims("out")["y"] == 1 and op.get_dims("out")["x"] == 1 \
                and (not op.get_dims_or_none("in_pad")
                     or op.get_dims("in_pad").sz() == 0
                     or (op.get_dims("in_pad")["y"] == 0 and op.get_dims("in_pad")["x"] == 0)):
            fn = "ipconv"
        elif t.k1conv and fd["y"] == 1 and fd["x"] == 1:
            fn = "k1conv"
        elif t.tconv and sy == 1 and sx == 1 \
                and fd["y"] <= t.tconv_max_ksz[0] and fd["x"] <= t.tconv_max_ksz[1] \
                and fd["in_chan"] % 128 == 0:
            # default gate: lane-exact channel counts (no padding waste).
            # tconv itself now lane-pads any in_chan to 128-multiples, so
            # tuning sweeps (ops_prof) can try it on every sig and per-op
            # wisdom can override this default
            fn = "tconv"  # spatial-tiled Pallas conv (stride-1 bands)
        elif fd["y"] <= t.tconv_max_ksz[0] and fd["x"] <= t.tconv_max_ksz[1]:
            fn = "conv"  # im2col + Pallas matmul (strided/general)
        else:
            fn = "xla_conv"
        op.set_func_name(fn)
        # unconditionally assign OR clear every tune-derived annotation so
        # re-annotating the same op graph with a different tune can't
        # inherit stale values (order-dependent sweep results otherwise —
        # cnet_tune re-lowers one pipe per tune record)
        _set_or_pop_dims(op, "work",
                         Dims.make(tn="none", Mb=t.Mb, Nb=t.Nb, Kb=t.Kb)
                         if (t.Mb or t.Nb or t.Kb) else None)
        _set_or_pop_str(op, "prec", t.prec)
        _set_or_pop_str(op, "layout", t.layout)
        if t.quant8 and grouped:
            raise RtErr(f"quant8 at grouped conv site "
                        f"'{getattr(op, 'tag', op.type)}': the int8 conv "
                        f"(B6) is ungrouped; keep the site in float")
        if t.quant8 and fn == "xla_conv" and op.get_dims("filts")["in_chan"] >= 16:
            # int8 execution for the MXU-heavy convs; thin-channel stems
            # stay in float (their error dominates, their flops don't)
            op.set_u32("quant8", 1)
            if t.act_scale:
                from ..core.dims import NDA as _NDA
                op.nda_vals["act_scale"] = _NDA.scalar(t.act_scale, "float")
            else:
                op.nda_vals.pop("act_scale", None)
            # opt-out marker consumed (and popped) by the lowering's
            # weight-prequantization pass
            if not t.prequant_w:
                op.set_u32("no_prequant", 1)
            else:
                op.nda_vals.pop("no_prequant", None)
        else:
            op.nda_vals.pop("quant8", None)
            op.nda_vals.pop("act_scale", None)
            op.nda_vals.pop("no_prequant", None)
        if t.grad_q8 and fn == "xla_conv" and fd["in_chan"] >= 16 \
                and not grouped:
            # int8 weight-gradient contraction (training); same
            # thin-channel gate as quant8 — the stem's error dominates
            # while its wgrad flops don't; ungrouped, as B6 is
            op.set_u32("grad_q8", 1)
        else:
            op.nda_vals.pop("grad_q8", None)
    elif op.type == "InnerProduct":
        if t.grad_q8:
            # LOUD, not silent: IP sites lower to the NCHW xla_conv form
            # whose VJP keeps bf16 (mxu_conv honors wgrad_int8 only for
            # the NHWC storage path) — a grad_q8 A/B here would silently
            # measure the wrong configuration. Use an fc-as-conv net
            # (the *_ng_conv zoo forms) to train fc sites with int8 wgrad.
            raise RtErr(f"grad_q8 is not supported on InnerProduct site "
                        f"'{getattr(op, 'tag', op.type)}' (Convolution "
                        f"sites only; convert fc layers to conv)")
        op.set_func_name("ipconv" if t.ipconv else "xla_conv")
        _set_or_pop_str(op, "prec", t.prec)
    else:
        fn = _SIMPLE_TEMPLATE.get(op.type)
        if fn is not None:
            op.set_func_name(fn)
        if op.type in ("Pooling", "LRN"):
            _set_or_pop_str(op, "layout", t.layout)
        if op.type == "Pooling":
            _set_or_pop_str(op, "pool_bwd",
                            "gather" if t.pool_bwd_gather else "")


def add_codegen_annotations(op: OpBase, tune: OpTune) -> None:
    """sgemm-family annotation (reference: add_codegen_annotations
    cnn_op.cc:334-380): pick sgemm/xla_sgemm + work dims."""
    if op.type == "sgemm":
        if "func_name" not in op.str_vals:
            if tune.prec == "int8":
                op.set_func_name("sgemm_int8")
            else:
                op.set_func_name("xla_sgemm" if tune.use_culibs else "sgemm")
        _set_or_pop_dims(op, "work",
                         Dims.make(tn="none", Mb=tune.Mb, Nb=tune.Nb, Kb=tune.Kb)
                         if (tune.Mb or tune.Nb or tune.Kb) else None)
        _set_or_pop_str(op, "prec", tune.prec)
    else:
        add_cnn_codegen_annotations(op, tune)
