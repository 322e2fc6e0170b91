"""Compute-graph IR: the conv_pipe_t equivalent.

Capability parity with the reference's conv_util.{H,cc}: a DAG of ConvOp
(operations) and ConvNode (tensors/blobs) with

  * an op-type registry with declared arg names + per-type default params
    (conv_op_info_t table, conv_util.cc:31-75),
  * in-place op handling (ReLU/Dropout/Scale/BatchNorm attach to their
    node's in_place_ops list, conv_util.cc add_conv),
  * named-dims shape inference `calc_dims` (conv_util.cc calc_dims_rec),
  * receptive-field/support/padding analysis `calc_support_info`
    (conv_util.cc:319-400) over graph/support.py semantics,
  * topological visitation with all-bottoms-seen gating,
  * backward-op synthesis `add_bck_ops` (conv_util.cc:732-800),
  * pretty dumps `dump_pipe/dump_ios/dump_ops` (golden-diffed by tests),
  * a weights map `op_params` and single-blob run helpers.

The port's copy of boda_tpu/graph/pipe.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.geom import Pt
from ..ops.op_base import OpBase
from .support import (SupportInfo, conv_in_sz_to_out_sz, conv_out_sz_to_in_sz,
                      pool_in_sz_to_out_sz)


@dataclass
class OpInfo:
    """Static op-type metadata (reference: conv_op_info_t)."""

    type: str
    bots: list[str]
    tops: list[str]
    defaults: dict = field(default_factory=dict)
    has_var_bots: bool = False
    has_var_tops: bool = False


def _conv_defaults():
    return {"out_chans": 0, "in_pad": (0, 0), "stride": (1, 1), "kern_sz": (0, 0)}


def _pool_defaults():
    return {"avg_pool": 0, "in_pad": (0, 0), "stride": (1, 1), "kern_sz": (0, 0)}


def _lrn_defaults():
    return {"local_size": 5, "alpha": 1.0, "beta": 0.75, "k": 1.0,
            "emit_out_scale_base": 0}


OP_INFOS: dict[str, OpInfo] = {o.type: o for o in [
    OpInfo("Convolution", ["in", "filts", "biases"], ["out"], _conv_defaults()),
    OpInfo("Deconvolution", ["in", "filts", "biases"], ["out"], _conv_defaults()),
    OpInfo("Pooling", ["in"], ["out"], _pool_defaults()),
    OpInfo("InnerProduct", ["in", "filts", "biases"], ["out"], {"out_chans": 0}),
    OpInfo("ReLU", ["in"], ["out"]),
    OpInfo("Scale", ["in"], ["out"]),
    OpInfo("BatchNorm", ["in"], ["out"]),
    OpInfo("Dropout", ["in"], ["out"], {"dropout_ratio": 0.5}),
    OpInfo("BckDropout", ["in"], ["out"], {"dropout_ratio": 0.5}),
    OpInfo("LRN", ["in"], ["out"], _lrn_defaults()),
    OpInfo("BckLRN", ["in", "out", "out_grad_loss"], ["in_grad_loss"], _lrn_defaults()),
    OpInfo("Accuracy", ["in"], ["out"]),
    OpInfo("Softmax", ["in"], ["prob"]),
    OpInfo("SoftmaxWithLoss", ["in", "label"], ["in_grad_loss", "loss"]),
    OpInfo("Data", [], ["out"]),
    OpInfo("Concat", ["ins"], ["out"], has_var_bots=True),
    OpInfo("Eltwise", ["ins"], ["out"], has_var_bots=True),
    OpInfo("Reduce", ["ins"], ["out"], has_var_bots=True),
    OpInfo("Split", ["in"], ["outs"], has_var_tops=True),
    OpInfo("Spreading", ["out", "out_grad_loss", "in"], ["in_grad_loss"], _pool_defaults()),
    OpInfo("ZeroIfNonPos", ["in", "cond"], ["out"]),
    OpInfo("BckConv", ["in", "filts", "biases", "out_grad_loss"],
           ["in_grad_loss", "filts_grad_loss", "biases_grad_loss"], _conv_defaults()),
]}

IN_PLACE_TYPES = ("ReLU", "Scale", "BatchNorm", "Dropout", "ZeroIfNonPos", "BckDropout")


class ConvOp(OpBase):
    """One graph operation: OpBase signature + graph wiring (tag/bots/tops)."""

    __slots__ = ("tag", "bots", "tops", "in_place", "params")

    def __init__(self, type: str, tag: str, bots: list[str], tops: list[str],
                 params: Optional[dict] = None):
        super().__init__({"type": type})
        self.tag = tag
        self.bots = list(bots)
        self.tops = list(tops)
        self.in_place = False
        self.params = {}
        info = self.coi()
        merged = dict(info.defaults)
        merged.update(params or {})
        for k, v in merged.items():
            self._set_param(k, v)

    def _set_param(self, k: str, v) -> None:
        self.params[k] = v
        if isinstance(v, tuple) and len(v) == 2:
            self.set_null_dims(k, y=int(v[0]), x=int(v[1]))
        elif isinstance(v, bool):
            self.set_u32(k, int(v))
        elif isinstance(v, int):
            self.set_u32(k, v)
        elif isinstance(v, float):
            self.nda_vals[k] = NDA.scalar(v, "float")
        elif isinstance(v, str):
            self.str_vals[k] = v
        else:
            raise RtErr(f"op '{self.tag}': unsupported param type for '{k}'")

    def coi(self) -> OpInfo:
        info = OP_INFOS.get(self.type)
        if info is None:
            raise RtErr(f"unknown op type '{self.type}'")
        return info

    def is_type(self, t: str) -> bool:
        return self.type == t

    # -- geometry param accessors (y,x) --
    def _pt(self, k: str) -> Pt:
        d = self.get_dims_or_none(k)
        if d is None:
            raise RtErr(f"op '{self.tag}' missing param '{k}'")
        return Pt(d["y"], d["x"])

    def kern_sz(self) -> Pt:
        return self._pt("kern_sz")

    def stride(self) -> Pt:
        return self._pt("stride")

    def in_pad(self) -> Pt:
        return self._pt("in_pad")

    def has_param(self, k: str) -> bool:
        return k in self.nda_vals

    # -- spatial size inference (reference: conv_util.cc:188-225) --
    def in_sz_to_out_sz(self, in_sz: Pt, ignore_padding: bool = False) -> Pt:
        if not self.has_param("kern_sz") or self.kern_sz().is_zeros():
            if self.type in ("Pooling", "InnerProduct"):
                return Pt(1, 1)  # global pooling / inner product
            return in_sz
        pad = Pt(0, 0) if ignore_padding else self.in_pad()
        if self.type in ("Convolution", "BckConv"):
            return conv_in_sz_to_out_sz(in_sz, pad, self.stride(), self.kern_sz())
        if self.type == "Deconvolution":
            return conv_out_sz_to_in_sz(in_sz, pad, self.stride(), self.kern_sz())
        if self.type in ("Pooling", "Spreading"):
            return pool_in_sz_to_out_sz(in_sz, pad, self.stride(), self.kern_sz())
        raise RtErr(f"in_sz_to_out_sz: unknown layer type '{self.type}'")

    def out_sz_to_in_sz(self, out_sz: Pt, ignore_padding: bool = False) -> Pt:
        if not self.has_param("kern_sz") or self.kern_sz().is_zeros():
            if self.type in ("Pooling", "InnerProduct"):
                if out_sz != Pt(1, 1):
                    raise RtErr("global pooling layer can't produce an out_sz other than (1,1)")
                return Pt(0, 0)  # special: all input used
            return out_sz
        pad = Pt(0, 0) if ignore_padding else self.in_pad()
        if self.type in ("Convolution", "Pooling", "Spreading", "BckConv"):
            return conv_out_sz_to_in_sz(out_sz, pad, self.stride(), self.kern_sz())
        if self.type == "Deconvolution":
            return conv_in_sz_to_out_sz(out_sz, pad, self.stride(), self.kern_sz())
        raise RtErr(f"out_sz_to_in_sz: unknown layer type '{self.type}'")

    def __repr__(self):
        return f"ConvOp({self.type},{self.tag},bots={self.bots},tops={self.tops})"


class ConvNode:
    """One graph tensor (reference: conv_node_t): dims + support info +
    producer/consumer op tags + attached in-place ops."""

    __slots__ = ("name", "dims", "csi", "top_for", "bot_for", "in_place_ops",
                 "used_sz", "max_val")

    def __init__(self, name: str):
        self.name = name
        self.dims: Optional[Dims] = None
        self.csi = SupportInfo()
        self.top_for: list[str] = []
        self.bot_for: list[str] = []
        self.in_place_ops: list[ConvOp] = []
        self.used_sz = Pt(0, 0)
        self.max_val = 0

    def xy_sz(self) -> Pt:
        return Pt(self.dims["y"], self.dims["x"])


class ConvPipe:
    """The compute graph (reference: conv_pipe_t, conv_util.H:169-243)."""

    def __init__(self):
        self.ops: dict[str, ConvOp] = {}
        self.nodes: dict[str, ConvNode] = {}
        self.tops: set[str] = set()   # sink node names
        self.bots: set[str] = set()   # source node names
        self.op_params: dict[str, NDA] = {}  # weight blobs by node name
        # caffe ParamSpec per weight blob: param node name ->
        # (lr_mult, decay_mult); absent = (1,1). Only non-default specs
        # are recorded (sparse).
        self.param_mults: dict[str, tuple[float, float]] = {}
        self.data_img_node_names: list[str] = []
        self.data_label_node_names: list[str] = []
        self.out_node_name: str = ""
        self._seen_counts: dict[str, int] = {}
        self.has_bck_ops = False

    # ---- construction ----
    def get_or_make_node(self, name: str, is_bot: bool, is_top: bool) -> ConvNode:
        n = self.nodes.get(name)
        if n is None:
            n = ConvNode(name)
            self.nodes[name] = n
            self.tops.add(name)
            self.bots.add(name)
        if is_bot:
            self.tops.discard(name)
        if is_top:
            self.bots.discard(name)
        return n

    def must_get_node(self, name: str) -> ConvNode:
        n = self.nodes.get(name)
        if n is None:
            raise RtErr(f"no node '{name}' in pipe")
        return n

    def get_op(self, tag: str) -> ConvOp:
        o = self.ops.get(tag)
        if o is None:
            raise RtErr(f"no op '{tag}' in pipe")
        return o

    def add_op(self, op: ConvOp) -> ConvOp:
        if op.tag in self.ops:
            raise RtErr(f"duplicate conv op '{op.tag}' seen; can't process net")
        if op.type in IN_PLACE_TYPES:
            if op.type == "ZeroIfNonPos":
                if op.tops[0] != op.bots[0]:
                    raise RtErr(f"in-place op '{op.tag}' must have tops[0]==bots[0]")
            elif op.tops != op.bots:
                raise RtErr(f"in-place op '{op.tag}' must have tops==bots")
            self.get_or_make_node(op.bots[0], False, False).in_place_ops.append(op)
            op.in_place = True
        self.ops[op.tag] = op
        if op.in_place:
            return op
        for t in op.tops:
            tn = self.get_or_make_node(t, False, True)
            tn.top_for.append(op.tag)
            if len(tn.top_for) != 1:
                raise RtErr(f"unhandled multiple writers for node '{t}'. "
                            f"first two writers: {tn.top_for}")
        for b in op.bots:
            self.get_or_make_node(b, True, False).bot_for.append(op.tag)
        return op

    # ---- topo machinery (reference: topo_visit_setup/on_seen_bot) ----
    def topo_visit_setup(self) -> None:
        self._seen_counts = {t: 0 for t in self.ops}

    def _on_seen_bot(self, op: ConvOp) -> bool:
        self._seen_counts[op.tag] += 1
        return self._seen_counts[op.tag] == len(op.bots)

    def topo_order(self) -> list[ConvOp]:
        """All non-in-place ops in topological order."""
        self.topo_visit_setup()
        order: list[ConvOp] = []

        def rec(node_name: str):
            node = self.must_get_node(node_name)
            for tag in node.bot_for:
                op = self.get_op(tag)
                if op.in_place:
                    continue
                if not self._on_seen_bot(op):
                    continue
                order.append(op)
                for t in op.tops:
                    rec(t)

        for b in sorted(self.bots):
            rec(b)
        return order

    # ---- shape inference (reference: calc_dims, conv_util.cc:440-530) ----
    def calc_dims(self) -> None:
        self.topo_visit_setup()

        def rec(node_name: str):
            node = self.must_get_node(node_name)
            for tag in node.bot_for:
                op = self.get_op(tag)
                if op.in_place:
                    continue
                if not self._on_seen_bot(op):
                    continue
                self._calc_dims_op(op)
                for t in op.tops:
                    rec(t)

        for b in sorted(self.bots):
            rec(b)
        missing = [n for n, nd in self.nodes.items() if nd.dims is None]
        if missing:
            raise RtErr(f"error: no dims calculated for nodes "
                        f"'{sorted(missing)}' after calc_dims()")
        for op in self.ops.values():
            self._set_op_arg_dims(op)

    def _calc_dims_op(self, op: ConvOp) -> None:
        out_node = self.must_get_node(op.tops[0])
        if op.type == "Data":
            if out_node.dims is None:
                raise RtErr(f"data node '{out_node.name}' has no dims set")
            return
        if op.type in ("BckConv", "Spreading", "BckLRN", "ZeroIfNonPos",
                       "Reduce", "Split", "BckDropout"):
            self._calc_dims_bck_op(op)
            return
        if op.type == "SoftmaxWithLoss":
            in_dims = self.must_get_node(op.bots[0]).dims
            out_node.dims = in_dims
            loss_node = self.must_get_node(op.tops[1])
            loss_node.dims = Dims.make(tn=in_dims.tn, y=1, x=1)
            implied_label = Dims.make(img=in_dims["img"], y=in_dims["y"], x=in_dims["x"])
            label_node = self.must_get_node(op.bots[1])
            if label_node.dims is None:
                label_node.dims = implied_label
            elif label_node.dims != implied_label:
                raise RtErr("error: label used by multiple SoftmaxWithLoss layers "
                            "with differing xy size or # imgs")
            label_node.max_val = in_dims["chan"]
            return
        if op.type in ("Concat", "Eltwise"):
            chans = 0
            tmpl = None
            for i, b in enumerate(op.bots):
                jd = self.must_get_node(b).dims
                chans += jd["chan"]
                if tmpl is None:
                    tmpl = jd.with_dim("chan", 0)
                elif not jd.matches_template(tmpl):
                    raise RtErr(f"concat layer had incompatible inputs; must have all "
                                f"same non-chan dims. template (from first input) was: "
                                f"{tmpl}. mismatching input was (index={i}): {jd}")
            if op.type == "Eltwise":
                # elementwise: chan counts must MATCH (the template above
                # wildcards chan, which is right for Concat only)
                c0 = self.must_get_node(op.bots[0]).dims["chan"]
                for i, b in enumerate(op.bots[1:], start=1):
                    ci = self.must_get_node(b).dims["chan"]
                    if ci != c0:
                        raise RtErr(f"eltwise layer '{op.tag}' input "
                                    f"{i} has chan={ci} != chan={c0} of "
                                    f"input 0")
                out_node.dims = self.must_get_node(op.bots[0]).dims
            else:
                out_node.dims = tmpl.with_dim("chan", chans)
            return
        # single-input chain ops (+conv/ip which also set filts/biases dims)
        in_node = self.must_get_node(op.bots[0])
        in_dims = in_node.dims
        out_chans = 0
        if op.type in ("Convolution", "Deconvolution"):
            ks = op.kern_sz()
            if ks.is_zeros():
                ks = Pt(in_dims["y"], in_dims["x"])
                op._set_param("kern_sz", (ks.y, ks.x))
            out_chans = op.get_u32("out_chans")
            # a grouped conv (`groups` g, set only where g > 1): input and
            # output channels split into g blocks in order, output block j
            # reading input block j alone, so its filter is (out_chan,
            # in_chan / g, y, x)
            g = op.get_u32_or("groups", 1)
            if g < 1 or in_dims["chan"] % g or out_chans % g:
                raise RtErr(f"conv '{op.tag}': {g} groups do not divide its "
                            f"{in_dims['chan']} input and {out_chans} output "
                            f"channels")
            self.must_get_node(op.bots[1]).dims = Dims.make(
                tn=in_dims.tn, out_chan=out_chans,
                in_chan=in_dims["chan"] // g, y=ks.y, x=ks.x)
            self.must_get_node(op.bots[2]).dims = Dims.make(
                tn=in_dims.tn, out_chan=out_chans)
        elif op.type == "InnerProduct":
            out_chans = op.get_u32("out_chans")
            if len(op.bots) > 1:
                self.must_get_node(op.bots[1]).dims = Dims.make(
                    tn=in_dims.tn, out_chan=out_chans, in_chan=in_dims["chan"],
                    y=in_dims["y"], x=in_dims["x"])
                self.must_get_node(op.bots[2]).dims = Dims.make(
                    tn=in_dims.tn, out_chan=out_chans)
        elif len(op.bots) != 1:
            raise RtErr(f"calc_dims(): unhandled multi-input operation: "
                        f"{op.tag} of type {op.type}")
        out_sz = op.in_sz_to_out_sz(Pt(in_dims["y"], in_dims["x"]), False)
        if out_sz.both_nonzero():
            in_node.used_sz = in_node.used_sz.max_eq(op.out_sz_to_in_sz(out_sz, False))
        out_node.dims = Dims.make(
            tn=in_dims.tn, img=in_dims["img"],
            chan=out_chans if out_chans else in_dims["chan"],
            y=out_sz.y, x=out_sz.x)

    def _calc_dims_bck_op(self, op: ConvOp) -> None:
        """Backward/synthesized ops: outputs mirror declared input dims."""
        if op.type == "Split":
            # grad tops mirror their forward node's dims (Concat-bck tops
            # partition the input chans; Eltwise-bck tops are full copies)
            in_dims = self.must_get_node(op.bots[0]).dims
            for t in op.tops:
                fwd_name = t.split("_grad_loss")[0]
                fwd = self.nodes.get(fwd_name)
                self.must_get_node(t).dims = \
                    fwd.dims if fwd is not None and fwd.dims is not None else in_dims
        elif op.type == "Reduce":
            self.must_get_node(op.tops[0]).dims = self.must_get_node(op.bots[0]).dims
        elif op.type == "BckConv":
            for bot, top in (("in", "in_grad_loss"), ("filts", "filts_grad_loss"),
                             ("biases", "biases_grad_loss")):
                i = op.coi().bots.index(bot)
                j = op.coi().tops.index(top)
                self.must_get_node(op.tops[j]).dims = self.must_get_node(op.bots[i]).dims
        elif op.type in ("Spreading",):
            self.must_get_node(op.tops[0]).dims = self.must_get_node(op.bots[2]).dims
        elif op.type in ("BckLRN",):
            self.must_get_node(op.tops[0]).dims = self.must_get_node(op.bots[0]).dims
        else:  # ZeroIfNonPos / BckDropout: in-place
            self.must_get_node(op.tops[0]).dims = self.must_get_node(op.bots[0]).dims

    def _set_op_arg_dims(self, op: ConvOp) -> None:
        """Record per-arg dims into the op signature (reference:
        set_arg_dims_and_map_from_pipe) so codegen sees full op sigs."""
        coi = op.coi()
        for i, b in enumerate(op.bots):
            an = f"{coi.bots[0]}_{i}" if coi.has_var_bots else (
                coi.bots[i] if i < len(coi.bots) else f"bot_{i}")
            nd = self.nodes.get(b)
            if nd is not None and nd.dims is not None:
                op.set_dims(an, nd.dims)
        for i, t in enumerate(op.tops):
            an = f"{coi.tops[0]}_{i}" if coi.has_var_tops else (
                coi.tops[i] if i < len(coi.tops) else f"top_{i}")
            nd = self.nodes.get(t)
            if nd is not None and nd.dims is not None:
                op.set_dims(an, nd.dims)

    # ---- support info (reference: calc_support_info, conv_util.cc:319-400) ----
    def calc_support_info(self, ignore_padding: bool = True) -> None:
        for name in self.data_img_node_names or sorted(self.bots):
            n = self.must_get_node(name)
            if not n.csi.valid():
                n.csi.init_as_source()
        self.topo_visit_setup()

        def rec(node_name: str):
            node = self.must_get_node(node_name)
            for tag in node.bot_for:
                op = self.get_op(tag)
                if op.in_place:
                    continue
                if not self._on_seen_bot(op):
                    continue
                self._calc_support_op(op, ignore_padding)
                for t in op.tops:
                    rec(t)

        for b in sorted(self.bots):
            rec(b)

    def _calc_support_op(self, op: ConvOp, ignore_padding: bool) -> None:
        out = self.must_get_node(op.tops[0])
        csi_out = out.csi
        if csi_out.valid():
            raise RtErr(f"unhandled: node with multiple writers: {out.name}")
        if op.type in ("BckConv", "Spreading", "Split", "Reduce", "BckLRN"):
            return  # no support info for bck ops (reference behavior)
        if op.type == "InnerProduct":
            # fc consumes the whole input: global support (support_sz zeros)
            csi_in = self.must_get_node(op.bots[0]).csi
            csi_out.support_sz = Pt(0, 0)
            csi_out.support_stride = csi_in.support_stride
            csi_out.eff_tot_pad = csi_in.eff_tot_pad
            return
        if op.type == "SoftmaxWithLoss":
            csi_out.eff_tot_pad = self.must_get_node(op.bots[0]).csi.eff_tot_pad
            loss = self.must_get_node(op.tops[1])
            loss.csi.eff_tot_pad = csi_out.eff_tot_pad
            return
        if op.type in ("Concat", "Eltwise"):
            for i, b in enumerate(op.bots):
                csi_in = self.must_get_node(b).csi
                if not csi_in.valid():
                    raise RtErr("calc_support_info(): needed input support info for "
                                f"node not set. node name: {b}")
                if i == 0 or csi_in.support_stride.dims_max() > csi_out.support_stride.dims_max():
                    csi_out.support_stride = csi_in.support_stride
                    csi_out.support_sz = csi_in.support_sz
                elif csi_in.support_stride == csi_out.support_stride:
                    csi_out.support_sz = csi_out.support_sz.max_eq(csi_in.support_sz)
                csi_out.eff_tot_pad = csi_out.eff_tot_pad.max_eq(csi_in.eff_tot_pad)
            return
        csi_in = self.must_get_node(op.bots[0]).csi
        if not csi_in.valid():
            raise RtErr("calc_support_info(): needed input support info for node "
                        f"not set. node name: {op.bots[0]}")
        in_sz_1x1 = op.out_sz_to_in_sz(Pt(1, 1), ignore_padding)
        if in_sz_1x1.is_zeros() or csi_in.support_sz.is_zeros():
            csi_out.support_sz = Pt(0, 0)  # global support
        else:
            csi_out.support_sz = csi_in.support_sz + (in_sz_1x1 - Pt(1, 1)) * csi_in.support_stride
        # NOTE reference parity (conv_util.cc:373-378): this composition
        # does not model Deconvolution (upsampling would need a RATIONAL
        # composed stride; out_sz_to_in_sz(1,1) collapses to 0 for k>1+2p
        # so deconv support reads 'global'). The reference computed the
        # same; dense/sliding-window geometry is conv-net-only.
        if op.has_param("stride"):
            csi_out.support_stride = csi_in.support_stride * op.stride()
        else:
            csi_out.support_stride = csi_in.support_stride
        if op.has_param("in_pad"):
            # note: eff_tot_pad accumulates real padding regardless of
            # ignore_padding (which only affects support_sz), per reference
            csi_out.eff_tot_pad = csi_in.eff_tot_pad + op.in_pad() * csi_in.support_stride
        else:
            csi_out.eff_tot_pad = csi_in.eff_tot_pad

    # ---- backward-op synthesis (reference: add_bck_ops, conv_util.cc:732-800) ----
    def _grad_onn(self, cop: ConvOp, inn: str) -> str:
        """Node name for cop's contribution to d(loss)/d(inn): the plain
        `_grad_loss` node when inn has one consumer (or cop is in-place),
        else a per-op partial later summed by a Reduce op."""
        node = self.must_get_node(inn)
        if len(node.bot_for) == 1 or cop.in_place:
            return inn + "_grad_loss"
        return inn + "_grad_loss_" + cop.tag

    def _make_bck_op(self, cop: ConvOp) -> Optional[ConvOp]:
        """Synthesize the gradient op for one forward op (reference:
        add_bck_ops_op). Returns None for ops that already produce their
        own gradients (SoftmaxWithLoss)."""
        t = cop.type
        params = dict(cop.params)
        if t == "SoftmaxWithLoss":
            if cop.bots[0] + "_grad_loss" != cop.tops[0]:
                raise RtErr("add_bck_ops: SoftmaxWithLoss must write "
                            f"'{cop.bots[0]}_grad_loss' as tops[0], got '{cop.tops[0]}'")
            return None
        if t == "Pooling":
            return ConvOp("Spreading", cop.tag + "_bck",
                          [cop.tops[0], cop.tops[0] + "_grad_loss", cop.bots[0]],
                          [self._grad_onn(cop, cop.bots[0])], params)
        if t == "ReLU":  # in-place: grads flow in-place through the grad node
            gl = cop.bots[0] + "_grad_loss"
            return ConvOp("ZeroIfNonPos", cop.tag + "_bck",
                          [gl, cop.bots[0]], [gl], {})
        if t == "Dropout":
            gl = cop.bots[0] + "_grad_loss"
            return ConvOp("BckDropout", cop.tag + "_bck", [gl], [gl], params)
        if t == "Convolution":
            if cop.get_u32_or("groups", 1) > 1:
                raise RtErr(f"add_bck_ops: grouped conv '{cop.tag}' has no "
                            f"backward op (BckConv is ungrouped; the "
                            f"autodiff training path, cnet_train/mxu_grad, "
                            f"differentiates it)")
            return ConvOp("BckConv", cop.tag + "_bck",
                          list(cop.bots) + [cop.tops[0] + "_grad_loss"],
                          [self._grad_onn(cop, b) for b in cop.bots[:3]], params)
        if t == "Concat":
            return ConvOp("Split", cop.tag + "_bck",
                          [cop.tops[0] + "_grad_loss"],
                          [self._grad_onn(cop, b) for b in cop.bots], {})
        if t == "Eltwise":
            if cop.str_vals.get("ew_op", "SUM") != "SUM":
                raise RtErr("add_bck_ops: only SUM Eltwise has bck support")
            # d/d(each input) of a sum is the out grad: a full-copy Split
            return ConvOp("Split", cop.tag + "_bck",
                          [cop.tops[0] + "_grad_loss"],
                          [self._grad_onn(cop, b) for b in cop.bots],
                          {})
        if t == "LRN":
            return ConvOp("BckLRN", cop.tag + "_bck",
                          [cop.bots[0], cop.tops[0], cop.tops[0] + "_grad_loss"],
                          [self._grad_onn(cop, cop.bots[0])], params)
        if t in ("InnerProduct", "Deconvolution"):
            # the reference's bck set is conv-only too (conv_util.cc:732-
            # 800); its grad-test nets are fc_to_conv-converted models
            raise RtErr(f"add_bck_ops: '{t}' (op '{cop.tag}') has no "
                        f"backward op — convert with cnet_fc_to_conv "
                        f"first (the autodiff training path, cnet_train/"
                        f"mxu_grad, differentiates these natively)")
        raise RtErr(f"add_bck_ops: unhandled op type '{t}' (op '{cop.tag}')")

    def add_bck_ops(self) -> None:
        """Append gradient ops for every forward op, producing
        `<node>_grad_loss` nodes back to the data input. All sinks must be
        produced by SoftmaxWithLoss ops (the loss caps the net)."""
        bck_ops: list[ConvOp] = []
        self.topo_visit_setup()

        def rec(node_name: str):
            node = self.must_get_node(node_name)
            if not node.bot_for:  # sink: must be capped by a loss op
                if len(node.top_for) != 1 or \
                        not self.get_op(node.top_for[0]).is_type("SoftmaxWithLoss"):
                    raise RtErr(f"add_bck_ops: top node '{node_name}' not produced "
                                "by a SoftmaxWithLoss op")
            for ip in reversed(node.in_place_ops):
                b = self._make_bck_op(ip)
                if b is not None:
                    bck_ops.append(b)
            if len(node.bot_for) > 1:
                # partial grads from multiple consumers get summed by Reduce
                consumers = [self.get_op(tag) for tag in node.bot_for]
                parts = [self._grad_onn(c, node_name) for c in consumers]
                if len(set(parts)) != len(parts):
                    raise RtErr(f"add_bck_ops: grad contributions for multi-use "
                                f"node '{node_name}' collide: {parts}")
                bck_ops.append(ConvOp("Reduce", f"reduce_{node_name}_grad_loss",
                                      parts, [node_name + "_grad_loss"], {}))
            for tag in node.bot_for:
                cop = self.get_op(tag)
                if cop.in_place or not self._on_seen_bot(cop):
                    continue
                b = self._make_bck_op(cop)
                if b is not None:
                    bck_ops.append(b)
                for tp in cop.tops:
                    rec(tp)

        for b in sorted(self.bots):
            rec(b)
        # add in reverse walk order; drop Reduce ops whose inputs never
        # materialized (consumer produced no grads) — reference behavior.
        # A PARTIAL set of materialized contributions means some consumer
        # wrote its gradient under a different name (e.g. SoftmaxWithLoss
        # writes the plain `_grad_loss` at import time): summing a subset
        # would silently train on an incomplete gradient — refuse instead.
        for bcop in reversed(bck_ops):
            if bcop.is_type("Reduce"):
                have = [b for b in bcop.bots if b in self.nodes]
                if not have:
                    continue
                if len(have) != len(bcop.bots):
                    raise RtErr(
                        f"add_bck_ops: node '{bcop.tops[0]}' received only "
                        f"{len(have)}/{len(bcop.bots)} gradient "
                        f"contributions ({sorted(set(bcop.bots) - set(have))} "
                        f"missing) — mixed-name partials are unsupported")
            self.add_op(bcop)
        self.has_bck_ops = True
        self.calc_dims()  # infer dims for the new grad nodes

    # ---- queries ----
    def get_single_top_node(self) -> ConvNode:
        if not self.out_node_name:
            if len(self.tops) != 1:
                raise RtErr("not exactly one sink/output node in net; can't process. "
                            f"output nodes are: {sorted(self.tops)}")
            return self.must_get_node(next(iter(self.tops)))
        if self.out_node_name not in self.nodes:
            raise RtErr(f"node '{self.out_node_name}' specified for use as producing "
                        "the primary net output not found in net.")
        return self.must_get_node(self.out_node_name)

    def get_data_img_dims(self) -> Dims:
        if len(self.data_img_node_names) != 1:
            raise RtErr("not exactly one data img input node in net; can't process. "
                        f"data img input nodes are: {self.data_img_node_names}")
        return self.must_get_node(self.data_img_node_names[0]).dims

    def pruned_to(self, node_name: str) -> "ConvPipe":
        """Sub-pipe containing only the ops needed to compute node_name
        (the out_node_name truncation capability; reference nets are
        truncated at parse time via out_layer_name, caffeif.H)."""
        self.must_get_node(node_name)
        keep_ops: set[str] = set()
        stack = [node_name]
        seen_nodes: set[str] = set()
        while stack:
            n = stack.pop()
            if n in seen_nodes:
                continue
            seen_nodes.add(n)
            node = self.must_get_node(n)
            for tag in node.top_for:
                if tag not in keep_ops:
                    keep_ops.add(tag)
                    stack.extend(self.get_op(tag).bots)
        sub = ConvPipe()
        sub.data_img_node_names = [n for n in self.data_img_node_names
                                   if n in seen_nodes]
        for op in self.ops.values():
            if op.tag in keep_ops:
                sub.add_op(ConvOp(op.type, op.tag, op.bots, op.tops,
                                  dict(op.params)))
                sub.ops[op.tag].str_vals.update(
                    {k: v for k, v in op.str_vals.items() if k != "type"})
        # in-place ops on kept nodes (except ones past the target's producer)
        for n in seen_nodes:
            node = self.nodes[n]
            for ip in node.in_place_ops:
                if ip.tag not in sub.ops and all(b in seen_nodes for b in ip.bots):
                    sub.add_op(ConvOp(ip.type, ip.tag, ip.bots, ip.tops,
                                      dict(ip.params)))
        for n in seen_nodes:
            if self.nodes[n].dims is not None and n in sub.nodes \
                    and not sub.nodes[n].top_for:
                sub.nodes[n].dims = self.nodes[n].dims
        sub.op_params = self.op_params
        sub.param_mults = self.param_mults
        sub.calc_dims()
        sub.calc_support_info()
        return sub

    def set_all_one_weights(self) -> None:
        """Debug determinism hook (reference: set_all_one_weights,
        conv_util.H:225): every weight/bias blob becomes all-ones, making
        per-layer outputs hand-checkable (a conv output equals
        in_chan*ky*kx*mean-ish sums)."""
        import numpy as np
        from ..core.dims import NDA
        for n, nda in list(self.op_params.items()):
            self.op_params[n] = NDA(nda.dims,
                                    np.ones(nda.dims.shape, nda.v.dtype))

    # ---- dumps (golden-diffed; reference: dump_pipe/dump_ios/dump_ops) ----
    def dump_pipe(self, out: Callable[[str], None] = print) -> None:
        out("== BEGIN dump_pipe ==")
        for op in self.topo_order():
            csi = self.must_get_node(op.tops[0]).csi
            out(f"{op.tag}: type={op.type} bots={','.join(op.bots)} "
                f"tops={','.join(op.tops)} support_sz={csi.support_sz} "
                f"support_stride={csi.support_stride} eff_tot_pad={csi.eff_tot_pad}")
            for ip in self.must_get_node(op.tops[0]).in_place_ops:
                out(f"  in_place: {ip.tag}: type={ip.type}")
        out("== END dump_pipe ==")

    def dump_ios(self, out: Callable[[str], None] = print) -> None:
        out("== BEGIN dump_ios ==")
        for name in sorted(self.nodes):
            nd = self.nodes[name]
            if nd.dims is None:
                continue
            used = f" used_sz={nd.used_sz}" if not nd.used_sz.is_zeros() else ""
            out(f"{name}: {nd.dims.pretty()}{used}")
        out("== END dump_ios ==")

    def dump_ops(self, out: Callable[[str], None] = print) -> None:
        out("== BEGIN dump_ops ==")
        for op in self.topo_order():
            out(str(op.to_compact_lexp()))
            for ip in self.must_get_node(op.tops[0]).in_place_ops:
                out(str(ip.to_compact_lexp()))
        out("== END dump_ops ==")

    # ---- flops / sizes analysis (reference: cnet_ana / conv_ana support) ----
    def total_flops_and_bytes(self) -> tuple[int, int]:
        flops = 0
        bytes_ = 0
        for op in self.topo_order():
            if op.type in ("Convolution", "InnerProduct"):
                od = self.must_get_node(op.tops[0]).dims
                fd = self.must_get_node(op.bots[1]).dims
                flops += 2 * od.sz() * fd["in_chan"] * fd.get("y", 1) * fd.get("x", 1)
            elif op.type == "Deconvolution":
                # scatter form: every INPUT position contributes k² taps
                # per out_chan (od.sz()-based counting would overcount by
                # stride²)
                ind = self.must_get_node(op.bots[0]).dims
                fd = self.must_get_node(op.bots[1]).dims
                flops += 2 * ind.sz() * fd["out_chan"] * fd.get("y", 1) * fd.get("x", 1)
            for b in op.bots:
                nd = self.nodes[b]
                if nd.dims is not None:
                    bytes_ += nd.dims.bytes_sz()
            for t in op.tops:
                nd = self.nodes[t]
                if nd.dims is not None:
                    bytes_ += nd.dims.bytes_sz()
        return flops, bytes_
