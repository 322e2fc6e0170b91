"""Caffe model front-end: prototxt/caffemodel ⇄ ConvPipe.

Capability parity with the reference's caffepb.{H,cc} (self-contained caffe
support, no caffe dependency):

  * prototxt import (V1 'layers' enum types and V2 'layer' string types,
    TRAIN/TEST phase filtering) → ConvPipe (create_pipe_from_param,
    caffepb.cc:166-328),
  * binary .caffemodel weight load via the schema-less wire decoder
    (must_read_binary_proto caffepb.cc:474) + name-matched blob copy
    (copy_matching_layer_blobs_from_param_to_pipe :593),
  * export back to prototxt + caffemodel (as_net_param; net-surgery writes
    caffepb.cc:773-779): cnet_train's trained-weights outputs,
  * net surgery: InnerProduct→Convolution (cnet_fc_to_conv :888), conv
    kernel resampling (resize_kernel :677),
  * BatchNorm+Scale deploy-time folding into the preceding Convolution
    (the reference predates BN-heavy nets; resnet prototxts import to
    conv-only graphs this way).

Field numbers in _F are wire-format facts of the public caffe schema.

The port's copy of boda_tpu/graph/caffe_io.py up to its writers
(pipe_to_net_param, write_prototxt, write_caffemodel: the same bytes) and
the two net-surgery helpers its net modes use (graph/modes.py).
create_upsamp_layer_weights serves the JAX package's upsampled nets, which
the port leaves out.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from ..core.dims import NDA, Dims
from ..core.error import RtErr
from .pbtext import PbNode, parse_pbtext, print_pbtext
from .pbwire import (WireNode, decode_wire, enc_field_bytes, enc_field_packed_floats,
                     enc_field_packed_varints, enc_field_string)
from .pipe import ConvOp, ConvPipe

# V1 enum name → V2 string type
_V1_TYPES = {
    "DATA": "Data", "CONVOLUTION": "Convolution", "DECONVOLUTION": "Deconvolution",
    "RELU": "ReLU", "POOLING": "Pooling", "LRN": "LRN",
    "INNER_PRODUCT": "InnerProduct", "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss", "DROPOUT": "Dropout", "CONCAT": "Concat",
    "ELTWISE": "Eltwise", "ACCURACY": "Accuracy", "SPLIT": "Split",
    "IMAGE_DATA": "Data", "WINDOW_DATA": "Data", "HDF5_DATA": "Data",
    "MEMORY_DATA": "Data",
}

_SKIP_TYPES = {"Data", "Accuracy", "Silence", "HDF5Output"}

# protobuf field numbers (public caffe schema facts)
class _F:
    # NetParameter
    net_name = 1
    net_layers_v1 = 2
    net_input = 3
    net_input_dim = 4
    net_input_shape = 8
    net_layer = 100
    # LayerParameter (V2)
    l_name = 1
    l_type = 2
    l_bottom = 3
    l_top = 4
    l_blobs = 7
    # V1LayerParameter
    v1_bottom = 2
    v1_top = 3
    v1_name = 4
    v1_type = 5
    v1_blobs = 6
    # BlobProto
    b_num = 1
    b_chan = 2
    b_h = 3
    b_w = 4
    b_data = 5
    b_shape = 7
    # BlobShape
    bs_dim = 1


def _xy(v, default: int) -> tuple[int, int]:
    """caffe geometry params: repeated k or k_h/k_w pairs; (y, x) order."""
    if v is None:
        return (default, default)
    if isinstance(v, (list, tuple)):
        if len(v) == 0:
            return (default, default)
        if len(v) == 1:
            return (int(v[0]), int(v[0]))
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _geom(p: PbNode, base: str, default: int) -> tuple[int, int]:
    h = p.get(base + "_h")
    w = p.get(base + "_w")
    if h is not None or w is not None:
        return (int(h if h is not None else default),
                int(w if w is not None else default))
    key = base if p.has(base) else base + "_size"
    return _xy(p.get_all(key) if p.has(key) else None, default)


def _phase_ok(l: PbNode, phase: str) -> bool:
    for inc in l.get_all("include"):
        phases = [str(p) for p in inc.get_all("phase")]
        if phases and phase not in phases:
            return False
    for exc in l.get_all("exclude"):
        phases = [str(p) for p in exc.get_all("phase")]
        if phase in phases:
            return False
    return True


def create_pipe_from_param(net: PbNode, in_dims: Optional[Dims] = None,
                           phase: str = "TEST",
                           out_node_name: str = "",
                           add_bck_ops: bool = False) -> ConvPipe:
    """NetParameter (parsed prototxt) → ConvPipe (ref: caffepb.cc:166-328)."""
    pipe = ConvPipe()
    pipe.out_node_name = out_node_name
    alias: dict[str, str] = {}  # in-place top alias → real node

    def resolve(n: str) -> str:
        while n in alias:
            n = alias[n]
        return n

    # declared inputs
    inputs = [str(x) for x in net.get_all("input")]
    input_dims: list[list[int]] = []
    if net.has("input_shape"):
        for sh in net.get_all("input_shape"):
            input_dims.append([int(d) for d in sh.get_all("dim")])
    elif net.has("input_dim"):
        dims_flat = [int(d) for d in net.get_all("input_dim")]
        input_dims = [dims_flat[i:i + 4] for i in range(0, len(dims_flat), 4)]

    layers = net.get_all("layer") or net.get_all("layers")
    is_v1 = not net.get_all("layer")
    # raw-name consumer counts: aliasing a non-in-place activation
    # (top != bottom) onto its bottom is only sound when nothing else
    # reads the pre-activation blob
    bot_consumers: dict = {}
    for l in layers:
        if _phase_ok(l, phase):
            for bname in l.get_all("bottom"):
                bname = str(bname)
                bot_consumers[bname] = bot_consumers.get(bname, 0) + 1
    seen_data = False
    for l in layers:
        if not _phase_ok(l, phase):
            continue
        ltype = str(l.get("type", ""))
        if is_v1:
            ltype = _V1_TYPES.get(ltype, ltype)
        name = str(l.get("name", ltype))
        bots = [resolve(str(b)) for b in l.get_all("bottom")]
        tops = [str(t) for t in l.get_all("top")]
        if ltype == "SoftmaxWithLoss":
            if not add_bck_ops:
                # inference import drops loss caps (reference:
                # caffepb.cc:256-262 warns and ignores SoftmaxWithLoss when
                # add_bck_ops==0)
                continue
            # gradient import: prepend the fwd-top gradient output
            # (reference: caffepb.cc:264); legacy layers may declare no top
            loss_tops = tops if tops else [name]
            op = ConvOp("SoftmaxWithLoss", name, bots,
                        [bots[0] + "_grad_loss"] + loss_tops, {})
            op.str_vals["caffe_name"] = name
            pipe.add_op(op)
            if bots[1:]:
                pipe.data_label_node_names = [bots[1]]
            continue
        if ltype in _SKIP_TYPES:
            if ltype == "Data" and not seen_data and tops:
                seen_data = True
                node = pipe.get_or_make_node(tops[0], False, False)
                tp = l.get("transform_param")
                crop = int(tp.get("crop_size", 0)) if tp else 0
                dp = l.get("data_param")
                bsz = int(dp.get("batch_size", 1)) if dp else 1
                if crop:
                    node.dims = Dims.make(img=bsz, chan=3, y=crop, x=crop)
                pipe.data_img_node_names = [tops[0]]
                if len(tops) > 1:
                    pipe.data_label_node_names = [tops[1]]
            continue
        params: dict = {}
        op_type = ltype
        param_specs: list[tuple[float, float]] = []
        if ltype in ("Convolution", "Deconvolution", "InnerProduct"):
            # caffe ParamSpec (per weight blob, order [filts, biases]):
            # V2 `param { lr_mult decay_mult }` blocks; V1 layers carry
            # repeated `blobs_lr` / `weight_decay` floats instead
            specs = l.get_all("param")
            if specs and not is_v1:
                for sp in specs:
                    if not isinstance(sp, PbNode):
                        break  # V1 'param' is a share-name string
                    param_specs.append((float(sp.get("lr_mult", 1.0)),
                                        float(sp.get("decay_mult", 1.0))))
            else:
                lrs = [float(x) for x in l.get_all("blobs_lr")]
                wds = [float(x) for x in l.get_all("weight_decay")]
                for i in range(max(len(lrs), len(wds))):
                    param_specs.append((lrs[i] if i < len(lrs) else 1.0,
                                        wds[i] if i < len(wds) else 1.0))
        if ltype in ("Convolution", "Deconvolution"):
            cp = l.get("convolution_param") or PbNode()
            # unsupported conv features must fail at parse time: ignoring
            # dilation would compute a different net. A Convolution's
            # group g splits its channels into g blocks (its filter blob
            # is (out, in / g, k, k); graph/pipe.py checks that g
            # divides both); a Deconvolution's stays refused
            grp = int(cp.get("group", 1) or 1)
            if grp != 1 and ltype == "Deconvolution":
                raise RtErr(f"caffe import: deconvolution group={grp} is "
                            f"unsupported (layer '{name}')")
            if grp < 1:
                raise RtErr(f"caffe import: convolution group={grp} "
                            f"(layer '{name}')")
            if grp > 1:
                params["groups"] = grp
            dil = _geom(cp, "dilation", 1)
            if tuple(dil) != (1, 1):
                raise RtErr(f"caffe import: dilation={tuple(dil)} is "
                            f"unsupported (layer '{name}')")
            params["out_chans"] = int(cp.get("num_output", 0))
            params["kern_sz"] = _geom(cp, "kernel", 0)
            params["stride"] = _geom(cp, "stride", 1)
            params["in_pad"] = _geom(cp, "pad", 0)
            # always 3-arg form; bias_term=false layers get a zero bias blob
            bots = [bots[0], f"{name}_filts", f"{name}_biases"]
        elif ltype == "InnerProduct":
            ip = l.get("inner_product_param") or PbNode()
            params["out_chans"] = int(ip.get("num_output", 0))
            bots = [bots[0], f"{name}_filts", f"{name}_biases"]
        elif ltype == "Pooling":
            pp = l.get("pooling_param") or PbNode()
            pool = str(pp.get("pool", "MAX"))
            if pool in ("STOCHASTIC", "2"):
                raise RtErr(f"caffe import: STOCHASTIC pooling is "
                            f"unsupported (layer '{name}')")
            params["avg_pool"] = 1 if pool in ("AVE", "1") else 0
            if pp.get("global_pooling", False):
                params["kern_sz"] = (0, 0)
            else:
                params["kern_sz"] = _geom(pp, "kernel", 0)
            params["stride"] = _geom(pp, "stride", 1)
            params["in_pad"] = _geom(pp, "pad", 0)
        elif ltype == "LRN":
            lp = l.get("lrn_param") or PbNode()
            params["local_size"] = int(lp.get("local_size", 5))
            params["alpha"] = float(lp.get("alpha", 1.0))
            params["beta"] = float(lp.get("beta", 0.75))
            params["k"] = float(lp.get("k", 1.0))
        elif ltype == "Dropout":
            dp2 = l.get("dropout_param") or PbNode()
            params["dropout_ratio"] = float(dp2.get("dropout_ratio", 0.5))
        elif ltype == "Eltwise":
            ep = l.get("eltwise_param") or PbNode()
            opv = ep.get("operation", "SUM")
            params["ew_op"] = {0: "PROD", 1: "SUM", 2: "MAX"}.get(opv, str(opv))
        elif ltype == "Concat":
            pass
        elif ltype in ("Softmax", "SoftmaxWithLoss", "Split", "ReLU",
                       "Scale", "BatchNorm"):
            pass
        else:
            raise RtErr(f"caffe import: unhandled layer type '{ltype}' (layer '{name}')")
        # in-place normalization: caffe in-place layers have top==bottom;
        # non-in-place ReLU/Scale/etc. get aliased to their bottom node
        from .pipe import IN_PLACE_TYPES
        if op_type in IN_PLACE_TYPES:
            if tops and bots and tops[0] != bots[0]:
                raw_bot = str(l.get_all("bottom")[0])
                if bot_consumers.get(raw_bot, 0) > 1:
                    # another layer reads the PRE-activation blob; aliasing
                    # would silently hand it post-activation values
                    raise RtErr(
                        f"caffe import: non-in-place {op_type} '{name}' "
                        f"(top '{tops[0]}' != bottom '{raw_bot}') whose "
                        f"bottom has other consumers — unsupported; make "
                        f"the layer in-place or copy the blob first")
                alias[tops[0]] = bots[0]
            tops = [bots[0]]
            bots = [bots[0]]
        else:
            tops = [resolve(t) for t in tops]
        if op_type in ("Scale", "BatchNorm"):
            # recorded for deploy-time folding; params blobs keyed by name
            op = ConvOp(op_type, name, bots, tops, {})
            op.str_vals["caffe_name"] = name
            pipe.add_op(op)
            continue
        op = ConvOp(op_type, name, bots, tops, params)
        op.str_vals["caffe_name"] = name
        pipe.add_op(op)
        for i, (lm, dm) in enumerate(param_specs[:2]):
            if (lm, dm) != (1.0, 1.0):
                pipe.param_mults[bots[1 + i]] = (lm, dm)

    # declared-input data nodes
    for i, inp in enumerate(inputs):
        node = pipe.get_or_make_node(inp, False, False)
        if i < len(input_dims) and len(input_dims[i]) == 4:
            n, c, h, w = input_dims[i]
            node.dims = Dims.make(img=n, chan=c, y=h, x=w)
        if i == 0:
            pipe.data_img_node_names = [inp]
    if in_dims is not None:
        if not pipe.data_img_node_names:
            raise RtErr("caffe import: no data input node found to apply in_dims to")
        pipe.must_get_node(pipe.data_img_node_names[0]).dims = in_dims
    return pipe


# ---- binary caffemodel weights ----

def read_binary_net_param(path: Union[str, Path]) -> WireNode:
    return decode_wire(Path(path).read_bytes())


def _blob_to_nda(blob: WireNode, names_hint: Optional[list[str]] = None) -> NDA:
    data = blob.floats(_F.b_data)
    shp = blob.msg(_F.b_shape)
    if shp is not None:
        shape = shp.varints(_F.bs_dim)
    else:
        shape = [blob.varint(_F.b_num, 1), blob.varint(_F.b_chan, 1),
                 blob.varint(_F.b_h, 1), blob.varint(_F.b_w, 1)]
    shape = [int(s) for s in shape if s is not None]
    arr = np.asarray(data, np.float32).reshape(shape)
    if names_hint and len(names_hint) == len(shape):
        names = list(names_hint)
    elif len(shape) == 4:
        names = ["out_chan", "in_chan", "y", "x"]
    elif len(shape) == 2:   # modern 2-d InnerProduct weight blob
        names = ["out_chan", "in_chan"]
    elif len(shape) == 1:   # bias / BN stat vector
        names = ["out_chan"]
    else:
        names = [f"d{i}" for i in range(len(shape))]
    return NDA.from_array(arr, names)


def extract_layer_blobs(net_wire: WireNode) -> dict[str, list[NDA]]:
    """layer name → blobs, handling V2 (field 100) and V1 (field 2) layers."""
    out: dict[str, list[NDA]] = {}
    for fno, name_f, blobs_f in ((_F.net_layer, _F.l_name, _F.l_blobs),
                                 (_F.net_layers_v1, _F.v1_name, _F.v1_blobs)):
        for lw in net_wire.msgs(fno):
            name = lw.string(name_f)
            if name is None:
                continue
            blobs = [_blob_to_nda(b) for b in lw.msgs(blobs_f)]
            if blobs:
                out[name] = blobs
    return out


def copy_matching_layer_blobs_to_pipe(pipe: ConvPipe,
                                      blobs_by_layer: dict[str, list[NDA]],
                                      strict: bool = False) -> list[str]:
    """Name-matched weight copy (ref: caffepb.cc:593). Returns layer names
    in the pipe that got no weights."""
    missing = []
    for op in pipe.ops.values():
        if op.type not in ("Convolution", "Deconvolution", "InnerProduct"):
            continue
        cname = op.str_vals.get("caffe_name", op.tag)
        blobs = blobs_by_layer.get(cname)
        fnode = pipe.must_get_node(op.bots[1])
        bnode = pipe.must_get_node(op.bots[2]) if len(op.bots) > 2 else None
        if blobs is None:
            missing.append(cname)
            if strict:
                raise RtErr(f"no weights for layer '{cname}' in caffemodel")
            continue
        w = blobs[0].v
        if fnode.dims is not None:
            if op.type == "Deconvolution":
                # caffe stores deconv weights physically (in_chan, out_chan,
                # ky, kx) — the gradient-of-conv convention (caffepb.cc:219);
                # the pipe convention is (out_chan, in_chan, y, x) with
                # out_chan = num_output, so transpose at copy time
                oc, ic, ky, kx = fnode.dims.shape
                w = w.reshape(ic, oc, ky, kx).transpose(1, 0, 2, 3).copy()
            else:
                w = w.reshape(fnode.dims.shape)
        pipe.op_params[op.bots[1]] = NDA(fnode.dims or blobs[0].dims, w)
        if bnode is not None:
            if len(blobs) > 1:
                b = blobs[1].v.reshape(bnode.dims.shape) if bnode.dims is not None else blobs[1].v
                pipe.op_params[op.bots[2]] = NDA(bnode.dims or blobs[1].dims, b)
            elif bnode.dims is not None:  # bias_term=false → zero bias
                pipe.op_params[op.bots[2]] = NDA(bnode.dims)
    return missing


def fold_bn_scale(pipe: ConvPipe, blobs_by_layer: dict[str, list[NDA]],
                  eps: float = 1e-5) -> ConvPipe:
    """Deploy-time fold: BatchNorm (+ following Scale) in-place ops merge
    into the producing Convolution's filts/biases; the BN/Scale ops are
    removed. w' = w·γ/σ ; b' = (b−μ)·γ/σ + β."""
    for node in pipe.nodes.values():
        keep = []
        for ip in node.in_place_ops:
            if ip.type not in ("BatchNorm", "Scale"):
                keep.append(ip)
                continue
            writers = node.top_for
            if len(writers) != 1:
                raise RtErr(f"fold_bn_scale: node '{node.name}' has no single "
                            f"producing op for '{ip.tag}'")
            conv = pipe.get_op(writers[0])
            if conv.type not in ("Convolution", "Deconvolution", "InnerProduct"):
                raise RtErr(f"fold_bn_scale: producer of '{node.name}' is "
                            f"'{conv.type}', can only fold into conv/fc")
            blobs = blobs_by_layer.get(ip.str_vals.get("caffe_name", ip.tag))
            if blobs is None:
                raise RtErr(f"fold_bn_scale: no blobs for '{ip.tag}'")
            for wn in conv.bots[1:3]:
                if wn not in pipe.op_params:
                    # the caffemodel omitted/renamed the conv's own blobs
                    # (copy tolerates missing layers) — name the layer
                    # instead of a raw KeyError
                    raise RtErr(f"fold_bn_scale: conv '{conv.tag}' has no "
                                f"loaded weights ('{wn}') to fold "
                                f"'{ip.tag}' into")
            w = pipe.op_params[conv.bots[1]].v.astype(np.float64)
            b = pipe.op_params[conv.bots[2]].v.astype(np.float64)
            if ip.type == "BatchNorm":
                mean, var = blobs[0].v.reshape(-1), blobs[1].v.reshape(-1)
                sf = blobs[2].v.reshape(-1)[0] if len(blobs) > 2 else 1.0
                sf = 1.0 / sf if sf else 0.0
                mean = mean * sf
                var = var * sf
                inv = 1.0 / np.sqrt(var + eps)
                w = w * inv.reshape([-1] + [1] * (w.ndim - 1))
                b = (b - mean) * inv if b.shape == mean.shape else b * inv - mean * inv
            else:  # Scale
                gamma = blobs[0].v.reshape(-1)
                beta = blobs[1].v.reshape(-1) if len(blobs) > 1 else np.zeros_like(gamma)
                w = w * gamma.reshape([-1] + [1] * (w.ndim - 1))
                b = b * gamma + beta
            fd = pipe.op_params[conv.bots[1]].dims
            bd = pipe.op_params[conv.bots[2]].dims
            pipe.op_params[conv.bots[1]] = NDA(fd, w.astype(fd.dtype))
            pipe.op_params[conv.bots[2]] = NDA(bd, b.astype(bd.dtype))
            del pipe.ops[ip.tag]
        node.in_place_ops = keep
    return pipe


def read_model(prototxt_path, caffemodel_path=None, in_dims: Optional[Dims] = None,
               out_node_name: str = "", add_bck_ops: bool = False) -> ConvPipe:
    """Full import path: prototxt (+ optional weights) → calc'd ConvPipe.
    add_bck_ops=True keeps the net's SoftmaxWithLoss cap and synthesizes
    the backward ops (reference: create_pipe_from_param + add_bck_ops,
    caffepb.cc:297)."""
    try:
        txt = Path(prototxt_path).read_text()
    except UnicodeDecodeError:
        raise RtErr(f"'{prototxt_path}' is not a text prototxt (binary file? "
                    "pass caffemodels via --trained-fn)")
    net = parse_pbtext(txt)
    pipe = create_pipe_from_param(net, in_dims=in_dims,
                                  out_node_name=out_node_name,
                                  phase="TRAIN" if add_bck_ops else "TEST",
                                  add_bck_ops=add_bck_ops)
    blobs = {}
    if caffemodel_path is not None:
        blobs = extract_layer_blobs(read_binary_net_param(caffemodel_path))
    pipe.calc_dims()
    if add_bck_ops:
        pipe.add_bck_ops()
    pipe.calc_support_info()
    if caffemodel_path is not None:
        copy_matching_layer_blobs_to_pipe(pipe, blobs)
        if any(op.type in ("BatchNorm", "Scale") for op in pipe.ops.values()):
            fold_bn_scale(pipe, blobs)
    return pipe


# ---- export (as_net_param; surgery writers) ----

def pipe_to_net_param(pipe: ConvPipe, name: str = "net") -> PbNode:
    net = PbNode()
    net.add("name", name)
    if pipe.data_img_node_names:
        dn = pipe.data_img_node_names[0]
        nd = pipe.must_get_node(dn)
        net.add("input", dn)
        if nd.dims is not None:
            sh = PbNode()
            for s in nd.dims.shape:
                sh.add("dim", int(s))
            net.add("input_shape", sh)

    def add_layer(op: ConvOp):
        l = PbNode()
        l.add("name", op.tag)
        l.add("type", op.type)
        data_bots = op.bots[:1] if op.type in ("Convolution", "Deconvolution",
                                               "InnerProduct") else op.bots
        for b in data_bots:
            l.add("bottom", b)
        for t in op.tops:
            l.add("top", t)
        if op.type in ("Convolution", "Deconvolution", "InnerProduct"):
            # round-trip non-default ParamSpec mults ([filts, biases])
            mults = [pipe.param_mults.get(b) for b in op.bots[1:3]]
            if any(m is not None for m in mults):
                for m in mults:
                    sp = PbNode()
                    lm, dm = m if m is not None else (1.0, 1.0)
                    sp.add("lr_mult", lm)
                    sp.add("decay_mult", dm)
                    l.add("param", sp)
        if op.type in ("Convolution", "Deconvolution"):
            cp = PbNode()
            cp.add("num_output", op.get_u32("out_chans"))
            ks, st, pd = op.kern_sz(), op.stride(), op.in_pad()
            cp.add("kernel_size", ks.y) if ks.y == ks.x else (
                cp.add("kernel_h", ks.y), cp.add("kernel_w", ks.x))
            if st != (1, 1):
                cp.add("stride", st.y) if st.y == st.x else (
                    cp.add("stride_h", st.y), cp.add("stride_w", st.x))
            if pd != (0, 0):
                cp.add("pad", pd.y) if pd.y == pd.x else (
                    cp.add("pad_h", pd.y), cp.add("pad_w", pd.x))
            if op.get_u32_or("groups", 1) > 1:
                cp.add("group", op.get_u32("groups"))
            l.add("convolution_param", cp)
        elif op.type == "InnerProduct":
            ip = PbNode()
            ip.add("num_output", op.get_u32("out_chans"))
            l.add("inner_product_param", ip)
        elif op.type == "Pooling":
            pp = PbNode()
            pp.add("pool", "AVE" if op.get_u32_or("avg_pool", 0) else "MAX")
            ks = op.kern_sz()
            if ks.is_zeros():
                pp.add("global_pooling", True)
            else:
                pp.add("kernel_size", ks.y)
            st = op.stride()
            if st != (1, 1):
                pp.add("stride", st.y)
            pd = op.in_pad()
            if pd != (0, 0):
                pp.add("pad", pd.y)
            l.add("pooling_param", pp)
        elif op.type == "LRN":
            lp = PbNode()
            lp.add("local_size", op.get_u32_or("local_size", 5))
            lp.add("alpha", float(op.nda_vals["alpha"].item()))
            lp.add("beta", float(op.nda_vals["beta"].item()))
            l.add("lrn_param", lp)
        elif op.type == "Dropout":
            dp = PbNode()
            dp.add("dropout_ratio", float(op.nda_vals["dropout_ratio"].item()))
            l.add("dropout_param", dp)
        elif op.type == "Eltwise":
            ep = PbNode()
            ep.add("operation", op.str_vals.get("ew_op", "SUM"))
            l.add("eltwise_param", ep)
        net.add("layer", l)

    emitted = set()
    for op in pipe.topo_order():
        add_layer(op)
        emitted.add(op.tag)
        for ip in pipe.must_get_node(op.tops[0]).in_place_ops:
            add_layer(ip)
            emitted.add(ip.tag)
    return net


def write_prototxt(pipe: ConvPipe, path, name: str = "net") -> None:
    Path(path).write_text(print_pbtext(pipe_to_net_param(pipe, name)))


def write_caffemodel(pipe: ConvPipe, path, name: str = "net") -> None:
    """Binary NetParameter with V2 layers carrying this pipe's weights."""
    out = bytearray()
    out += enc_field_string(_F.net_name, name)
    for op in pipe.topo_order():
        if op.type not in ("Convolution", "Deconvolution", "InnerProduct"):
            continue
        lb = bytearray()
        lb += enc_field_string(_F.l_name, op.tag)
        lb += enc_field_string(_F.l_type, op.type)
        for bname in op.bots[1:3]:
            nda = pipe.op_params.get(bname)
            if nda is None:
                continue
            v, shape = nda.v, nda.dims.shape
            if op.type == "Deconvolution" and bname == op.bots[1] and v.ndim == 4:
                # write back in caffe's physical deconv layout
                # (in_chan, out_chan, ky, kx) — inverse of the copy-in
                v = v.transpose(1, 0, 2, 3)
                shape = v.shape
            bb = bytearray()
            shp = bytearray()
            shp += enc_field_packed_varints(_F.bs_dim, shape)
            bb += enc_field_packed_floats(_F.b_data, v.reshape(-1))
            bb += enc_field_bytes(_F.b_shape, bytes(shp))
            lb += enc_field_bytes(_F.l_blobs, bytes(bb))
        out += enc_field_bytes(_F.net_layer, bytes(lb))
    Path(path).write_bytes(bytes(out))


# ---- net surgery ----

def fc_to_conv(pipe: ConvPipe) -> ConvPipe:
    """Convert InnerProduct ops to equivalent Convolution ops (ref:
    cnet_fc_to_conv caffepb.cc:888): kernel = input spatial size for the
    first fc, 1x1 for subsequent ones; weights reshape accordingly."""
    for op in list(pipe.ops.values()):
        if op.type != "InnerProduct":
            continue
        in_dims = pipe.must_get_node(op.bots[0]).dims
        if in_dims is None:
            raise RtErr("fc_to_conv: run calc_dims first")
        ky, kx = in_dims["y"], in_dims["x"]
        op.str_vals["type"] = "InnerProduct"  # keep identity until rewrite
        new = ConvOp("Convolution", op.tag, op.bots, op.tops,
                     {"out_chans": op.get_u32("out_chans"),
                      "kern_sz": (ky, kx), "stride": (1, 1), "in_pad": (0, 0)})
        new.str_vals["caffe_name"] = op.str_vals.get("caffe_name", op.tag)
        pipe.ops[op.tag] = new
        w = pipe.op_params.get(op.bots[1])
        if w is not None:
            oc = new.get_u32("out_chans")
            arr = w.v.reshape(oc, in_dims["chan"], ky, kx)
            pipe.op_params[op.bots[1]] = NDA.from_array(arr, ["out_chan", "in_chan", "y", "x"])
            fnode = pipe.must_get_node(op.bots[1])
            fnode.dims = pipe.op_params[op.bots[1]].dims
    return pipe


def resize_kernel(w: np.ndarray, new_ky: int, new_kx: int) -> np.ndarray:
    """Bilinear-resample conv kernels to a new spatial size, preserving the
    filter's integral (ref: resize_kernel caffepb.cc:677)."""
    oc, ic, ky, kx = w.shape
    if (ky, kx) == (new_ky, new_kx):
        return w.copy()
    ys = np.linspace(0, ky - 1, new_ky)
    xs = np.linspace(0, kx - 1, new_kx)
    y0 = np.clip(np.floor(ys).astype(int), 0, ky - 1)
    y1 = np.clip(y0 + 1, 0, ky - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, kx - 1)
    x1 = np.clip(x0 + 1, 0, kx - 1)
    fy = (ys - y0).reshape(-1, 1)
    fx = (xs - x0).reshape(1, -1)
    out = (w[:, :, y0][:, :, :, x0] * (1 - fy) * (1 - fx)
           + w[:, :, y1][:, :, :, x0] * fy * (1 - fx)
           + w[:, :, y0][:, :, :, x1] * (1 - fy) * fx
           + w[:, :, y1][:, :, :, x1] * fy * fx)
    ssum = w.sum(axis=(2, 3), keepdims=True)
    nsum = out.sum(axis=(2, 3), keepdims=True)
    scale = np.where(np.abs(nsum) > 1e-12, ssum / np.where(nsum == 0, 1, nsum), 1.0)
    return (out * scale).astype(w.dtype)
