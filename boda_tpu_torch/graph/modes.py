"""Graph/net-surgery CLI modes and the net-loading base of the port's net
modes (`_NetMode`: model / prototxt / weights fields; `_load_pipe`).

The port's copy of boda_tpu/graph/modes.py. Reference parity: conv_ana
(conv_util.cc:964), cnet_ana (op/flop dump, caffepb.cc:441), cnet_copy
(:781), cnet_resize_conv (:824), cnet_fc_to_conv (:888), cnet_bpt_dump
(:710), cnet_util (:992). They work on the host: the pipe, its numpy
weights and the caffe files, with the JAX modes' output text and files.
"""

from __future__ import annotations

from ..core.config import Attr
from ..core.dims import Dims
from ..core.error import RtErr
from ..core.has_main import HasMain, mode


def _load_pipe(hm) -> "ConvPipe":
    from .caffe_io import read_model
    from ..models.zoo import build_model, init_pipe_weights
    if getattr(hm, "model", ""):
        kw = {"batch": getattr(hm, "batch", 1)}
        ind = getattr(hm, "in_dims", None)
        if ind is not None:
            kw.update(batch=ind.get("img", kw["batch"]),
                      ysz=ind["y"], xsz=ind["x"])
        mo = getattr(hm, "model_opts", "")
        if mo:  # extra builder kwargs, e.g. (num_classes=40)
            from ..core.lexp import parse_lexp
            l = parse_lexp(mo) if isinstance(mo, str) else mo
            l.deep_inc_use_cnt()
            for name, kid in l.kids:
                v = kid.leaf_val
                kw[name] = int(v) if v.lstrip("-").isdigit() else v
        pipe = build_model(hm.model, **kw)
    else:
        if not getattr(hm, "ptt_fn", ""):
            raise RtErr("specify --model=<zoo name> or --ptt-fn=<prototxt>")
        in_dims = None
        if getattr(hm, "in_dims", None) is not None:
            in_dims = hm.in_dims
        pipe = read_model(hm.ptt_fn, getattr(hm, "trained_fn", "") or None,
                          in_dims=in_dims)
        if not pipe.op_params:
            from ..models.zoo import init_pipe_weights
            init_pipe_weights(pipe)
    wfn = getattr(hm, "weights_fn", "")
    if wfn:  # trained-weights artifact overrides the init/caffemodel params
        from ..apps.train import load_weights_into_pipe
        load_weights_into_pipe(pipe, wfn)
    return pipe


class _NetMode(HasMain):
    model = Attr(str, default="", help="model zoo name (e.g. resnet-50)")
    model_opts = Attr(str, default="",
                      help="extra model-builder kwargs as a lexp, e.g. "
                           "(num_classes=40)")
    ptt_fn = Attr(str, default="", help="prototxt filename")
    trained_fn = Attr(str, default="", help="caffemodel filename")
    weights_fn = Attr(str, default="",
                      help="trained-weights artifact (apps/train "
                           "write_weights_artifact) applied onto the "
                           "net's params after load")
    in_dims = Attr(Dims, default=None, help="override input dims, e.g. "
                   "(dims=(img=1,chan=3,y=227,x=227))")
    batch = Attr(int, default=1)


@mode("conv_ana", help="analyze a conv pipe: dumps, support info, sizes")
class ConvAna(_NetMode):
    dump_ops = Attr(bool, default=False)

    def main(self):
        pipe = _load_pipe(self)
        pipe.dump_pipe()
        pipe.dump_ios()
        if self.dump_ops:
            pipe.dump_ops()


@mode("cnet_ana", help="per-op flops/bytes/AI analysis of a net")
class CnetAna(_NetMode):
    def main(self):
        pipe = _load_pipe(self)
        total_f = 0
        total_b = 0
        print(f"{'op':30s} {'type':14s} {'out_dims':26s} {'Mflops':>10s} {'MB':>8s} {'AI':>7s}")
        for op in pipe.topo_order():
            od = pipe.must_get_node(op.tops[0]).dims
            f = 0
            if op.type in ("Convolution", "InnerProduct", "Deconvolution"):
                fd = pipe.must_get_node(op.bots[1]).dims
                f = 2 * od.sz() * fd["in_chan"] * fd.get("y", 1) * fd.get("x", 1)
            byts = sum(pipe.must_get_node(b).dims.bytes_sz() for b in op.bots
                       if pipe.nodes[b].dims is not None)
            byts += od.bytes_sz()
            ai = f / byts if byts else 0.0
            total_f += f
            total_b += byts
            print(f"{op.tag:30s} {op.type:14s} {od.pretty():26s} "
                  f"{f / 1e6:10.1f} {byts / 1e6:8.2f} {ai:7.1f}")
        print(f"TOTAL: {total_f / 1e9:.3f} GF, {total_b / 1e6:.1f} MB, "
              f"AI={total_f / max(total_b, 1):.1f}")


@mode("cnet_copy", help="read a net (+weights) and write it back out")
class CnetCopy(_NetMode):
    out_ptt_fn = Attr(str, default="out.prototxt")
    out_trained_fn = Attr(str, default="")

    def main(self):
        from .caffe_io import write_caffemodel, write_prototxt
        pipe = _load_pipe(self)
        write_prototxt(pipe, self.out_path(self.out_ptt_fn))
        if self.out_trained_fn:
            write_caffemodel(pipe, self.out_path(self.out_trained_fn))
        print(f"wrote {self.out_ptt_fn}" + (f" + {self.out_trained_fn}" if self.out_trained_fn else ""))


@mode("cnet_fc_to_conv", help="convert InnerProduct layers to Convolution")
class CnetFcToConv(_NetMode):
    out_ptt_fn = Attr(str, default="out.prototxt")
    out_trained_fn = Attr(str, default="")

    def main(self):
        from .caffe_io import fc_to_conv, write_caffemodel, write_prototxt
        pipe = _load_pipe(self)
        fc_to_conv(pipe)
        write_prototxt(pipe, self.out_path(self.out_ptt_fn))
        if self.out_trained_fn:
            write_caffemodel(pipe, self.out_path(self.out_trained_fn))
        print(f"fc_to_conv: wrote {self.out_ptt_fn}")


@mode("cnet_resize_conv", help="bilinear-resample a conv layer's kernels")
class CnetResizeConv(_NetMode):
    layer = Attr(str, req=True, help="conv layer tag to resize")
    new_kern_sz = Attr(list[int], default="3 3", help="new kernel (ky kx)")
    out_trained_fn = Attr(str, default="resized.caffemodel")

    def main(self):
        from .caffe_io import resize_kernel, write_caffemodel
        from ..core.dims import NDA
        pipe = _load_pipe(self)
        op = pipe.get_op(self.layer)
        w = pipe.op_params[op.bots[1]]
        nw = resize_kernel(w.v, self.new_kern_sz[0], self.new_kern_sz[1])
        pipe.op_params[op.bots[1]] = NDA.from_array(nw, ["out_chan", "in_chan", "y", "x"])
        write_caffemodel(pipe, self.out_path(self.out_trained_fn))
        print(f"resized '{self.layer}' kernels {w.v.shape[2:]} -> {tuple(self.new_kern_sz)}")


@mode("cnet_bpt_dump", help="dump a net's per-layer params (data stripped)")
class CnetBptDump(_NetMode):
    """Reference: cnet_bpt_dump (caffepb.cc:710) — print the trained net's
    structure with blob data removed: per layer, the op signature and each
    param blob's dims + summary stats (the inspect-a-model utility)."""

    show_stats = Attr(bool, default=True, help="print min/max/avg per blob")

    def main(self):
        import numpy as np
        pipe = _load_pipe(self)
        for op in pipe.topo_order():
            print(f"layer {op.tag}: type={op.type} bots={','.join(op.bots)} "
                  f"tops={','.join(op.tops)}")
            for b in op.bots[1:]:
                nda = pipe.op_params.get(b)
                if nda is None:
                    continue
                line = f"  blob {b}: {nda.dims.pretty()}"
                if self.show_stats:
                    v = np.asarray(nda.v, np.float64)
                    line += (f" min={v.min():.6g} max={v.max():.6g} "
                             f"avg={v.mean():.6g}")
                print(line)


@mode("cnet_util", help="insert an identity conv layer before a given layer")
class CnetUtil(_NetMode):
    """Reference: cnet_util (caffepb.cc:992) — net surgery that inserts an
    extra conv layer initialized to identity (optionally with noise) before
    a named layer, preserving function — used to deepen nets in place."""

    add_before_ln = Attr(str, req=True, help="layer tag to insert before")
    noise_mode = Attr(int, default=0, help="0=no noise, 1=xavier noise")
    out_ptt_fn = Attr(str, default="out.prototxt")
    out_trained_fn = Attr(str, default="")

    def main(self):
        import numpy as np
        from ..core.dims import NDA, Dims
        from .caffe_io import write_caffemodel, write_prototxt
        from .pipe import ConvOp, ConvPipe
        pipe = _load_pipe(self)
        tgt = pipe.get_op(self.add_before_ln)
        in_node = tgt.bots[0]
        chans = pipe.must_get_node(in_node).dims["chan"]
        new_tag = f"{self.add_before_ln}_pre_ident"
        new_node = f"{new_tag}_out"
        # rebuild the graph with the identity conv spliced in
        out = ConvPipe()
        for op in pipe.ops.values():
            bots = list(op.bots)
            tops = list(op.tops)
            if op.tag == tgt.tag:
                bots[0] = new_node
            elif op.in_place and op.bots[0] == in_node:
                pass  # in-place ops stay on the original node
            c = ConvOp(op.type, op.tag, bots, tops, dict(op.params))
            c.str_vals.update({k: v for k, v in op.str_vals.items()
                               if k != "type"})
            out.add_op(c)
        out.add_op(ConvOp("Convolution", new_tag,
                          [in_node, f"{new_tag}_filts", f"{new_tag}_biases"],
                          [new_node],
                          {"out_chans": chans, "kern_sz": (1, 1),
                           "stride": (1, 1), "in_pad": (0, 0)}))
        out.data_img_node_names = list(pipe.data_img_node_names)
        for name, node in pipe.nodes.items():
            if node.dims is not None and not node.top_for and name in out.nodes:
                out.nodes[name].dims = node.dims
        out.calc_dims()
        out.calc_support_info()
        out.op_params = dict(pipe.op_params)
        w = np.zeros((chans, chans, 1, 1), np.float32)
        w[np.arange(chans), np.arange(chans), 0, 0] = 1.0
        if self.noise_mode == 1:
            rng = np.random.RandomState(42)
            w += rng.randn(*w.shape).astype(np.float32) * np.sqrt(1.0 / chans) * 0.01
        out.op_params[f"{new_tag}_filts"] = NDA(
            out.must_get_node(f"{new_tag}_filts").dims, w)
        out.op_params[f"{new_tag}_biases"] = NDA(
            out.must_get_node(f"{new_tag}_biases").dims,
            np.zeros(chans, np.float32))
        write_prototxt(out, self.out_path(self.out_ptt_fn))
        if self.out_trained_fn:
            write_caffemodel(out, self.out_path(self.out_trained_fn))
        print(f"cnet_util: inserted identity conv '{new_tag}' before "
              f"'{self.add_before_ln}' ({chans} chans)")
