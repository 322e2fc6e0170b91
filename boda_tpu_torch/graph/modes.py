"""The net-loading base of the port's net modes: `_NetMode` (model /
prototxt / weights fields) and `_load_pipe`.

The port's copy of that part of boda_tpu/graph/modes.py; the JAX
package's net-analysis and net-surgery modes there (conv_ana, cnet_ana,
cnet_copy, cnet_fc_to_conv, cnet_resize_conv, cnet_bpt_dump, cnet_util)
are not on the port's paths and are left out.
"""

from __future__ import annotations

from ..core.config import Attr
from ..core.dims import Dims
from ..core.error import RtErr
from ..core.has_main import HasMain


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
