"""Upsampled-companion-net synthesis: the "2x octave for free" trick.

Capability parity with the reference (caffeif.cc:185-236 upsampled net
construction; caffepb.cc create_upsamp_layer_weights :795-820; validated
by test_upsamp, test_dense.cc:145): clone the net, halve the first conv
layer's kern_sz/stride/in_pad (ceil for kernel+pad; stride must be even),
and fold the original filters 2x2 (w'[o,i,(y+py)>>1,(x+px)>>1] +=
w[o,i,y,x], py/px the parity of the first conv's pad). Running the
companion on image I then equals running the original net on
nearest-neighbor-2x-upsampled I — one extra pyramid octave without paying
for 4x input pixels.

The port's copy of boda_tpu/models/upsamp.py, with one repair (ROADMAP
C7): the JAX package folds tap y into y>>1 whatever the pad, which is
right only for an even pad. Under an odd pad p, tap y of output o reads
upsampled pixel 2o - p + y, that is original pixel o - (p+1)/2 +
((y+1)>>1): the fold shifts by the pad's parity, and the folded kernel
is (k+2)//2 wide (ResNet's 7x7/2 conv1 with pad 3: 4x4 with pad 2, where
the JAX fold is half a pixel off). For even pads nothing changes.
"""

from __future__ import annotations

import numpy as np

from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..graph.pipe import ConvOp, ConvPipe


def clone_pipe(pipe: ConvPipe, in_dims: Dims = None) -> ConvPipe:
    """Structural clone (fresh ops/nodes; op_params shared by default)."""
    out = ConvPipe()
    for op in pipe.ops.values():
        c = ConvOp(op.type, op.tag, op.bots, op.tops, dict(op.params))
        c.str_vals.update({k: v for k, v in op.str_vals.items() if k != "type"})
        out.add_op(c)
    for name, node in pipe.nodes.items():
        if node.dims is not None and not node.top_for and name in out.nodes:
            out.nodes[name].dims = node.dims
    out.data_img_node_names = list(pipe.data_img_node_names)
    out.data_label_node_names = list(pipe.data_label_node_names)
    out.out_node_name = pipe.out_node_name
    if in_dims is not None:
        out.must_get_node(out.data_img_node_names[0]).dims = in_dims
    out.op_params = dict(pipe.op_params)
    return out


def first_conv_op(pipe: ConvPipe) -> ConvOp:
    for op in pipe.topo_order():
        if op.type == "Data":
            continue
        if op.type != "Convolution":
            raise RtErr("first non-data layer of net not conv layer; don't "
                        "know how to create upsampled network")
        return op
    raise RtErr("no non-data layers in net")


def fold_filters_2x(w: np.ndarray, py: int = 0, px: int = 0) -> np.ndarray:
    """(oc,ic,ky,kx) → (oc,ic,(ky+py+1)//2,(kx+px+1)//2) by 2x2 summation,
    tap y into (y+py)>>1 (reference: create_upsamp_layer_weights,
    caffepb.cc:812-819, where py = px = 0); py, px: the parity of the
    conv's pad in y and x."""
    oc, ic, ky, kx = w.shape
    out = np.zeros((oc, ic, (ky + py + 1) // 2, (kx + px + 1) // 2),
                   dtype=w.dtype)
    for y in range(ky):
        for x in range(kx):
            out[:, :, (y + py) >> 1, (x + px) >> 1] += w[:, :, y, x]
    return out


def make_upsamp_pipe(pipe: ConvPipe, in_dims: Dims = None) -> ConvPipe:
    """Build the 2x-upsampled companion pipe with folded first-conv
    weights. Default keeps the source pipe's input dims (companion features
    are then 2x the original's, the pyramid-octave use); pass half-size
    in_dims to compare against the original net on an upsampled image."""
    src_op = first_conv_op(pipe)
    ks = src_op.kern_sz()
    st = src_op.stride()
    pd = src_op.in_pad()
    if st.y % 2 or st.x % 2:
        raise RtErr("first conv layer has odd stride in some dim; don't "
                    "know how to create upsampled network")
    up = clone_pipe(pipe, in_dims=in_dims)
    uop = up.get_op(src_op.tag)
    py, px = pd.y % 2, pd.x % 2
    uop._set_param("kern_sz", ((ks.y + py + 1) // 2, (ks.x + px + 1) // 2))
    uop._set_param("stride", (st.y // 2, st.x // 2))
    uop._set_param("in_pad", ((pd.y + 1) // 2, (pd.x + 1) // 2))
    up.calc_dims()
    up.calc_support_info()
    # fold weights; biases unchanged
    filts_node = src_op.bots[1]
    w = pipe.op_params[filts_node]
    fw = fold_filters_2x(w.v, py, px)
    up.op_params = dict(pipe.op_params)
    up.op_params[filts_node] = NDA(up.must_get_node(filts_node).dims, fw)
    return up


def upsample_2x_nn(x: np.ndarray) -> np.ndarray:
    """Nearest-neighbor 2x on the trailing two axes — the upsampling for
    which the folded-filter equivalence is exact."""
    return np.repeat(np.repeat(x, 2, axis=-2), 2, axis=-1)
