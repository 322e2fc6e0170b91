"""Model zoo: the nets/ directory equivalent, defined natively in Python.

The reference ships 20 caffe prototxts (nets/: nin_imagenet[_nopad],
alexnet_ng_conv, googlenet_conv, vgg_19/VGG16, resnet-50/101/152,
squeezenet-1.0, firenet*). Here each family is a builder producing a
ConvPipe directly; graph/caffe_io.py additionally imports/exports prototxt
so reference model files remain usable. All-conv forms (fc layers expressed
as Convolution, as the reference's *-conv nets do) keep dense multi-scale
inference possible.

Weight init is deterministic (seeded per-blob) so cross-backend digest
tests need no downloads — mirroring the reference's archived-digest
strategy (SURVEY.md §4.7).

The port's copy of boda_tpu/models/zoo.py.
"""

from __future__ import annotations

import numpy as np

from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..graph.pipe import ConvOp, ConvPipe


class NetBuilder:
    """Chainable pipe builder; tracks the current node name."""

    def __init__(self, name: str, batch: int = 1, chans: int = 3,
                 ysz: int = 227, xsz: int = 227, tn: str = "float"):
        self.name = name
        self.pipe = ConvPipe()
        self.cur = "data"
        # 'data' is a source *node* (no producing op), as in pipes imported
        # from caffe (caffepb skips Data layers; the node is a plain source)
        n = self.pipe.get_or_make_node("data", False, False)
        n.dims = Dims.make(tn=tn, img=batch, chan=chans, y=ysz, x=xsz)
        self.pipe.data_img_node_names = ["data"]
        self._uid = 0

    def _tag(self, base: str) -> str:
        self._uid += 1
        return base

    def conv(self, tag: str, out_chans: int, kern: int, stride: int = 1,
             pad: int = 0, relu: bool = True, in_node: str = "",
             groups: int = 1) -> "NetBuilder":
        """A conv; groups > 1: a grouped conv, whose filter is (out_chans,
        in / groups, kern, kern) (the op carries `groups` only then)."""
        src = in_node or self.cur
        params = {"out_chans": out_chans, "kern_sz": (kern, kern),
                  "stride": (stride, stride), "in_pad": (pad, pad)}
        if groups != 1:
            params["groups"] = groups
        self.pipe.add_op(ConvOp("Convolution", tag, [src, f"{tag}_filts", f"{tag}_biases"],
                                [tag], params))
        self.cur = tag
        if relu:
            self.relu(f"{tag}_relu")
        return self

    def relu(self, tag: str) -> "NetBuilder":
        self.pipe.add_op(ConvOp("ReLU", tag, [self.cur], [self.cur]))
        return self

    def deconv(self, tag: str, out_chans: int, kern: int, stride: int = 1,
               pad: int = 0, relu: bool = False, in_node: str = "") -> "NetBuilder":
        """Transposed convolution (caffe Deconvolution; e.g. FCN upsampling)."""
        src = in_node or self.cur
        self.pipe.add_op(ConvOp("Deconvolution", tag,
                                [src, f"{tag}_filts", f"{tag}_biases"],
                                [tag], {"out_chans": out_chans, "kern_sz": (kern, kern),
                                        "stride": (stride, stride), "in_pad": (pad, pad)}))
        self.cur = tag
        if relu:
            self.relu(f"{tag}_relu")
        return self

    def pool(self, tag: str, kern: int, stride: int, pad: int = 0,
             avg: bool = False, global_: bool = False) -> "NetBuilder":
        params = {"kern_sz": (0, 0) if global_ else (kern, kern),
                  "stride": (stride, stride), "in_pad": (pad, pad),
                  "avg_pool": 1 if avg else 0}
        self.pipe.add_op(ConvOp("Pooling", tag, [self.cur], [tag], params))
        self.cur = tag
        return self

    def lrn(self, tag: str, local_size: int = 5, alpha: float = 1e-4,
            beta: float = 0.75) -> "NetBuilder":
        self.pipe.add_op(ConvOp("LRN", tag, [self.cur], [tag],
                                {"local_size": local_size, "alpha": alpha, "beta": beta}))
        self.cur = tag
        return self

    def dropout(self, tag: str, ratio: float = 0.5) -> "NetBuilder":
        self.pipe.add_op(ConvOp("Dropout", tag, [self.cur], [self.cur],
                                {"dropout_ratio": ratio}))
        return self

    def concat(self, tag: str, bots: list[str]) -> "NetBuilder":
        self.pipe.add_op(ConvOp("Concat", tag, bots, [tag]))
        self.cur = tag
        return self

    def eltwise(self, tag: str, bots: list[str], op: str = "SUM") -> "NetBuilder":
        self.pipe.add_op(ConvOp("Eltwise", tag, bots, [tag], {"ew_op": op}))
        self.cur = tag
        return self

    def softmax(self, tag: str = "prob") -> "NetBuilder":
        self.pipe.add_op(ConvOp("Softmax", tag, [self.cur], [tag]))
        self.cur = tag
        return self

    def softmax_with_loss(self, tag: str = "loss",
                          label: str = "label") -> "NetBuilder":
        """Cap the net with a loss op producing both the loss and the
        gradient w.r.t. its input — required before add_bck_ops()
        (reference: SoftmaxWithLoss handling, caffepb.cc:256-265)."""
        self.pipe.add_op(ConvOp("SoftmaxWithLoss", tag,
                                [self.cur, label],
                                [self.cur + "_grad_loss", tag]))
        self.pipe.data_label_node_names = [label]
        self.cur = tag
        return self

    def done(self, init_weights: bool = True, seed: int = 1234) -> ConvPipe:
        self.pipe.calc_dims()
        self.pipe.calc_support_info()
        if init_weights:
            init_pipe_weights(self.pipe, seed=seed)
        return self.pipe


def init_pipe_weights(pipe: ConvPipe, seed: int = 1234, mode: str = "msra") -> None:
    """Deterministic per-blob weight init (keyed by blob name, so results
    are stable under graph edits elsewhere)."""
    for op in pipe.ops.values():
        if op.type not in ("Convolution", "Deconvolution", "InnerProduct"):
            continue
        if len(op.bots) < 3:
            continue
        for bname in (op.bots[1], op.bots[2]):
            node = pipe.must_get_node(bname)
            if node.dims is None or bname in pipe.op_params:
                continue
            import zlib
            # stable per-name seed: Python's hash() is salted per process
            rng = np.random.RandomState((seed + zlib.crc32(bname.encode())) % (2 ** 31))
            if bname.endswith("_biases") or len(node.dims) == 1:
                v = np.zeros(node.dims.shape, dtype=node.dims.dtype)
            else:
                fan_in = int(np.prod(node.dims.shape[1:]))
                std = np.sqrt(2.0 / fan_in) if mode == "msra" else 0.01
                v = (rng.randn(*node.dims.shape) * std).astype(node.dims.dtype)
            pipe.op_params[bname] = NDA(node.dims, v)


# ---- model families ----

def build_nin(batch: int = 1, ysz: int = 227, xsz: int = 227, pad: bool = False,
              num_classes: int = 1000) -> ConvPipe:
    """Network-in-Network imagenet (reference: nets/nin_imagenet[_nopad]):
    conv+mlpconv(1x1) stacks, conv/relu/pool/dropout only, global avg pool +
    softmax — the smallest end-to-end model (BASELINE config #2)."""
    p3 = 1 if pad else 0
    b = NetBuilder("nin_imagenet" + ("" if pad else "_nopad"), batch, 3, ysz, xsz)
    b.conv("conv1", 96, 11, 4, 0).conv("cccp1", 96, 1).conv("cccp2", 96, 1)
    b.pool("pool1", 3, 2)
    b.conv("conv2", 256, 5, 1, 2 if pad else 0).conv("cccp3", 256, 1).conv("cccp4", 256, 1)
    b.pool("pool2", 3, 2)
    b.conv("conv3", 384, 3, 1, p3).conv("cccp5", 384, 1).conv("cccp6", 384, 1)
    b.pool("pool3", 3, 2).dropout("drop")
    b.conv("conv4-1024", 1024, 3, 1, p3).conv("cccp7-1024", 1024, 1)
    b.conv("cccp8-1024", num_classes, 1)
    b.pool("pool4", 6, 1, global_=True, avg=True)
    b.softmax()
    return b.done()


def build_alexnet_ng_conv(batch: int = 1, ysz: int = 227, xsz: int = 227,
                          num_classes: int = 1000, lrn: bool = True) -> ConvPipe:
    """AlexNet no-groups, FC→conv form (reference: nets/alexnet_ng_conv)."""
    b = NetBuilder("alexnet_ng_conv", batch, 3, ysz, xsz)
    b.conv("conv1", 96, 11, 4, 0)
    if lrn:
        b.lrn("norm1")
    b.pool("pool1", 3, 2)
    b.conv("conv2", 256, 5, 1, 2)
    if lrn:
        b.lrn("norm2")
    b.pool("pool2", 3, 2)
    b.conv("conv3", 384, 3, 1, 1).conv("conv4", 384, 3, 1, 1).conv("conv5", 256, 3, 1, 1)
    b.pool("pool5", 3, 2)
    b.conv("fc6-conv", 4096, 6, 1, 0).dropout("drop6")
    b.conv("fc7-conv", 4096, 1).dropout("drop7")
    b.conv("fc8-conv", num_classes, 1, relu=False)
    b.softmax()
    return b.done()


def _fire(b: NetBuilder, tag: str, squeeze: int, expand1: int, expand3: int) -> None:
    src = b.cur
    b.conv(f"{tag}_squeeze1x1", squeeze, 1, in_node=src)
    sq = b.cur
    b.conv(f"{tag}_expand1x1", expand1, 1, in_node=sq)
    e1 = b.cur
    b.conv(f"{tag}_expand3x3", expand3, 3, pad=1, in_node=sq)
    e3 = b.cur
    b.concat(f"{tag}_concat", [e1, e3])


def build_squeezenet(batch: int = 1, ysz: int = 227, xsz: int = 227,
                     num_classes: int = 1000) -> ConvPipe:
    """SqueezeNet 1.0 (reference: nets/squeezenet-1.0): fire modules
    (squeeze 1x1 → expand 1x1 + 3x3 concat), conv10 + global avg pool."""
    b = NetBuilder("squeezenet-1.0", batch, 3, ysz, xsz)
    b.conv("conv1", 96, 7, 2).pool("pool1", 3, 2)
    _fire(b, "fire2", 16, 64, 64)
    _fire(b, "fire3", 16, 64, 64)
    _fire(b, "fire4", 32, 128, 128)
    b.pool("pool4", 3, 2)
    _fire(b, "fire5", 32, 128, 128)
    _fire(b, "fire6", 48, 192, 192)
    _fire(b, "fire7", 48, 192, 192)
    _fire(b, "fire8", 64, 256, 256)
    b.pool("pool8", 3, 2)
    _fire(b, "fire9", 64, 256, 256)
    b.dropout("drop9")
    b.conv("conv10", num_classes, 1)
    b.pool("pool10", 0, 1, global_=True, avg=True)
    b.softmax()
    return b.done()


def build_firenet(batch: int = 1, ysz: int = 227, xsz: int = 227,
                  num_classes: int = 1000) -> ConvPipe:
    """FireNet-v0 (reference: nets/firenet-v0): squeezenet-style all-conv
    detection backbone variant."""
    b = NetBuilder("firenet-v0", batch, 3, ysz, xsz)
    b.conv("conv1", 96, 7, 2, 3).pool("pool1", 3, 2, 1)
    _fire(b, "fire2", 16, 64, 64)
    _fire(b, "fire3", 16, 64, 64)
    b.pool("pool3", 3, 2, 1)
    _fire(b, "fire4", 32, 128, 128)
    _fire(b, "fire5", 32, 128, 128)
    b.pool("pool5", 3, 2, 1)
    _fire(b, "fire6", 48, 192, 192)
    _fire(b, "fire7", 48, 192, 192)
    _fire(b, "fire8", 64, 256, 256)
    _fire(b, "fire9", 64, 256, 256)
    b.conv("conv10", num_classes, 1)
    b.pool("pool10", 0, 1, global_=True, avg=True)
    b.softmax()
    return b.done()


def build_vgg16(batch: int = 1, ysz: int = 224, xsz: int = 224,
                num_classes: int = 1000) -> ConvPipe:
    """VGG-16 all-conv (reference: nets/VGG16-v2-conv)."""
    b = NetBuilder("vgg16-conv", batch, 3, ysz, xsz)
    cfg = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    for bi, (reps, ch) in enumerate(cfg, 1):
        for ri in range(1, reps + 1):
            b.conv(f"conv{bi}_{ri}", ch, 3, 1, 1)
        b.pool(f"pool{bi}", 2, 2)
    b.conv("fc6-conv", 4096, 7).dropout("drop6")
    b.conv("fc7-conv", 4096, 1).dropout("drop7")
    b.conv("fc8-conv", num_classes, 1, relu=False)
    b.softmax()
    return b.done()


def build_vgg19(batch: int = 1, ysz: int = 224, xsz: int = 224,
                num_classes: int = 1000) -> ConvPipe:
    """VGG-19 all-conv (reference: nets/vgg_19)."""
    b = NetBuilder("vgg19-conv", batch, 3, ysz, xsz)
    cfg = [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]
    for bi, (reps, ch) in enumerate(cfg, 1):
        for ri in range(1, reps + 1):
            b.conv(f"conv{bi}_{ri}", ch, 3, 1, 1)
        b.pool(f"pool{bi}", 2, 2)
    b.conv("fc6-conv", 4096, 7).dropout("drop6")
    b.conv("fc7-conv", 4096, 1).dropout("drop7")
    b.conv("fc8-conv", num_classes, 1, relu=False)
    b.softmax()
    return b.done()


def build_firenet8_ce(batch: int = 1, ysz: int = 227, xsz: int = 227,
                      num_classes: int = 1000, ce: float = 0.125,
                      final_pad: bool = True) -> ConvPipe:
    """FireNet8 with compression-expansion ratio (reference:
    nets/firenet8-CE-0.125[-nofinalpad]): fire squeeze chans scaled by ce
    relative to expand width."""
    b = NetBuilder("firenet8-ce", batch, 3, ysz, xsz)
    b.conv("conv1", 96, 7, 2, 3).pool("pool1", 3, 2, 1)
    for i, e in enumerate((64, 64, 128, 128, 192, 192, 256, 256), 2):
        sq = max(int(2 * e * ce), 1)
        _fire(b, f"fire{i}", sq, e, e)
        if i in (3, 5):
            b.pool(f"pool{i}", 3, 2, 1)
    b.conv("conv10", num_classes, 1, pad=1 if final_pad else 0)
    b.pool("pool10", 0, 1, global_=True, avg=True)
    b.softmax()
    return b.done()


def _res_block(b: NetBuilder, tag: str, in_node: str, chans: int, stride: int,
               project: bool) -> str:
    """Bottleneck residual block: 1x1/s → 3x3 → 1x1(4x), shortcut add.
    BatchNorm is folded into conv weights at import time (caffe_io folds
    BN+Scale), so blocks here are conv-only like the deploy-time graph."""
    b.conv(f"{tag}_branch2a", chans, 1, stride, in_node=in_node)
    b.conv(f"{tag}_branch2b", chans, 3, 1, 1)
    b.conv(f"{tag}_branch2c", chans * 4, 1, relu=False)
    main = b.cur
    if project:
        b.conv(f"{tag}_branch1", chans * 4, 1, stride, relu=False, in_node=in_node)
        shortcut = b.cur
    else:
        shortcut = in_node
    b.eltwise(f"{tag}", [shortcut, main])
    b.relu(f"{tag}_relu")
    return b.cur


def build_resnet(depth: int = 50, batch: int = 1, ysz: int = 224, xsz: int = 224,
                 num_classes: int = 1000) -> ConvPipe:
    """ResNet-50/101/152 (reference: nets/resnet-50/101/152) — the flagship
    model for the TPU build's headline benchmark (BASELINE north star)."""
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}.get(depth)
    if blocks is None:
        raise RtErr(f"unsupported resnet depth {depth}")
    b = NetBuilder(f"resnet-{depth}", batch, 3, ysz, xsz)
    b.conv("conv1", 64, 7, 2, 3).pool("pool1", 3, 2)
    cur = b.cur
    chans = 64
    for stage, reps in enumerate(blocks, 2):
        for r in range(reps):
            # caffe naming (nets/resnet-{50,101,152}/train_val.prototxt):
            # resnet-50 letters every stage (res4a..res4f); 101/152 keep
            # letters only for 3-block stages and use res{S}a,
            # res{S}b1..b{N-1} for the deep ones (res4b35) — chr(ord('a')+r)
            # beyond 26 blocks produced NON-PRINTABLE tags ('res4\x7f')
            # that [a-z0-9] site regexes silently skipped
            if depth == 50 or reps <= 3:
                tag = f"res{stage}{chr(ord('a') + r)}"
            else:
                tag = f"res{stage}a" if r == 0 else f"res{stage}b{r}"
            stride = 2 if (r == 0 and stage > 2) else 1
            cur = _res_block(b, tag, cur, chans, stride, project=(r == 0))
        chans *= 2
    b.pool("pool5", 7, 1, global_=True, avg=True)
    b.conv("fc1000-conv", num_classes, 1, relu=False)
    b.softmax()
    return b.done()


def build_resnext(depth: int = 101, cardinality: int = 64, width: int = 4,
                  batch: int = 1, ysz: int = 224, xsz: int = 224,
                  num_classes: int = 1000) -> ConvPipe:
    """ResNeXt (Xie et al., arXiv:1611.05431; facebookresearch/ResNeXt):
    ResNet's stem, head and block naming (build_resnet) around aggregated
    bottlenecks: a 1x1 to cardinality x width channels, a 3x3 in
    `cardinality` groups that carries the stage's stride, a 1x1 to the
    stage's output (256 << stage); the width doubles each stage. 101-64x4d:
    3/4/23/3 blocks, bottlenecks 256/512/1024/2048 wide."""
    blocks = {101: (3, 4, 23, 3)}.get(depth)
    if blocks is None:
        raise RtErr(f"unsupported resnext depth {depth}")
    b = NetBuilder(f"resnext-{depth}-{cardinality}x{width}d", batch, 3, ysz,
                   xsz)
    b.conv("conv1", 64, 7, 2, 3).pool("pool1", 3, 2)
    cur = b.cur
    for stage, reps in enumerate(blocks, 2):
        inner = cardinality * width << (stage - 2)
        out = 256 << (stage - 2)
        for r in range(reps):
            # build_resnet's caffe naming at 101: res4a, res4b1..res4b22
            tag = f"res{stage}{chr(ord('a') + r)}" if reps <= 3 else \
                (f"res{stage}a" if r == 0 else f"res{stage}b{r}")
            stride = 2 if (r == 0 and stage > 2) else 1
            b.conv(f"{tag}_branch2a", inner, 1, in_node=cur)
            b.conv(f"{tag}_branch2b", inner, 3, stride, 1,
                   groups=cardinality)
            b.conv(f"{tag}_branch2c", out, 1, relu=False)
            main = b.cur
            short = cur
            if r == 0:
                b.conv(f"{tag}_branch1", out, 1, stride, relu=False,
                       in_node=cur)
                short = b.cur
            b.eltwise(tag, [short, main])
            b.relu(f"{tag}_relu")
            cur = b.cur
    b.pool("pool5", 7, 1, global_=True, avg=True)
    b.conv("fc1000-conv", num_classes, 1, relu=False)
    b.softmax()
    return b.done()


def build_googlenet_conv(batch: int = 1, ysz: int = 224, xsz: int = 224,
                         num_classes: int = 1000, lrn: bool = False) -> ConvPipe:
    """GoogLeNet v1 all-conv (reference: nets/googlenet_conv[_no_lrn])."""
    b = NetBuilder("googlenet_conv", batch, 3, ysz, xsz)
    b.conv("conv1/7x7_s2", 64, 7, 2, 3).pool("pool1/3x3_s2", 3, 2)
    if lrn:
        b.lrn("pool1/norm1")
    b.conv("conv2/3x3_reduce", 64, 1).conv("conv2/3x3", 192, 3, 1, 1)
    if lrn:
        b.lrn("conv2/norm2")
    b.pool("pool2/3x3_s2", 3, 2)

    def inception(tag, c1, c3r, c3, c5r, c5, cp):
        src = b.cur
        b.conv(f"{tag}/1x1", c1, 1, in_node=src)
        o1 = b.cur
        b.conv(f"{tag}/3x3_reduce", c3r, 1, in_node=src)
        b.conv(f"{tag}/3x3", c3, 3, pad=1)
        o3 = b.cur
        b.conv(f"{tag}/5x5_reduce", c5r, 1, in_node=src)
        b.conv(f"{tag}/5x5", c5, 5, pad=2)
        o5 = b.cur
        b.cur = src  # pooling branch: pool then 1x1 projection
        b.pool(f"{tag}/pool", 3, 1, 1)
        b.conv(f"{tag}/pool_proj", cp, 1)
        op_ = b.cur
        b.concat(f"{tag}/output", [o1, o3, o5, op_])

    inception("inception_3a", 64, 96, 128, 16, 32, 32)
    inception("inception_3b", 128, 128, 192, 32, 96, 64)
    b.pool("pool3/3x3_s2", 3, 2)
    inception("inception_4a", 192, 96, 208, 16, 48, 64)
    inception("inception_4b", 160, 112, 224, 24, 64, 64)
    inception("inception_4c", 128, 128, 256, 24, 64, 64)
    inception("inception_4d", 112, 144, 288, 32, 64, 64)
    inception("inception_4e", 256, 160, 320, 32, 128, 128)
    b.pool("pool4/3x3_s2", 3, 2)
    inception("inception_5a", 256, 160, 320, 32, 128, 128)
    inception("inception_5b", 384, 192, 384, 48, 128, 128)
    b.pool("pool5/7x7_s1", 0, 1, global_=True, avg=True)
    b.dropout("pool5/drop_7x7_s1", 0.4)
    b.conv("loss3/classifier-conv", num_classes, 1, relu=False)
    b.softmax()
    return b.done()


def build_mini(batch: int = 1, ysz: int = 32, xsz: int = 32,
               n_classes: int = 10) -> ConvPipe:
    """Tiny NiN-style all-conv net for fast CLI/harness tests (fills the
    small-test-model slot the reference populated with downloaded
    fc-to-conv-converted caffemodels)."""
    b = NetBuilder("mini", batch, 3, ysz, xsz)
    b.conv("conv1", 16, 5, 2, 2)
    b.conv("cccp1", 16, 1)
    b.pool("pool1", 3, 2)
    b.conv("conv2", 16, 3, 1, 1)
    b.dropout("drop")
    b.conv("fc-conv", n_classes, 1, relu=False)
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.softmax("prob")
    return b.done(seed=42)


MODEL_BUILDERS = {
    "mini": build_mini,
    "nin_imagenet_nopad": lambda **kw: build_nin(pad=False, **kw),
    "nin_imagenet": lambda **kw: build_nin(pad=True, **kw),
    "alexnet_ng_conv": build_alexnet_ng_conv,
    "squeezenet-1.0": build_squeezenet,
    "firenet-v0": build_firenet,
    "vgg16-conv": build_vgg16,
    "vgg-19": build_vgg19,
    "googlenet_conv": build_googlenet_conv,
    "googlenet_conv_no_lrn": lambda **kw: build_googlenet_conv(lrn=False, **kw),
    "googlenet_conv_lrn": lambda **kw: build_googlenet_conv(lrn=True, **kw),
    "firenet8-CE-0.125": lambda **kw: build_firenet8_ce(ce=0.125, **kw),
    "firenet8-CE-0.125-nofinalpad":
        lambda **kw: build_firenet8_ce(ce=0.125, final_pad=False, **kw),
    "resnet-50": lambda **kw: build_resnet(50, **kw),
    "resnet-101": lambda **kw: build_resnet(101, **kw),
    "resnet-152": lambda **kw: build_resnet(152, **kw),
}


# the port's models with grouped convs, which the JAX package's IR has not:
# apart from MODEL_BUILDERS, the JAX zoo's, whose plans both packages lower
# alike (tests/test_torch_sigs.py)
GROUPED_BUILDERS = {
    "resnext-101-64x4d": lambda **kw: build_resnext(101, 64, 4, **kw),
}


def build_model(name: str, **kw) -> ConvPipe:
    bld = MODEL_BUILDERS.get(name) or GROUPED_BUILDERS.get(name)
    if bld is None:
        known = sorted(MODEL_BUILDERS) + sorted(GROUPED_BUILDERS)
        raise RtErr(f"unknown model '{name}' (known: {','.join(known)})")
    return bld(**kw)
