"""GoogLeNet v1 (Szegedy et al., arXiv:1409.4842; BVLC's
`bvlc_googlenet/deploy.prototxt`): the plain reference of configuration
`googlenet`.

Both LRNs as published (n 5, alpha 1e-4, beta 0.75, k 1), nine inception
modules, the 7x7 average pool, dropout (the identity at inference) and the
1024 -> classes classifier as a 1x1 conv named `loss3/classifier-conv`. The
two auxiliary heads, which serve only training, are not part of the deploy
graph. Layer and blob names are the prototxt's.
"""

from __future__ import annotations

from .graph import Layer, Net

# (name, 1x1, 3x3 reduce, 3x3, 5x5 reduce, 5x5, pool proj), with a 3x3/s2
# max pool after 3b and 4e (the paper's Table 1)
INCEPTION = (("inception_3a", 64, 96, 128, 16, 32, 32),
             ("inception_3b", 128, 128, 192, 32, 96, 64),
             ("inception_4a", 192, 96, 208, 16, 48, 64),
             ("inception_4b", 160, 112, 224, 24, 64, 64),
             ("inception_4c", 128, 128, 256, 24, 64, 64),
             ("inception_4d", 112, 144, 288, 32, 64, 64),
             ("inception_4e", 256, 160, 320, 32, 128, 128),
             ("inception_5a", 256, 160, 320, 32, 128, 128),
             ("inception_5b", 384, 192, 384, 48, 128, 128))
POOL_AFTER = {"inception_3b": "pool3/3x3_s2", "inception_4e": "pool4/3x3_s2"}
LRN = {"n": 5, "alpha": 1e-4, "beta": 0.75, "k": 1.0}


def build(cfg: dict) -> Net:
    c, h, w = cfg["input_chw"]
    L = []

    def conv(name, src, out, k, stride=1, pad=0, relu=True):
        L.append(Layer("conv", name, [src], name,
                       {"out": out, "k": k, "stride": stride, "pad": pad,
                        "relu": relu}))
        return name

    def maxpool(name, src, k, stride, pad=0):
        L.append(Layer("maxpool", name, [src], name,
                       {"k": k, "stride": stride, "pad": pad}))
        return name

    def lrn(name, src):
        L.append(Layer("lrn", name, [src], name, dict(LRN)))
        return name

    cur = conv("conv1/7x7_s2", "data", 64, 7, 2, 3)
    cur = lrn("pool1/norm1", maxpool("pool1/3x3_s2", cur, 3, 2))
    cur = conv("conv2/3x3_reduce", cur, 64, 1)
    cur = lrn("conv2/norm2", conv("conv2/3x3", cur, 192, 3, 1, 1))
    cur = maxpool("pool2/3x3_s2", cur, 3, 2)
    for tag, c1, c3r, c3, c5r, c5, cp in INCEPTION:
        o1 = conv(f"{tag}/1x1", cur, c1, 1)
        o3 = conv(f"{tag}/3x3", conv(f"{tag}/3x3_reduce", cur, c3r, 1),
                  c3, 3, pad=1)
        o5 = conv(f"{tag}/5x5", conv(f"{tag}/5x5_reduce", cur, c5r, 1),
                  c5, 5, pad=2)
        op = conv(f"{tag}/pool_proj", maxpool(f"{tag}/pool", cur, 3, 1, 1),
                  cp, 1)
        L.append(Layer("concat", f"{tag}/output", [o1, o3, o5, op],
                       f"{tag}/output"))
        cur = f"{tag}/output"
        if tag in POOL_AFTER:
            cur = maxpool(POOL_AFTER[tag], cur, 3, 2)
    L.append(Layer("avgpool_global", "pool5/7x7_s1", [cur], "pool5/7x7_s1"))
    L.append(Layer("dropout", "pool5/drop_7x7_s1", ["pool5/7x7_s1"],
                   "pool5/drop_7x7_s1"))
    conv("loss3/classifier-conv", "pool5/drop_7x7_s1", cfg["num_classes"], 1,
         relu=False)
    return Net(L, (c, h, w), logits="loss3/classifier-conv")
