"""ResNeXt-101 (64x4d) (Xie et al., arXiv:1611.05431; the resnext_101_64x4d
ImageNet model of facebookresearch/ResNeXt): the plain reference of
configuration `resnext101_64x4d`.

ResNet-101's stem, depth (3/4/23/3 blocks) and head, with aggregated
bottlenecks: a 1x1 to 64 groups x 4 channels x 2^(stage - 2) (256 / 512 /
1024 / 2048), then a 3x3 in 64 groups that carries the stage's stride, then a
1x1 to the stage's output (256 / 512 / 1024 / 2048); the first block of each
stage projects its shortcut by a strided 1x1. BatchNorm is folded into each
conv's filter and bias, as a deploy graph folds it, so every conv carries a
bias. Layer and blob names are those of the Caffe ResNet-101 deploy graph
(`res4b22_branch2b`), with the classifier as a 1x1 conv named `fc1000-conv`.
"""

from __future__ import annotations

from .graph import Layer, Net

CARDINALITY = 64
WIDTH = 4
BLOCKS = (3, 4, 23, 3)


def build(cfg: dict) -> Net:
    c, h, w = cfg["input_chw"]
    L = [Layer("conv", "conv1", ["data"], "conv1",
               {"out": 64, "k": 7, "stride": 2, "pad": 3, "relu": True}),
         Layer("maxpool", "pool1", ["conv1"], "pool1",
               {"k": 3, "stride": 2, "pad": 0})]

    def conv(name, src, out, k, stride, pad, relu, groups=1):
        p = {"out": out, "k": k, "stride": stride, "pad": pad, "relu": relu}
        if groups > 1:
            p["groups"] = groups
        L.append(Layer("conv", name, [src], name, p))

    cur = "pool1"
    for s, reps in enumerate(BLOCKS, 2):
        inner = CARDINALITY * WIDTH << (s - 2)
        out = 256 << (s - 2)
        for r in range(reps):
            tag = f"res{s}{chr(ord('a') + r)}" if reps <= 3 else \
                (f"res{s}a" if r == 0 else f"res{s}b{r}")
            st = 2 if (r == 0 and s > 2) else 1
            conv(f"{tag}_branch2a", cur, inner, 1, 1, 0, True)
            conv(f"{tag}_branch2b", f"{tag}_branch2a", inner, 3, st, 1, True,
                 CARDINALITY)
            conv(f"{tag}_branch2c", f"{tag}_branch2b", out, 1, 1, 0, False)
            short = cur
            if r == 0:
                conv(f"{tag}_branch1", cur, out, 1, st, 0, False)
                short = f"{tag}_branch1"
            L.append(Layer("add", tag, [short, f"{tag}_branch2c"], tag,
                           {"relu": True}))
            cur = tag
    L.append(Layer("avgpool_global", "pool5", [cur], "pool5"))
    L.append(Layer("conv", "fc1000-conv", ["pool5"], "fc1000-conv",
                   {"out": cfg["num_classes"], "k": 1, "stride": 1, "pad": 0,
                    "relu": False}))
    return Net(L, (c, h, w), logits="fc1000-conv")
