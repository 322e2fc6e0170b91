"""ResNet-50 as deployed (He et al., arXiv:1512.03385; the deploy prototxt of
KaimingHe/deep-residual-networks): the plain reference of configuration
`resnet50`.

BatchNorm and Scale are folded into each conv's filter and bias, as a deploy
graph folds them, so every conv carries a bias. Stages 3-5 stride in their
first block's 1x1 `branch2a` and `branch1`, as the original Caffe model does.
Layer and blob names are the prototxt's (`res3a_branch2b`, `fc1000`), with the
classifier as a 1x1 conv named `fc1000-conv`.
"""

from __future__ import annotations

from .graph import Layer, Net

STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))


def build(cfg: dict) -> Net:
    c, h, w = cfg["input_chw"]
    L = [Layer("conv", "conv1", ["data"], "conv1",
               {"out": 64, "k": 7, "stride": 2, "pad": 3, "relu": True}),
         Layer("maxpool", "pool1", ["conv1"], "pool1",
               {"k": 3, "stride": 2, "pad": 0})]
    cur = "pool1"
    for s, (width, reps) in enumerate(STAGES, 2):
        for r in range(reps):
            tag = f"res{s}{chr(ord('a') + r)}"
            st = 2 if (r == 0 and s > 2) else 1

            def conv(name, src, out, k, stride, pad, relu):
                L.append(Layer("conv", name, [src], name,
                               {"out": out, "k": k, "stride": stride,
                                "pad": pad, "relu": relu}))
            conv(f"{tag}_branch2a", cur, width, 1, st, 0, True)
            conv(f"{tag}_branch2b", f"{tag}_branch2a", width, 3, 1, 1, True)
            conv(f"{tag}_branch2c", f"{tag}_branch2b", 4 * width, 1, 1, 0,
                 False)
            short = cur
            if r == 0:
                conv(f"{tag}_branch1", cur, 4 * width, 1, st, 0, False)
                short = f"{tag}_branch1"
            L.append(Layer("add", tag, [short, f"{tag}_branch2c"], tag,
                           {"relu": True}))
            cur = tag
    L.append(Layer("avgpool_global", "pool5", [cur], "pool5"))
    L.append(Layer("conv", "fc1000-conv", ["pool5"], "fc1000-conv",
                   {"out": cfg["num_classes"], "k": 1, "stride": 1, "pad": 0,
                    "relu": False}))
    return Net(L, (c, h, w), logits="fc1000-conv")
