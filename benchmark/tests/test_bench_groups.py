"""Grouped convolutions in the plain reference and the yardstick: a grouped
conv against per-group convs of its channel slices, its filter, flops and
least time against hand counts, ResNeXt-101 (64x4d) against the paper's
count, and the three cells' flop and least-time figures pinned where every
conv is ungrouped."""

import math

import pytest
import torch
import torch.nn.functional as F

from benchmark import roofline, spec
from benchmark.reference import net_of
from benchmark.reference.graph import (Layer, Net, conv_flops,
                                       quantize_act, quantize_filter,
                                       rounded, run_reference, total_flops)
from benchmark.weights import make_weights

H100 = roofline.card_peaks("NVIDIA H100 80GB HBM3")
BF16 = {"default": "bf16", "edges": "bf16"}
MSRA = {"rule": "msra", "bias_std": 1.0}


def conv(name, src, out, k, stride=1, pad=0, relu=False, groups=1):
    return Layer("conv", name, [src], name,
                 {"out": out, "k": k, "stride": stride, "pad": pad,
                  "relu": relu, "groups": groups})


def one_conv(cin=8, out=12, g=4, k=3, stride=1, pad=1, hw=9):
    return Net([conv("c", "data", out, k, stride, pad, True, g)],
               (cin, hw, hw))


def per_group(x, wt, b, g, stride, pad):
    """The conv of each group's channel slices, concatenated: output block
    j from input block j alone."""
    ci, co = x.shape[1] // g, wt.shape[0] // g
    return torch.cat([F.conv2d(x[:, j * ci:(j + 1) * ci],
                               wt[j * co:(j + 1) * co],
                               None if b is None else b[j * co:(j + 1) * co],
                               stride, pad) for j in range(g)], dim=1)


def test_grouped_filter_shape_and_fan_in():
    net = one_conv(cin=8, out=12, g=4, k=3)
    assert net.weight_shapes() == [("c_filts", (12, 2, 3, 3), 2 * 9),
                                   ("c_biases", (12,), 0)]
    assert net.shapes["c"] == (12, 9, 9)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("how", ["f32", "bf16", "int8"])
def test_grouped_conv_is_the_per_group_convs(how, stride):
    net = one_conv(stride=stride)
    w = make_weights(net.weight_shapes(), MSRA, 3, "cpu")
    wt, b = w["c_filts"], w["c_biases"]
    x = torch.randn(2, 8, 9, 9, generator=torch.Generator().manual_seed(5))
    if how == "int8":
        got = net.forward(x, w, quant={"c": (8, None)})
        xq, s_act = quantize_act(x, 8, None)
        wq, s_w = quantize_filter(wt, 8)
        assert s_w.shape == (12,)
        want = per_group(xq, wq, None, 4, stride, 1) \
            * (s_act * s_w)[None, :, None, None] + b[None, :, None, None]
        # codes' sums of 18 products are whole numbers under 2^24: exact
        assert torch.equal(got, F.relu(want).flatten(1))
        return
    op = torch.bfloat16 if how == "bf16" else None
    with torch.no_grad():
        got = net._layer(net.layers[0], [rounded(x, op)], w, None, op)
    want = F.relu(per_group(rounded(x, op), rounded(wt, op), b, 4, stride,
                            1))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if how == "bf16":
        fwd = net.forward(x, w, prec=BF16).view_as(got)
        assert torch.equal(fwd, rounded(got, torch.bfloat16))


@pytest.mark.parametrize("c,hw", [(256, 56), (512, 28), (1024, 14),
                                  (2048, 7)])
def test_grouped_flops_and_least_time_by_hand(c, hw):
    """ResNeXt-101 (64x4d)'s grouped 3x3 of each stage: 64 groups of
    c / 64 channels. Bound by its bytes, not its operations."""
    net = one_conv(cin=c, out=c, g=64, k=3, hw=hw)
    L = net.layers[0]
    flops = 2 * c * hw * hw * (c // 64) * 9
    assert conv_flops(net, L) == flops
    nbytes = 128 * (c * hw * hw * 2 + c * hw * hw * 2) \
        + c * (c // 64) * 9 * 2 + c * 4
    t_ops, t_bytes = 128 * flops / 989e12, nbytes / 3.35e12
    assert roofline.layer_least_seconds(net, L, "bf16", "bf16", H100,
                                        128) == max(t_ops, t_bytes)
    assert t_bytes > 2 * t_ops
    assert roofline.least_seconds(net, BF16, H100, 128) == t_bytes


@pytest.mark.parametrize("cin,out", [(6, 8), (8, 6)])
def test_groups_that_do_not_divide_are_refused(cin, out):
    with pytest.raises(ValueError, match="odd_conv"):
        Net([conv("odd_conv", "data", out, 3, pad=1, groups=4)],
            (cin, 8, 8))


def resnext101_64x4d() -> Net:
    """ResNeXt-101 (64x4d) (Xie et al., arXiv:1611.05431): bottlenecks of
    widths 256/512/1024/2048 at 3/4/23/3 blocks, each 3x3 in 64 groups
    and carrying the stage's stride, outputs 256/512/1024/2048 after
    res2-res5, fc 1000 as a 1x1 conv."""
    L = [conv("conv1", "data", 64, 7, 2, 3, True),
         Layer("maxpool", "pool1", ["conv1"], "pool1",
               {"k": 3, "stride": 2, "pad": 0})]
    cur = "pool1"
    for s, (width, reps) in enumerate(((256, 3), (512, 4), (1024, 23),
                                       (2048, 3)), 2):
        out = 256 << (s - 2)
        for r in range(reps):
            tag, st = f"res{s}_{r}", 2 if (r == 0 and s > 2) else 1
            L += [conv(f"{tag}_a", cur, width, 1, relu=True),
                  conv(f"{tag}_b", f"{tag}_a", width, 3, st, 1, True, 64),
                  conv(f"{tag}_c", f"{tag}_b", out, 1)]
            short = cur
            if r == 0:
                L.append(conv(f"{tag}_proj", cur, out, 1, st))
                short = f"{tag}_proj"
            L.append(Layer("add", tag, [short, f"{tag}_c"], tag,
                           {"relu": True}))
            cur = tag
    L += [Layer("avgpool_global", "pool5", [cur], "pool5"),
          conv("fc1000-conv", "pool5", 1000, 1)]
    return Net(L, (3, 224, 224))


def test_resnext101_64x4d_flops_and_parameters():
    """15.5 G multiply-adds an image, as the paper gives; 83.35 M filter and
    bias values (BatchNorm folded into each conv)."""
    net = resnext101_64x4d()
    assert net.shapes["res5_2"] == (2048, 7, 7)
    assert total_flops(net) == 30920540160
    assert sum(math.prod(s) for _, s, _ in net.weight_shapes()) == 83353832


def test_resnext101_64x4d_least_time_by_layer():
    """At b128 bf16 the 33 grouped 3x3s, each bound by its bytes, take a
    quarter of the forward's least time (1.53 of 6.11 ms)."""
    net = resnext101_64x4d()
    grouped = [L for L in net.convs() if L.p["groups"] > 1]
    t = [roofline.layer_least_seconds(net, L, "bf16", "bf16", H100, 128)
         for L in grouped]
    assert len(grouped) == 33
    assert all(128 * conv_flops(net, L) / H100["bf16"] < ti / 2
               for L, ti in zip(grouped, t))
    least = roofline.least_seconds(net, BF16, H100, 128)
    assert math.fsum(t) == pytest.approx(1.5293e-3, rel=1e-4)
    assert least == pytest.approx(6.1076e-3, rel=1e-4)


def grouped_bottleneck(g: int) -> Net:
    return Net([conv("conv1", "data", 16, 3, pad=1, relu=True),
                conv("b_a", "conv1", 16, 1, relu=True),
                conv("b_b", "b_a", 16, 3, 2, 1, True, g),
                conv("b_c", "b_b", 32, 1),
                conv("b_proj", "conv1", 32, 1, 2),
                Layer("add", "b", ["b_proj", "b_c"], "b", {"relu": True}),
                Layer("avgpool_global", "pool", ["b"], "pool"),
                conv("fc", "pool", 10, 1)], (3, 16, 16))


def block_diagonal(wt: torch.Tensor, g: int) -> torch.Tensor:
    """A grouped filter (out, cin / g, k, k) as the ungrouped (out, cin, k,
    k) one that is zero outside each output block's input block."""
    out, ci = wt.shape[:2]
    full = wt.new_zeros(out, ci * g, *wt.shape[2:])
    co = out // g
    for j in range(g):
        full[j * co:(j + 1) * co, j * ci:(j + 1) * ci] = \
            wt[j * co:(j + 1) * co]
    return full


def test_a_grouped_bottleneck_runs_through_run_reference():
    """A net with a grouped, strided bottleneck gives, through
    run_reference on the CPU, the logits of the same net ungrouped with
    block-diagonal filters."""
    net = grouped_bottleneck(4)
    w = make_weights(net.weight_shapes(), MSRA, 11, "cpu")
    x = torch.randn(3, 3, 16, 16, generator=torch.Generator().manual_seed(2))
    got = run_reference(net, x, w, rows=2)
    assert got.shape == (3, 10)
    wide = dict(w, b_b_filts=block_diagonal(w["b_b_filts"], 4))
    want = run_reference(grouped_bottleneck(1), x, wide)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(run_reference(net, x, w, prec=BF16)).all()


# groups = 1: each cell's figures as the yardstick computed them before
# convs could be grouped (batch 128, "NVIDIA H100 80GB HBM3")
PINS = {
    "resnet50-int8-b128": (7715946496, 0.0006643039014169058,
                           0.0016437929979603737),
    "googlenet-bf16-b128": (3165343744, 0.000409670373338726,
                            0.0010744137741873442),
    "resnet50-bf16-b128": (7715946496, 0.0009986260379049546,
                           0.0019648117528756606),
}


@pytest.mark.parametrize("w", sorted(PINS))
def test_ungrouped_cells_read_as_before(w):
    cell = spec.load_cell(w)
    net, prec = net_of(cell.config), cell.traffic["precision"]
    assert not any("groups" in L.p for L in net.convs())
    flops, fs, least = PINS[w]
    assert total_flops(net) == flops
    assert roofline.flop_seconds(net, prec, H100, 128) == fs
    assert roofline.least_seconds(net, prec, H100, 128) == least
