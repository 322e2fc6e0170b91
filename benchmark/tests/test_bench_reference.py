"""The plain references: their shapes and flop counts against hand counts,
the same blobs as the port's nets, and their logits against the port's
plain CPU path on small inputs."""

import subprocess
import sys

import pytest
import torch

from benchmark import roofline, spec
from benchmark.reference import net_of
from benchmark.reference.graph import pool_out, total_flops


def cfg(name, hw=None):
    c = spec.load_cell({"resnet50": "resnet50-int8-b128",
                        "googlenet": "googlenet-bf16-b128"}[name]).config
    c = dict(c)
    if hw:
        c["input_chw"] = [3, hw, hw]
    return c


def resnet50_hand_flops():
    """2 x multiply-adds of ResNet-50 at 224x224, the stride of stages 3-5
    in the 1x1 branch2a, counted stage by stage."""
    f = 2 * 112 * 112 * 64 * 3 * 49                      # conv1
    cin, hw = 64, 56
    for width, reps, first_stride in ((64, 3, 1), (128, 4, 2),
                                      (256, 6, 2), (512, 3, 2)):
        out_hw = hw // first_stride
        for r in range(reps):
            f += 2 * out_hw * out_hw * width * cin            # branch2a
            f += 2 * out_hw * out_hw * width * width * 9      # branch2b
            f += 2 * out_hw * out_hw * 4 * width * width      # branch2c
            if r == 0:
                f += 2 * out_hw * out_hw * 4 * width * cin    # branch1
            cin = 4 * width
        hw = out_hw
    return f + 2 * 2048 * 1000


def googlenet_hand_flops():
    """2 x multiply-adds of GoogLeNet at 224x224 from the paper's Table 1."""
    f = 2 * 112 * 112 * 64 * 3 * 49 + 2 * 56 * 56 * 64 * 64 \
        + 2 * 56 * 56 * 192 * 64 * 9
    cin = 192
    for hw, (c1, c3r, c3, c5r, c5, cp) in (
            (28, (64, 96, 128, 16, 32, 32)),
            (28, (128, 128, 192, 32, 96, 64)),
            (14, (192, 96, 208, 16, 48, 64)),
            (14, (160, 112, 224, 24, 64, 64)),
            (14, (128, 128, 256, 24, 64, 64)),
            (14, (112, 144, 288, 32, 64, 64)),
            (14, (256, 160, 320, 32, 128, 128)),
            (7, (256, 160, 320, 32, 128, 128)),
            (7, (384, 192, 384, 48, 128, 128))):
        p = hw * hw * 2
        f += p * (cin * (c1 + c3r + c5r + cp) + c3r * c3 * 9 + c5r * c5 * 25)
        cin = c1 + c3 + c5 + cp
    return f + 2 * 1024 * 1000


def test_resnet50_shapes_and_flops():
    net = net_of(cfg("resnet50"))
    assert net.shapes["pool1"] == (64, 56, 56)
    assert net.shapes["res5c"] == (2048, 7, 7)
    assert net.shapes["fc1000-conv"] == (1000, 1, 1)
    assert len(net.convs()) == 54
    assert total_flops(net) == resnet50_hand_flops()
    assert 7.6e9 < total_flops(net) < 7.8e9


def test_googlenet_shapes_and_flops():
    net = net_of(cfg("googlenet"))
    assert net.shapes["pool2/3x3_s2"] == (192, 28, 28)
    assert net.shapes["inception_5b/output"] == (1024, 7, 7)
    assert len(net.convs()) == 58
    assert total_flops(net) == googlenet_hand_flops()
    assert 3.0e9 < total_flops(net) < 3.3e9


def test_caffe_pool_rule():
    p = {"k": 3, "stride": 2, "pad": 0}
    assert pool_out(112, p) == 56 and pool_out(14, p) == 7
    assert pool_out(5, {"k": 2, "stride": 2, "pad": 1}) == 3


def test_int8_sites_and_least_time():
    net = net_of(cfg("resnet50"))
    prec = spec.load_cell("resnet50-int8-b128").traffic["precision"]
    sites = roofline.site_precisions(net, prec)
    assert sum(p == "int8" for p in sites.values()) == 33
    pk = roofline.card_peaks("NVIDIA H100 80GB HBM3")
    fs = roofline.flop_seconds(net, prec, pk, 128)
    least = roofline.least_seconds(net, prec, pk, 128)
    assert 0 < fs <= least
    bf = roofline.flop_seconds(net, {"default": "bf16", "edges": "bf16"},
                               pk, 128)
    assert bf == pytest.approx(128 * total_flops(net) / 989e12)
    assert fs < bf
    assert roofline.card_peaks("Some Other GPU") is None


@pytest.mark.parametrize("name", ["resnet50", "googlenet"])
def test_reference_matches_the_ports_plain_cpu_path(name):
    """The port's engine at its plain f32 tune `()` on the CPU and the
    reference agree on small inputs: the reference describes the net the
    program runs, blob for blob."""
    from benchmark.program import Program
    from benchmark.reference.graph import run_reference
    from benchmark.weights import make_images, make_weights, preprocess
    c = cfg(name, hw=64)
    net = net_of(c)
    w = make_weights(net.weight_shapes(), c["weights"], 7, "cpu")
    tr = dict(spec.load_cell("googlenet-bf16-b128").traffic)
    tr["tune"] = "()"
    prog = Program(c, tr, {n: t.numpy() for n, t in w.items()}, 2, "cpu")
    u8 = make_images(2, (64, 64), tr["image"], 7, "t", "cpu")
    got = torch.from_numpy(prog.request(u8.numpy()))
    want = run_reference(net, preprocess(u8, tr["preproc"]), w)
    rel = (got - want).norm(dim=1) / want.norm(dim=1)
    assert rel.max() < 1e-4


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.graph, "
            "benchmark.reference, benchmark.check, benchmark.weights, "
            "benchmark.roofline; from benchmark.reference import net_of; "
            "from benchmark.spec import load_cell; "
            "[net_of(load_cell(w).config) for w in "
            "('resnet50-int8-b128', 'googlenet-bf16-b128')]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"boda_tpu_torch", "boda_tpu", "jax", "jaxlib"}


@pytest.mark.parametrize("w,nodes", [
    ("resnet50-bf16-b128", ["conv1", "pool1"]),
    ("googlenet-bf16-b128", ["conv1/7x7_s2", "pool1/3x3_s2"])])
def test_declared_precision_is_the_ports_bf16_rounding(w, nodes):
    """At the declared precision (bf16 operands and storage, float32 sums)
    the reference's first layers equal the port's bf16 CPU path bit for
    bit: the precision it holds the program to is the one the tune runs.
    (Deeper, the order of float32 sums moves a few bf16 roundings, and
    those spread.)"""
    import numpy as np

    from benchmark.program import Program
    from benchmark.reference.graph import DTYPES, fp32_exact, rounded
    from benchmark.weights import make_images, make_weights, preprocess
    cell = spec.load_cell(w)
    c = dict(cell.config, input_chw=[3, 64, 64])
    net, tr = net_of(c), cell.traffic
    wt = make_weights(net.weight_shapes(), c["weights"], 9, "cpu")
    prog = Program(c, tr, {n: t.numpy() for n, t in wt.items()}, 2, "cpu")
    u8 = make_images(2, (64, 64), tr["image"], 9, "t", "cpu")
    got = prog.eng.run_fwd({prog.data: prog._NDA(prog.wire, u8.numpy())},
                           nodes)
    edge = DTYPES[tr["precision"]["edges"]]
    operand = DTYPES[tr["precision"]["default"]]
    env = {net.data: rounded(preprocess(u8, tr["preproc"]), edge)}
    with torch.no_grad(), fp32_exact():
        for L in net.layers[:len(nodes)]:
            env[L.out] = rounded(net._layer(L, [env[n] for n in L.ins], wt,
                                            None, operand), edge)
    for n in nodes:
        want = env[n].numpy()
        have = np.asarray(got[n].v, np.float32).reshape(want.shape)
        assert np.array_equal(have, want), n
