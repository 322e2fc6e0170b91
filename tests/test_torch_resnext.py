"""ResNeXt-101 (64x4d) through the port's normal path on the CPU: the zoo's
`resnext-101-64x4d` at its published widths and depth (the input cut to
64x64, two images) built, lowered and run through make_engine and run_fwd,
against the benchmark's plain reference (benchmark/reference/
resnext101_64x4d.py) on the same seeded weights; and with each grouped 3x3's
groups rolled by one, which the comparison must fail.

Tolerances, the largest over the two images of |port - reference| / |reference|
over each row of logits (L2 norms):
- the f32 tune `()` against the float32 reference: 1e-4. Both sum the same
  float32 products in other orders; read 6e-7 here.
- the cell's tune (bf16 operands and edges, f32 sums: B7 and B8's plain
  versions) against the reference at that declared precision: 3e-2. The two
  round each of 101 layers' outputs to bf16 from sums taken in other
  orders, so a value may sit one bf16 step apart, and those steps spread
  down the depth; read 6.8-6.9e-3 here over two seeds. Rolling the groups
  reads 0.64-0.73, twenty times the tolerance.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from benchmark.program import Program
from benchmark.reference import net_of
from benchmark.reference.graph import run_reference
from benchmark.weights import make_images, make_weights, preprocess
from boda_tpu_torch.engine.lower import lower_pipe
from boda_tpu_torch.models.zoo import MODEL_BUILDERS, build_model
from boda_tpu_torch.ops.cnn_variants import make_op_tune

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" /
                     "resnext101_64x4d.json").read_text())
TRAFFIC = json.loads((ROOT / "benchmark" / "traffic" /
                      "b128-bf16.json").read_text())
CELL_TUNE = TRAFFIC["tune"]
SEED = 2 ** 35 + 3
HW = 64


@pytest.fixture(scope="module")
def small():
    """The configuration at 64x64, its reference net, seeded weights and
    two images (u8 and preprocessed)."""
    cfg = dict(CONFIG, input_chw=[3, HW, HW])
    net = net_of(cfg)
    w = make_weights(net.weight_shapes(), cfg["weights"], SEED, "cpu")
    u8 = make_images(2, (HW, HW), TRAFFIC["image"], SEED, "t", "cpu")
    return cfg, net, w, u8, preprocess(u8, TRAFFIC["preproc"])


def _port(cfg, w, u8, tune):
    tr = dict(TRAFFIC, tune=tune)
    prog = Program(cfg, tr, {n: t.numpy() for n, t in w.items()}, 2, "cpu")
    return prog, torch.from_numpy(prog.request(u8.numpy()))


def _rel(got, want) -> float:
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


def test_the_zoo_builder_is_the_published_model():
    """3/4/23/3 blocks, 105 convs, the 33 _branch2b 3x3s in 64 groups
    carrying the stride, 30.92 GFLOP an image at 224x224 (the paper's
    15.5 G multiply-adds) and 83.35 M values; every other conv's sig and
    plan step as ResNet's, with no groups."""
    assert "resnext-101-64x4d" not in MODEL_BUILDERS  # the JAX zoo's names
    pipe = build_model("resnext-101-64x4d", batch=1)
    convs = [op for op in pipe.ops.values() if op.type == "Convolution"]
    grouped = [op for op in convs if op.get_u32_or("groups", 1) > 1]
    assert len(convs) == 105 and len(grouped) == 33
    assert all(op.tag.endswith("_branch2b") and op.get_u32("groups") == 64
               for op in grouped)
    assert [op.tag for op in grouped if op.stride().y == 2] == \
        ["res3a_branch2b", "res4a_branch2b", "res5a_branch2b"]
    assert not any(op.stride().y == 2 for op in convs
                   if op.tag.endswith("_branch2a"))
    assert pipe.must_get_node("res4b22_branch2b_filts").dims.shape == \
        (1024, 16, 3, 3)
    assert pipe.must_get_node("res5c").dims.shape == (1, 2048, 7, 7)
    assert pipe.total_flops_and_bytes()[0] == 30920540160
    assert sum(v.v.size for v in pipe.op_params.values()) == 83353832
    plan = lower_pipe(pipe, make_op_tune(CELL_TUNE), fused_storage=True)
    steps = [s for s in plan.steps if s.func_name in ("xla_conv",
                                                      "xla_conv2")]
    assert len(steps) == 104  # res2a's branch2a and branch1 as one step
    assert sum("groups" in str(s.sig.to_lexp()) for s in steps) == 33


def test_the_reference_names_the_zoos_blobs(small):
    """The check Program.__init__ makes: the same weight names and
    shapes."""
    cfg, net, w, _u8, _x = small
    pipe = build_model(cfg["zoo_builder"], batch=2, ysz=HW, xsz=HW)
    assert {n: tuple(v.dims.shape) for n, v in pipe.op_params.items()} == \
        {n: tuple(t.shape) for n, t in w.items()}


@pytest.mark.parametrize("tune,tol,routes", [
    ("()", 1e-4, {"vendor": 34}),   # the 33 grouped and conv1 (s2d_conv)
    (CELL_TUNE, 3e-2, {"b7": 71, "b8": 33})])
def test_the_port_agrees_with_the_reference(small, tune, tol, routes):
    cfg, net, w, u8, x = small
    prog, got = _port(cfg, w, u8, tune)
    prec = None if tune == "()" else TRAFFIC["precision"]
    want = run_reference(net, x, w, None, prec)
    assert got.shape == want.shape == (2, 1000)
    assert _rel(got, want) <= tol
    have = {}
    for r in prog.eng.fwd.conv_routes.values():
        have[r] = have.get(r, 0) + 1
    assert {k: v for k, v in have.items() if k in routes} == routes


def test_rolled_groups_fail_the_comparison(small):
    """Each grouped 3x3's filter and bias rolled by one group (output block
    j computed with group j - 1's filter over input block j): the cell's
    tune reads far outside the tolerance, so the comparison sees group
    order."""
    cfg, net, w, u8, x = small
    rolled = {n: t.roll(t.shape[0] // 64, 0)
              if "_branch2b_" in n else t for n, t in w.items()}
    _prog, got = _port(cfg, rolled, u8, CELL_TUNE)
    want = run_reference(net, x, w, None, TRAFFIC["precision"])
    assert _rel(got, want) > 10 * 3e-2
    assert math.isfinite(_rel(got, want))
