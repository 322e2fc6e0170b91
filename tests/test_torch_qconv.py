"""The int8 half of the port: kernel B6's module (ops/cuda/qconv.py), the
int8 forms of `xla_conv` and `xla_conv2` on it, the selective-int8 preset
(tune/presets.py), TorchFwd's op_tunes_pat and act_scales_fn,
plan_mixed_peak, and the preset through both engines, against the JAX
package on the CPU (its XLA int8 conv, as tests/test_quant8.py runs it), on
the same seeded numpy inputs.

Tolerances: int8 codes, int8 outputs and the f32 and bf16 outputs of the
int8 forms are held bit-equal to the JAX template (the int32 sums are
exact, and XLA on the CPU rounds every f32 op as the port does: no
multiply-add is contracted); the calibration twin at relative 1e-5 (the
float forwards of the two engines sum in other orders); a small net's
nodes under the preset through both engines at mrd 5e-3 (the bf16
mrd_toler), its int8 steps bit-equal; ResNet-50's logits under the preset
through both engines at mrd 5e-2 (the ResNet-50 test says why); the
trained-weights gate at tests/test_quant8.py's own thresholds.
"""

import contextlib
import io
import re
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.core.dims import NDA as JNDA
from boda_tpu.core.dims import Dims as JDims
from boda_tpu.engine import iface as jiface
from boda_tpu.engine.lower import _q8_weight
from boda_tpu.engine.lower import lower_pipe as jlower_pipe
from boda_tpu.models.zoo import build_model as jbuild_model
from boda_tpu.ops.cnn_variants import make_op_tune as jmake_op_tune
from boda_tpu.ops.pallas.conv import _quantize_conv_operands
from boda_tpu.ops.pallas.conv import make_conv_op as jmake_conv_op
from boda_tpu.ops.registry import get_template as jget_template
from boda_tpu.tune import opinfo as jopinfo
from boda_tpu.tune import presets as jpresets
from boda_tpu_torch.core.digest import nda_digest
from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.has_main import create_and_run_has_main
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.engine.lower import lower_pipe
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.cnn_variants import make_op_tune
from boda_tpu_torch.ops.cuda import qconv as qc
from boda_tpu_torch.ops.cuda.util import copy_width
from boda_tpu_torch.ops.op_base import OpBase
from boda_tpu_torch.ops.registry import get_template
from boda_tpu_torch.testing.comp import comp_digests
from boda_tpu_torch.tune import opinfo, presets

from tests.test_torch_conv2 import JAX, PORT

DATA = Path(__file__).parent / "data"
HEADLINE = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"
SCALES = {"trained": DATA / "resnet50-shapes40-int8-scales.lexp",
          "zoo": DATA / "resnet50-b128-int8-scales.lexp"}


def _port_op(op):
    """The port's copy of a JAX op sig, through its lexp text."""
    return OpBase.from_lexp(str(op.to_lexp()))


# ------------------------------------------------------ xla_conv int8 forms

# name -> (n, cin, h, w, cout, k, stride, pad, relu)
SHAPES = {"3x3-pad1-c32": (2, 32, 8, 8, 48, 3, 1, 1, True),
          "1x1-s2-c16": (2, 16, 8, 8, 32, 1, 2, 0, False),
          "3x3-s2-c24": (2, 24, 8, 8, 32, 3, 2, 1, True)}
# name -> (storage, prequant_w, static act scale): storage nchw (f32), nhwc
# with f32 edges, or nhwc with bf16 edges under prec=bf16
FORMS = {"nhwc-bf16-prequant-static": ("nhwc-bf16", True, True),
         "nhwc-bf16-prequant-dynamic": ("nhwc-bf16", True, False),
         "nhwc-f32-prequant-static": ("nhwc-f32", True, True),
         "nhwc-bf16-inprogram-static": ("nhwc-bf16", False, True),
         "nhwc-bf16-inprogram-dynamic": ("nhwc-bf16", False, False),
         "nchw-inprogram-static": ("nchw", False, True),
         "nchw-inprogram-dynamic": ("nchw", False, False),
         "nchw-prequant-static": ("nchw", True, True),
         "nchw-prequant-dynamic": ("nchw", True, False)}
STORAGE = {"nchw": {}, "nhwc-f32": {"io_layout": "nhwc"},
           "nhwc-bf16": {"prec": "bf16", "io_layout": "nhwc",
                         "edge_prec": "bf16"}}


def _int8_op(shape, storage, prequant, act_absmax=0.0, quant8=True,
             in_q8=False, out_absmax=0.0):
    """A JAX xla_conv sig in one of the int8 forms the lowering gives it."""
    n, cin, h, w, cout, k, s, p, relu = SHAPES[shape]
    op = jmake_conv_op(n, cin, h, w, cout, k, k, s, s, p, p, relu=relu)
    if quant8:
        op.set_u32("quant8", 1)
    if prequant:
        op.set_u32("prequant_w", 1)
        op.set_dims("filts_scale", JDims.make(out_chan=cout))
    if act_absmax:
        op.nda_vals["act_scale"] = JNDA.scalar(act_absmax, "float")
    if in_q8:
        op.set_u32("in_q8", 1)
    if out_absmax:
        op.set_u32("out_q8", 1)
        op.nda_vals["out_scale"] = JNDA.scalar(out_absmax, "float")
    op.str_vals.update(STORAGE[storage])
    return op


def _inputs(shape, seed=0):
    n, cin, h, w, cout, k, *_ = SHAPES[shape]
    rng = np.random.RandomState(seed)
    x = rng.randn(n, cin, h, w).astype(np.float32)
    wts = (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)) \
        .astype(np.float32)
    b = rng.randn(cout).astype(np.float32) * 0.5
    return x, wts, b


def _run_both(op, x, wargs, storage):
    """(JAX template output, port template output) as f32 numpy, each
    built from the same sig on the same operands (x logical NCHW f32, in
    the storage form the sig names)."""
    nhwc = storage != "nchw"
    xs = x.transpose(0, 2, 3, 1).copy() if nhwc and x.ndim == 4 else x
    jt = jget_template("xla_conv")
    jrfs = jt.check_args(op)
    bf16 = storage == "nhwc-bf16" and xs.dtype == np.float32
    jx = jnp.asarray(xs).astype(jnp.bfloat16) if bf16 else xs
    want = np.asarray(jt.build(jrfs)(jx, *wargs))
    pt = get_template("xla_conv")
    rfs = pt.check_args(_port_op(op))
    assert str(rfs) == str(jrfs)
    tx = torch.from_numpy(xs)
    got = pt.build(rfs)(tx.bfloat16() if bf16 else tx,
                        *[torch.from_numpy(np.asarray(a)) for a in wargs])
    return want, got


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("form", list(FORMS))
def test_xla_conv_int8_forms_match_jax(form, shape):
    storage, prequant, static = FORMS[form]
    x, wts, b = _inputs(shape)
    # a static scale that clips the largest values, as calibration on other
    # inputs does
    act_absmax = float(np.float32(0.8 * np.abs(x).max())) if static else 0.0
    op = _int8_op(shape, storage, prequant, act_absmax)
    wargs = (*_q8_weight(wts), b) if prequant else (wts, b)
    want, got = _run_both(op, x, wargs, storage)
    assert got.dtype == (torch.bfloat16 if storage == "nhwc-bf16"
                         else torch.float32)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_xla_conv_in_q8_matches_jax(shape):
    # the input arrives int8 at the static act_scale (an int8 edge's
    # reader): the activation quantize is skipped
    x, wts, b = _inputs(shape, seed=1)
    xq = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
    op = _int8_op(shape, "nhwc-bf16", True, 3.25, in_q8=True)
    want, got = _run_both(op, xq, (*_q8_weight(wts), b), "nhwc-bf16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("quant8", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_xla_conv_out_q8_matches_jax(shape, quant8):
    # an int8 edge's producer: the int8 conv (static, prequantized), or a
    # float vendor conv under prec=bf16 (the edge's producer need only be an
    # xla_conv), storing int8 at out_scale
    x, wts, b = _inputs(shape, seed=2)
    if not quant8:
        # bf16-exact weights: the JAX conv keeps an f32 weight as it is,
        # the port rounds it to the compute dtype (test_torch_conv.py)
        wts = torch.from_numpy(wts).bfloat16().float().numpy()
    op = _int8_op(shape, "nhwc-bf16", quant8, 3.0 if quant8 else 0.0,
                  quant8=quant8, out_absmax=1.75)
    wargs = (*_q8_weight(wts), b) if quant8 else (wts, b)
    want, got = _run_both(op, x, wargs, "nhwc-bf16")
    assert got.dtype == torch.int8 and want.dtype == np.int8
    assert np.abs(want).max() == 127      # some values clip
    np.testing.assert_array_equal(got.numpy(), want)


def test_xla_conv_refuses_int8_forms_the_lowering_never_makes():
    pt = get_template("xla_conv")
    for op, what in (
            (_int8_op("1x1-s2-c16", "nchw", True, 2.0, out_absmax=1.0),
             "out_q8 needs the storage-NHWC form"),
            (_int8_op("1x1-s2-c16", "nhwc-bf16", False, 2.0, in_q8=True),
             "in_q8 needs quant8, prequant_w"),
            (_int8_op("1x1-s2-c16", "nhwc-bf16", True, 0.0, in_q8=True),
             "in_q8 needs quant8, prequant_w and a static")):
        with pytest.raises(RtErr, match=what):
            pt.build(pt.check_args(_port_op(op)))


# ------------------------------------------------------ the quantize

def _jax_act_q(x, act_absmax):
    """The activation half of _quantize_conv_operands: (xq, s_act), the
    latter read off the combined scale with a weight whose scale is 1."""
    w = np.full((1, 1, 1, 1), 127.0, np.float32)
    xq, _wq, sc = _quantize_conv_operands(jnp.asarray(x), jnp.asarray(w),
                                          (0, 1, 2), act_absmax)
    return np.asarray(xq), np.asarray(sc).reshape(-1)[0]


HALF_WAY = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 125.5, 126.5, 127.5,
                     -126.5, 300.0, -300.0, 0.0, 3.0], np.float32)


@pytest.mark.parametrize("scale", ["static", "dynamic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quantize_plain_is_the_jax_activation_quantize(scale, dtype):
    # values half-way between two codes round to the even one; past 127.5
    # they clip. Static: act_absmax 127 gives s_act = 1 exactly; dynamic:
    # max |x| = 300 gives 300/127 + 1e-30, so x is scaled to put its values
    # on the same half-way points
    if scale == "static":
        x, absmax = HALF_WAY, 127.0
    else:
        s = np.float32(np.float32(300.0) / np.float32(127.0)
                       + np.float32(1e-30))
        x, absmax = (HALF_WAY * s).astype(np.float32), 0.0
    x = torch.from_numpy(x).to(dtype).float().numpy()
    want_q, want_s = _jax_act_q(x, absmax)
    got_q, got_s = qc.act_quantize_plain(torch.from_numpy(x).to(dtype),
                                         absmax)
    assert got_q.dtype == torch.int8 and got_s.shape == (1,)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    assert got_s.item() == want_s
    if scale == "static" and dtype == torch.float32:
        assert got_q.tolist() == [0, 2, 2, 0, -2, -2, 126, 126, 127, -126,
                                  127, -127, 0, 3]


def test_static_scale_is_the_rounded_quotient_not_a_reciprocal_product():
    # float32(a / 127.0) as the JAX template takes it (for an f32 a the
    # same as one IEEE f32 division, what the kernel's quantize gets from
    # the host); a product with the reciprocal, which torch on a card makes
    # of a division by a Python number, differs by an ulp for some a and
    # moves codes at the boundaries
    a = next(float(np.float32(v)) for v in np.linspace(0.5, 50, 4001)
             if np.float32(np.float32(v) * np.float32(1 / 127.0))
             != np.float32(float(np.float32(v)) / 127.0))
    x = np.linspace(-a, a, 999).astype(np.float32)
    want_q, want_s = _jax_act_q(x, a)
    got_q, got_s = qc.act_quantize_plain(torch.from_numpy(x), a)
    assert got_s.item() == want_s == np.float32(a / 127.0) \
        == qc.static_act_scale(a)
    assert got_s.item() != np.float32(np.float32(a) * np.float32(1 / 127.0))
    np.testing.assert_array_equal(got_q.numpy(), want_q)


def test_quantize_filter_is_the_jax_weight_quantize():
    _x, wts, _b = _inputs("3x3-pad1-c32")
    wq, sw = qc.quantize_filter(torch.from_numpy(wts))
    want_q, want_s = _q8_weight(wts)
    np.testing.assert_array_equal(wq.numpy(), want_q)
    np.testing.assert_array_equal(sw.numpy(), want_s)


# ------------------------------------------------------ the kernel's module

def test_qconv_plain_sums_exactly_and_applies_the_epilogue_in_f32():
    rng = np.random.RandomState(4)
    n, H, W, C, oc, k = 2, 9, 7, 24, 40, 3
    xq = rng.randint(-127, 128, (n, H, W, C)).astype(np.int8)
    wq = rng.randint(-127, 128, (oc, k, k, C)).astype(np.int8)
    sws = (rng.rand(oc) * 1e-3).astype(np.float32)
    b = rng.randn(oc).astype(np.float32)
    s_act = np.float32(0.0371)
    got = qc.qconv_plain(torch.from_numpy(xq), torch.from_numpy(wq),
                         torch.tensor([s_act]), torch.from_numpy(sws),
                         torch.from_numpy(b), (2, 2), (1, 1), True).numpy()
    xp = np.pad(xq.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    oy, ox = (H + 2 - k) // 2 + 1, (W + 2 - k) // 2 + 1
    acc = np.zeros((n, oy, ox, oc), np.int64)
    for yy in range(k):
        for xx in range(k):
            win = xp[:, yy:yy + 2 * (oy - 1) + 1:2, xx:xx + 2 * (ox - 1) + 1:2]
            acc += np.einsum("nhwc,oc->nhwo", win,
                             wq[:, yy, xx].astype(np.int64))
    want = np.maximum(acc.astype(np.float32) * (s_act * sws) + b, 0)
    np.testing.assert_array_equal(got, want)
    # the int8 store of an edge, at float32(127 / out_absmax)
    q8 = qc.qconv_plain(torch.from_numpy(xq), torch.from_numpy(wq),
                        torch.tensor([s_act]), torch.from_numpy(sws),
                        torch.from_numpy(b), (2, 2), (1, 1), True,
                        torch.int8, 0.4).numpy()
    np.testing.assert_array_equal(q8, np.clip(np.round(
        want * np.float32(127.0 / 0.4)), -127, 127).astype(np.int8))


def test_qconv_plan_and_refusals():
    # channels in whole 16-byte copies, B by TMA; 128 x 128 tiles of 128-byte
    # K chunks; a grid of whole waves and too many tiles in its last takes
    # no K split
    p = qc.qconv_plan(32, 14, 14, 1024, 2560, 1, 1, (2, 2), (0, 0), 132)
    assert (p.copy, p.tma_a, p.tma_b, p.chunks, p.splits, p.full) == \
        (16, False, True, 8, 1, 13 * 20)
    assert p.blocks == 13 * 20 and p.grid == 132
    # C = 24: 8-byte copies of A and B, no TMA
    p = qc.qconv_plan(2, 8, 8, 24, 32, 3, 3, (1, 1), (1, 1), 132)
    assert (p.copy, p.copy_b, p.tma_a, p.tma_b) == (8, 8, False, False)
    xq = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    wq = torch.zeros(8, 3, 3, 16, dtype=torch.int8)
    sws, one = torch.ones(8), torch.ones(1)
    with pytest.raises(RtErr, match="int8 output needs out_absmax"):
        qc.qconv(xq, wq, one, sws, out_dtype=torch.int8)
    with pytest.raises(RtErr, match="channels"):
        qc.qconv(xq, wq[..., :8].contiguous(), one, sws)
    big = torch.zeros(1, 3, 3, 14800, dtype=torch.int8)
    with pytest.raises(RtErr, match="could overflow the int32"):
        qc.qconv(big, torch.zeros(1, 3, 3, 14800, dtype=torch.int8), one,
                 torch.ones(1))
    # one form of s_act: an f32 [1] tensor, never a Python number
    with pytest.raises(RtErr, match="s_act: expected a torch.Tensor"):
        qc.qconv(xq, wq, 1.0, sws)
    with pytest.raises(RtErr, match="f32 or bf16"):
        qc.act_quantize(xq)


def test_plain_versions_count_no_launch():
    before = (qc.qconv.launches, qc.act_quantize.launches)
    x = torch.randn(1, 4, 4, 16)
    xq, s = qc.act_quantize(x)
    qc.qconv(xq, torch.ones(8, 1, 1, 16, dtype=torch.int8), s, torch.ones(8))
    assert (qc.qconv.launches, qc.act_quantize.launches) == before


# the ResNet-50 shapes B6 runs at batch 32: (label, n, H, C, oc, k, s, p);
# forward convs as the int8 preset gives them, and the four weight
# gradients of the grad_q8 preset as wgrad_q8 hands them over (x as [I, H,
# W, N], the cotangent as an [O, OH, OW, N] filter, the output [I, k, k, O])
FWD_B32 = [("res3 3x3", 32, 28, 128, 128, 3, 1, 1),
           ("res4a pair", 32, 28, 512, 1280, 1, 2, 0),
           ("res4 3x3", 32, 14, 256, 256, 3, 1, 1),
           ("res4 1x1 256->1024", 32, 14, 256, 1024, 1, 1, 0),
           ("res4 1x1 1024->256", 32, 14, 1024, 256, 1, 1, 0),
           ("res5a pair", 32, 14, 1024, 2560, 1, 2, 0),
           ("res5 3x3", 32, 7, 512, 512, 3, 1, 1),
           ("res5 1x1 512->2048", 32, 7, 512, 2048, 1, 1, 0),
           ("res5 1x1 2048->512", 32, 7, 2048, 512, 1, 1, 0)]
WGRAD_B32 = [("wgrad res3 3x3", 128, 28, 32, 128, 28, 1, 1),
             ("wgrad res4 3x3", 256, 14, 32, 256, 14, 1, 1),
             ("wgrad res5 3x3", 512, 7, 32, 512, 7, 1, 1),
             ("wgrad res5 1x1", 512, 7, 32, 2048, 7, 1, 0)]


def _plan(case, sms=132):
    _label, n, H, C, oc, k, s, p = case
    return qc.qconv_plan(n, H, H, C, oc, k, k, (s, s), (p, p), sms)


@pytest.mark.parametrize("case", FWD_B32 + WGRAD_B32, ids=lambda c: c[0])
def test_qconv_plan_splits_where_the_tiles_do_not_fill_the_card(case):
    plan = _plan(case)
    label = case[0]
    tiles_n = -(-case[4] // 128)
    units = plan.full + (plan.blocks - plan.full) * plan.splits
    # the card's 132 SMs each walk one unit (a tile, or a K range of one)
    # at a time
    assert plan.grid == min(units, 132)
    if plan.splits == 1:
        assert plan.full == plan.blocks
    elif plan.blocks < 132:
        # fewer tiles than SMs: every tile split, one wave of units
        assert plan.full == 0 and units <= 132
    else:
        # the full waves' tiles whole, the last wave's split into one wave
        assert plan.full == plan.blocks // 132 * 132 // tiles_n * tiles_n
        assert plan.full % tiles_n == 0 \
            and (plan.blocks - plan.full) * plan.splits <= 132
    # res5 3x3 (52 tiles of 36 chunks), res5's 2048->512 (52 of 16) and the
    # weight gradients with fewer tiles than SMs (9 tiles of 196 chunks, 36
    # of 49, 64 of 13) split every tile; res3 3x3 (196 tiles) and the res5
    # 3x3 gradient (144) split their last wave's 64 and 12; the 98-tile
    # res4 sites would take a second wave of units, and the other sites'
    # last waves are too many tiles or too few chunks to split
    split = {"res5 3x3": (2, 0), "res5 1x1 2048->512": (2, 0),
             "wgrad res3 3x3": (14, 0), "wgrad res4 3x3": (3, 0),
             "wgrad res5 1x1": (2, 0), "res3 3x3": (2, 132),
             "wgrad res5 3x3": (3, 132)}
    assert (plan.splits, plan.full) == split.get(label, (1, plan.blocks))
    if plan.splits > 1:
        assert plan.chunks // plan.splits >= 4
    # the filter by TMA at every ResNet-50 site; A by TMA at the 1x1
    # stride-1 convs (a row-major [M, C] matrix), else in 16-byte copies
    assert (plan.copy, plan.tma_b) == (16, True)
    _label, _n, _H, _C, _oc, k, st, p = case
    assert plan.tma_a == (k == 1 and st == 1 and p == 0)


def test_qconv_plan_leaves_full_waves_whole():
    # at batch 128 every site of the preset gives at least a tile per SM:
    # no tile of a full wave is split, and a last wave is split only where
    # its split units fit one wave (res5a's 60 tiles, res5's 64)
    split = {}
    for case in FWD_B32:
        label, _n, *rest = case
        plan = _plan((label, 128, *rest))
        assert plan.blocks >= 132 and plan.grid == 132, label
        assert plan.full >= plan.blocks // 132 * 132 - 20, label
        if plan.splits > 1:
            split[label] = (plan.blocks - plan.full, plan.splits)
    assert split == {"res5a pair": (60, 2), "res5 3x3": (64, 2),
                     "res5 1x1 2048->512": (64, 2)}
    # and fewer SMs fill sooner: res5 3x3 at b32 on 26 SMs (two waves)
    plan = _plan(FWD_B32[6], sms=26)
    assert (plan.full, plan.splits) == (plan.blocks, 1)
    # a lone tile of a K just under K_MAX splits into one unit per SM
    plan = qc.qconv_plan(1, 2, 2, 133120, 64, 1, 1, (1, 1), (0, 0), 132)
    assert (plan.blocks, plan.chunks, plan.splits, plan.full) \
        == (1, 1040, 132, 0)


@pytest.mark.parametrize("chunks", [1, 2, 9, 13, 36, 49, 196, 1040])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 7, 8, 16])
def test_split_ranges_cover_k_exactly_once(chunks, splits):
    if splits > chunks:
        return
    ranges = qc.split_ranges(chunks, splits)
    assert len(ranges) == splits
    assert [r[0] for r in ranges[1:]] == [r[1] for r in ranges[:-1]]
    assert ranges[0][0] == 0 and ranges[-1][1] == chunks
    sizes = [b - a for a, b in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("C, width", [(64, 16), (24, 8), (20, 4), (3, 1),
                                      (16, 16), (40, 8), (12, 4)])
def test_copy_width_follows_the_channels(C, width):
    plan = qc.qconv_plan(2, 9, 9, C, 40, 3, 3, (1, 1), (1, 1), 132)
    assert plan.copy == width == copy_width(C, 0, qc.COPY_WIDTHS)
    # B's rows are ky*kx*C long: 16-byte rows go by TMA
    assert plan.copy_b == copy_width(9 * C, 0, qc.COPY_WIDTHS)
    assert plan.tma_b == (plan.copy_b == 16)
    # a misaligned operand narrows the copy
    assert copy_width(C, 4, qc.COPY_WIDTHS) == min(width, 4)


def _split_sums(xq, wq, stride, pad, ranges, chunk=128):
    """The conv of int8 xq and wq as int64 partial sums over the K ranges
    (chunks of 128 int8 values of the tap-major, channel-minor K), added:
    the design's exact int32 split-K on the CPU."""
    n, H, W, C = xq.shape
    oc, ky, kx, _ = wq.shape
    (sy, sx), (py, px) = stride, pad
    oy, ox = (H + 2 * py - ky) // sy + 1, (W + 2 * px - kx) // sx + 1
    xp = np.pad(xq.astype(np.int64), ((0, 0), (py, py), (px, px), (0, 0)))
    cols = np.concatenate([xp[:, yy:yy + (oy - 1) * sy + 1:sy,
                              xx:xx + (ox - 1) * sx + 1:sx, :]
                           for yy in range(ky) for xx in range(kx)], axis=3)
    wk = wq.reshape(oc, -1).astype(np.int64)
    total = np.zeros((n, oy, ox, oc), np.int64)
    for kc0, kc1 in ranges:
        k0, k1 = kc0 * chunk, min(kc1 * chunk, ky * kx * C)
        part = np.einsum("nhwk,ok->nhwo", cols[..., k0:k1], wk[:, k0:k1])
        assert np.abs(part).max(initial=0) < 2 ** 31   # an int32 partial
        total += part
    return total


SPLIT_CASES = [  # (n, H, W, C, oc, k, stride, pad, splits)
    (2, 7, 7, 64, 40, 3, 1, 1, 2),     # 5 chunks: ragged 2 + 3
    (1, 9, 8, 48, 72, 5, 2, 2, 3),     # 10 chunks: 3 + 3 + 4
    (2, 5, 5, 256, 24, 1, 1, 0, 2),    # 2 chunks: 1 + 1
    (1, 6, 6, 24, 16, 3, 1, 1, 2),     # C = 24, 2 chunks
]


@pytest.mark.parametrize("out", ["f32", "bf16", "int8", "nan"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_k_partials_through_the_epilogue_equal_qconv_plain(case, out):
    n, H, W, C, oc, k, s, p, splits = case
    rng = np.random.RandomState(11)
    xq = rng.randint(-127, 128, (n, H, W, C)).astype(np.int8)
    wq = rng.randint(-127, 128, (oc, k, k, C)).astype(np.int8)
    sws = torch.from_numpy((rng.rand(oc) * 1e-3 + 1e-5).astype(np.float32))
    bias = torch.from_numpy(rng.randn(oc).astype(np.float32))
    s_act = torch.tensor([np.float32(0.0213)])
    if out == "nan":
        # a dynamic scale of an x holding a NaN: every output NaN
        x = torch.from_numpy(rng.randn(n, H, W, C).astype(np.float32))
        x[0, 0, 0, 0] = float("nan")
        s_act = qc.act_quantize_plain(x)[1]
        assert s_act.isnan().all()
    odt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
           "nan": torch.float32}[out]
    chunks = -(-k * k * C // 128)
    ranges = qc.split_ranges(chunks, splits)
    acc = torch.from_numpy(_split_sums(xq, wq, (s, s), (p, p), ranges))
    xt, wt = torch.from_numpy(xq), torch.from_numpy(wq)
    absmax = 0.0
    if odt == torch.int8:
        absmax = 0.6 * float(qc.qconv_plain(xt, wt, s_act, sws, bias, (s, s),
                                            (p, p), True).abs().max())
    want = qc.qconv_plain(xt, wt, s_act, sws, bias, (s, s), (p, p), True,
                          odt, absmax)
    got = qc.qconv_epilogue(acc.to(torch.int32), s_act, sws, bias, True, odt,
                            absmax)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
    if out == "nan":
        assert got.isnan().all()


@pytest.mark.parametrize("scale", ["static", "dynamic", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quantize_transposed_store_is_quantize_then_permute(scale,
                                                                dtype):
    # half-way values round to the even code in either layout, and a NaN
    # (dynamic: a NaN scale, every code 0; static: that element 0)
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4, 5, 6).astype(np.float32) * 40
    x.reshape(-1)[:HALF_WAY.size] = HALF_WAY
    absmax = 127.0 if scale == "static" else 0.0
    if scale == "nan":
        x[1, 2, 3, 4] = np.nan
        absmax = 127.0
    xt = torch.from_numpy(x).to(dtype)
    q, s = qc.act_quantize_plain(xt, absmax)
    qt, st = qc.act_quantize_plain(xt, absmax, transpose=True)
    assert qt.shape == (6, 4, 5, 3) and qt.is_contiguous()
    assert torch.equal(qt, q.permute(3, 1, 2, 0)) and torch.equal(s, st)
    # the wrapper takes its plain version for a CPU tensor
    qw, sw = qc.act_quantize(xt, absmax, transpose=True)
    assert torch.equal(qw, qt) and torch.equal(sw, st)
    if scale == "nan":
        assert qt[4, 2, 3, 1] == 0
    if scale == "static" and dtype == torch.float32:
        assert q.reshape(-1)[:HALF_WAY.size].tolist() == \
            [0, 2, 2, 0, -2, -2, 126, 126, 127, -126, 127, -127, 0, 3]
    # dynamic with a NaN: the scale is NaN, every code 0
    if scale == "dynamic":
        xn = xt.clone()
        xn[0, 0, 0, 0] = float("nan")
        qn, sn = qc.act_quantize_plain(xn, 0.0, transpose=True)
        assert sn.isnan().all() and not qn.any()


def test_cotangent_quantize_is_quantize_filter_of_the_swapped_cotangent():
    rng = np.random.RandomState(6)
    g = rng.randn(4, 3, 5, 7).astype(np.float32) * 1e-2
    g[2, 1, 3, 5] = np.nan      # channel 5's scale is NaN, its codes 0
    gt = torch.from_numpy(g)
    gq, sg = qc.cotangent_quantize_plain(gt)
    want_q, want_s = qc.quantize_filter(gt.permute(3, 1, 2, 0))
    assert gq.shape == (7, 3, 5, 4) and gq.is_contiguous()
    assert torch.equal(gq, want_q) and sg.dtype == torch.float32
    assert torch.equal(sg.isnan(), want_s.isnan())
    assert torch.equal(sg.nan_to_num(0.0), want_s.nan_to_num(0.0))
    assert sg[5].isnan() and not gq[5].any()
    # the JAX weight quantize of the same "filter"
    jq, js = _q8_weight(np.ascontiguousarray(g.transpose(3, 1, 2, 0)))
    np.testing.assert_array_equal(gq.numpy(), jq)
    np.testing.assert_array_equal(sg.numpy(), js)
    assert torch.equal(qc.cotangent_quantize(gt)[0], gq)


def test_cotangent_quantize_counts_no_launch_on_the_cpu():
    before = qc.cotangent_quantize.launches
    qc.cotangent_quantize(torch.randn(2, 3, 3, 4))
    assert qc.cotangent_quantize.launches == before


# ------------------------------------------------------ presets and engine

def test_resnet_int8_site_tunes_match_jax():
    pipe, jpipe = build_model("resnet-50", batch=2), \
        jbuild_model("resnet-50", batch=2)
    got = presets.resnet_int8_site_tunes(pipe, HEADLINE)
    want = jpresets.resnet_int8_site_tunes(jpipe, HEADLINE)
    assert len(got) == 33
    assert presets.RESNET_INT8_SITE_PATS == jpresets.RESNET_INT8_SITE_PATS
    assert {t: str(v) for t, v in got.items()} == \
        {t: str(v) for t, v in want.items()}


@pytest.mark.parametrize("weights", list(SCALES))
def test_load_act_scales_matches_jax(weights, capsys):
    pipe, jpipe = build_model("resnet-50", batch=2), \
        jbuild_model("resnet-50", batch=2)
    got = presets.load_act_scales(
        SCALES[weights], presets.resnet_int8_site_tunes(pipe, HEADLINE))
    err = capsys.readouterr().err
    want = jpresets.load_act_scales(
        SCALES[weights], jpresets.resnet_int8_site_tunes(jpipe, HEADLINE))
    assert err == capsys.readouterr().err
    assert f"act_scales: applied 33/33 site(s) from {SCALES[weights]}" in err
    assert {t: v.act_scale for t, v in got.items()} == \
        {t: v.act_scale for t, v in want.items()}
    assert all(v.act_scale > 0 for v in got.values())


def test_save_act_scales_round_trips(tmp_path):
    pipe = build_model("resnet-50", batch=2)
    tunes = presets.load_act_scales(
        SCALES["zoo"], presets.resnet_int8_site_tunes(pipe, HEADLINE))
    presets.save_act_scales(tmp_path / "s.lexp", tunes)
    again = presets.load_act_scales(tmp_path / "s.lexp", tunes)
    assert {t: v.act_scale for t, v in again.items()} == \
        {t: v.act_scale for t, v in tunes.items()}


def test_calibration_twin_matches_jax_on_mini():
    pipe, jpipe = build_model("mini", batch=2), jbuild_model("mini", batch=2)
    x = (np.random.RandomState(0).randn(2, 3, 32, 32) * 40).astype(np.float32)
    base = "(use_culibs=1)"
    sites = {"cccp1": make_op_tune(base[:-1] + ",quant8=1)"),
             "conv2": make_op_tune(base[:-1] + ",quant8=1)")}
    jsites = {t: jmake_op_tune(base[:-1] + ",quant8=1)") for t in sites}
    got = presets.calibrate_int8_act_scales(pipe, base, x, sites,
                                            device="cpu")
    want = jpresets.calibrate_int8_act_scales(jpipe, base, x, jsites)
    assert sorted(got) == sorted(want) == sorted(sites)
    for t in sites:
        assert got[t].act_scale == pytest.approx(want[t].act_scale, rel=1e-5)
        assert got[t].quant8 and sites[t].act_scale == 0.0  # copies


def test_calibration_refuses_a_site_whose_input_a_fusion_removed():
    # under fuse_resblock the bottleneck's interior nodes are never stored:
    # guessing their scale would clip, so the twin refuses, as the JAX one
    pipe = build_model("resnet-50", batch=1, ysz=64, xsz=64)
    x = np.random.RandomState(0).randn(1, 3, 64, 64).astype(np.float32)
    q = make_op_tune("(fuse_resblock=1,quant8=1)")
    with pytest.raises(RtErr, match="input node 'res2b_branch2a' of site "
                                    "'res2b_branch2b' not in the forward"):
        presets.calibrate_int8_act_scales(pipe, "(fuse_resblock=1)", x,
                                          {"res2b_branch2b": q},
                                          device="cpu")


def _int8_plan(pkg_lower, pkg_build, pkg_tune, sites_fn, scales, q8_edges):
    pipe = pkg_build("resnet-50", batch=2)
    tune = HEADLINE[:-1] + (",q8_edges=1)" if q8_edges else ")")
    tunes = sites_fn[1](scales, sites_fn[0](pipe, tune))
    return pkg_lower(pipe, pkg_tune(tune), op_tunes=tunes, fuse_relu=True,
                     fused_storage=True)


def test_plan_mixed_peak_flops_match_jax():
    with contextlib.redirect_stderr(io.StringIO()):
        plan = _int8_plan(lower_pipe, build_model, make_op_tune,
                          (presets.resnet_int8_site_tunes,
                           presets.load_act_scales), SCALES["zoo"], False)
        jplan = _int8_plan(jlower_pipe, jbuild_model, jmake_op_tune,
                           (jpresets.resnet_int8_site_tunes,
                            jpresets.load_act_scales), SCALES["zoo"], False)
    tot, mixed = opinfo.plan_mixed_peak(plan, "NVIDIA H100 80GB HBM3")
    jtot, _ = jopinfo.plan_mixed_peak(jplan, "TPU v5 lite")
    assert tot == jtot > 0
    # between the card's bf16 and int8 peaks, weighted by the int8 FLOPs
    assert 989e12 < mixed < 1979e12


INT8_PAT = ",".join(f"{p}={HEADLINE[:-1]},quant8=1)"
                    for p in presets.RESNET_INT8_SITE_PATS)


def test_torch_fwd_op_tunes_pat_is_the_preset():
    # the preset spelled as tag regexes (what the CLI and the bench twin
    # pass) lowers to the plan of resnet_int8_site_tunes + load_act_scales
    pipe = build_model("resnet-50", batch=2)
    with contextlib.redirect_stderr(io.StringIO()) as err:
        eng = make_engine(f"(engine=torch,device=cpu,op_tune={HEADLINE},"
                          f"op_tunes_pat=({INT8_PAT}),"
                          f"act_scales_fn={SCALES['zoo']})")
        eng.init(pipe)
        plan = _int8_plan(lower_pipe, build_model, make_op_tune,
                          (presets.resnet_int8_site_tunes,
                           presets.load_act_scales), SCALES["zoo"], False)
    assert "act_scales: applied 33/" in err.getvalue()
    assert [str(s.sig) for s in eng.plan.steps] == \
        [str(s.sig) for s in plan.steps]
    q = [s for s in eng.plan.steps if s.sig.get_u32_or("quant8", 0)]
    assert len(q) == 31 and all("act_scale" in s.sig.nda_vals for s in q)
    assert sum(s.func_name == "xla_conv2" for s in q) == 2


def test_torch_fwd_act_scales_fn_needs_per_op_tunes():
    eng = make_engine(f"(engine=torch,device=cpu,op_tune={HEADLINE},"
                      f"act_scales_fn={SCALES['zoo']})")
    with pytest.raises(RtErr, match=re.escape(
            "act_scales_fn requires per-op tunes (op_tunes_pat or wisdom_fn) "
            "naming the quant8 sites the scales apply to")):
        eng.init(build_model("mini", batch=1))
    # the JAX engine's text, word for word
    jeng = jiface.make_engine(f"(engine=rtc,op_tune={HEADLINE},"
                              f"act_scales_fn={SCALES['zoo']})")
    with pytest.raises(Exception) as je:
        jeng.init(jbuild_model("mini", batch=1))
    assert "act_scales_fn requires per-op tunes (op_tunes_pat or " \
        "wisdom_fn) naming the quant8 sites the scales apply to" in \
        str(je.value)


# ------------------------------------------------------ the slice as a whole

def build_int8_boundary_net(pkg=PORT):
    """tests/test_torch_conv2.build_boundary_net with channels wide enough
    for the int8 conv's channel gate (in_chan >= 16) at every branch."""
    b = pkg[0].NetBuilder("boundary8", 2, 3, 32, 32)
    b.conv("conv1", 16, 7, 2, 3).pool("pool1", 3, 2)
    stem = b.cur
    b.conv("branch1", 64, 1, 2, relu=False)
    branch1 = b.cur
    b.cur = stem
    b.conv("branch2a", 16, 1, 2).conv("branch2b", 16, 3, 1, 1)
    b.conv("branch2c", 64, 1, relu=False)
    b.eltwise("sum", [branch1, b.cur]).relu("sum_relu")
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.conv("fc", 10, 1, relu=False).softmax("prob")
    return b.done(seed=11)


@pytest.mark.parametrize("q8_edges", [False, True])
def test_int8_boundary_net_matches_jax_engine(monkeypatch, tmp_path,
                                              q8_edges):
    # the int8 preset's forms on a stage boundary: the branch1 + branch2a
    # pair fused into an int8 xla_conv2 (1x1/s2), branch2b and branch2c int8
    # xla_convs, static scales calibrated by the port's twin; with
    # q8_edges=1 the branch2b -> branch2c edge is stored int8 (out_q8,
    # in_q8); every node against the JAX engine, the int8 steps' outputs
    # bit-equal
    from tests.test_torch_conv2 import _run
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")
    pipe, jpipe = build_int8_boundary_net(), build_int8_boundary_net(JAX)
    for p_ in (pipe, jpipe):     # bf16-exact weights (test_torch_conv2.py)
        for v in p_.op_params.values():
            v.v[...] = torch.from_numpy(v.v).bfloat16().float().numpy()
    d = pipe.get_data_img_dims()
    x = PORT[3](d, 0, 0.1)
    sites = ("branch1", "branch2a", "branch2b", "branch2c")
    q = make_op_tune(f"{HEADLINE[:-1]},quant8=1)")
    tunes = presets.calibrate_int8_act_scales(
        pipe, HEADLINE, x, {t: q for t in sites}, device="cpu")
    presets.save_act_scales(tmp_path / "s.lexp", tunes)
    pats = ",".join(f"{t}={HEADLINE[:-1]},quant8=1)" for t in sites)
    base = HEADLINE[:-1] + (",q8_edges=1)" if q8_edges else ")")
    spec = (f"op_tune={base},op_tunes_pat=({pats}),"
            f"act_scales_fn={tmp_path / 's.lexp'}")
    with contextlib.redirect_stderr(io.StringIO()):
        teng, touts = _run(pipe, f"(engine=torch,device=cpu,"
                                 f"keep_all_nodes=1,{spec})", PORT)
        _, jouts = _run(jpipe, f"(engine=rtc,keep_all_nodes=1,{spec})", JAX,
                        set(touts))
    funcs = [(s.func_name, s.sig.get_u32_or("quant8", 0))
             for s in teng.plan.steps]
    assert funcs.count(("xla_conv2", 1)) == 1
    assert funcs.count(("xla_conv", 1)) == 2
    flips = {s.call_tag: (s.sig.get_u32_or("out_q8", 0),
                          s.sig.get_u32_or("in_q8", 0))
             for s in teng.plan.steps}
    assert (flips["branch2b"], flips["branch2c"]) == \
        (((1, 0), (0, 1)) if q8_edges else ((0, 0), (0, 0)))
    kg = {n: nda_digest(NDA(pipe.nodes[n].dims, np.asarray(v.v)))
          for n, v in jouts.items()}
    assert not comp_digests(touts, kg, 5e-3)
    for n in sites:
        np.testing.assert_array_equal(touts[n].v, np.asarray(jouts[n].v))


def test_int8_preset_resnet50_matches_jax_engine(monkeypatch):
    # ResNet-50 at 64x64, batch 2: the 31 int8 steps of the preset (29
    # xla_conv, 2 xla_conv2) with the zoo weights' static scales, through
    # both engines: the same top-1, the logits within 5e-2 (the bound
    # tests/test_quant8.py holds static against dynamic int8 to). On this
    # untrained net (|logits| ~ 300) the float steps alone drift: the bf16
    # headline tune's logits differ between the engines by mrd 4.8e-3 (sums
    # in other orders, stored bf16), and int8 codes at rounding boundaries
    # carry that to 1.7e-2; the int8 steps themselves are bit-equal
    # (test_int8_boundary_net_matches_jax_engine)
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")
    spec = f"op_tune={HEADLINE},op_tunes_pat=({INT8_PAT}),act_scales_fn=" \
           f"{SCALES['zoo']}"
    outs = []
    for pkg, eng_s in ((PORT, f"(engine=torch,device=cpu,{spec})"),
                       (JAX, f"(engine=rtc,{spec})")):
        pipe = pkg[0].build_model("resnet-50", batch=2, ysz=64, xsz=64)
        with contextlib.redirect_stderr(io.StringIO()):
            eng = pkg[1](eng_s)
            eng.init(pipe)
        d = pipe.get_data_img_dims()
        o = eng.run_fwd({"data": pkg[2](d, pkg[3](d, 0, 0.1))},
                        ["fc1000-conv", "prob"])
        outs.append({k: np.asarray(v.v, np.float32) for k, v in o.items()})
        if pkg is PORT:
            assert sum(s.sig.get_u32_or("quant8", 0)
                       for s in eng.plan.steps) == 31
    (got, want) = outs
    lg, lw = got["fc1000-conv"], want["fc1000-conv"]
    assert np.abs(lg - lw).max() / np.abs(lw).max() <= 5e-2
    assert (got["prob"].reshape(2, -1).argmax(1)
            == want["prob"].reshape(2, -1).argmax(1)).all()


def test_int8_preset_on_trained_weights_port_gate(capsys):
    # tests/test_quant8.py::_trained_gate's twin on the port: cls_agree of
    # the headline tune (a) against the int8 preset with the scales
    # calibrated on the trained weights (b), engine=torch on the CPU, 8
    # held-out images at 224^2, the same thresholds
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        create_and_run_has_main(
            f"(mode=cls_agree,model=resnet-50,model_opts=(num_classes=40),"
            f"batch=8,weights_fn={DATA / 'resnet50-shapes40.boda'},"
            f"src=(mode=shapes-src,num_imgs=8,start_ix=100000,ysz=224,"
            f"xsz=224,num_classes=40,seed=1,mean=128,scale=0.015625),"
            f"conv_fwd=(engine=torch,device=cpu,op_tune={HEADLINE}),"
            f"conv_fwd_b=(engine=torch,device=cpu,op_tune={HEADLINE},"
            f"op_tunes_pat=({INT8_PAT}),"
            f"act_scales_fn={SCALES['trained']}))", {})
    out = buf.getvalue()
    s = {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)", out)}
    with capsys.disabled():
        print(f"\nport trained-weights int8 gate: "
              f"{time.perf_counter() - t0:.1f} s; {out.strip()[-140:]}")
    assert s["num_test"] == 8
    assert s["top_1_acc_a"] >= 0.75 and s["top_1_acc_b"] >= 0.75, s
    assert s["num_pos_b"] >= s["num_pos_a"] - 1, s
    assert s["b_top1_in_a_top5"] == 1.0, s
    assert s["top_1_agree"] >= 0.875, s
