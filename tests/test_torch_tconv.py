"""tconv (kernel B2) and the port's `tconv` template against the JAX
package's Pallas build_tconv body in interpret mode, on the same seeded
inputs: the cases of tests/test_tconv.py plus C=128 with bias in bf16, in
the NCHW form and the NHWC bf16-edge storage form.

The Pallas kernel adds the bias rounded to the compute dtype
(tconv.py:199), unlike build_matmul_ext, which keeps it in f32; the port
reproduces each, so under prec=bf16 both add a bf16-rounded bias here.

Also: tconv_plain (the kernel's plain version, filter in OHWI order)
against the JAX tconv in interpret mode and in fallback, and tconv_plan's
tile and K-split choices at the ResNet-50 3x3 shapes and the edge shapes.

Tolerances: f32 rtol = atol = 2e-5 (tconv_plain alone: 1e-5); bf16 mrd <=
5e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.core.dims import Dims
from boda_tpu.ops.pallas.conv import make_conv_op
from boda_tpu.ops.registry import get_template as jax_template
from boda_tpu.testing.comp import mrd
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.ops.op_base import OpBase as PortOpBase
from boda_tpu_torch.ops.cuda.tconv import tconv, tconv_plain, tconv_plan
from boda_tpu_torch.ops.cuda.util import GemmPlan
from boda_tpu_torch.ops.registry import get_template

CASES = {
    # tests/test_tconv.py:36-53
    "c8-3x3": dict(n=1, cin=8, h=10, w=10, cout=16, k=3, pad=1, relu=False,
                   bias=False),
    "c16-3x3-relu-bias": dict(n=2, cin=16, h=9, w=9, cout=32, k=3, pad=1,
                              relu=True, bias=True),
    "c4-5x5": dict(n=1, cin=4, h=12, w=8, cout=8, k=5, pad=2, relu=False,
                   bias=True),
    "c8-1x1": dict(n=1, cin=8, h=7, w=7, cout=8, k=1, pad=0, relu=True,
                   bias=False),
    "ty-tiling": dict(n=1, cin=8, h=10, w=10, cout=16, k=3, pad=1,
                      relu=False, bias=True, work=dict(Mb=4, Nb=128)),
    # the ResNet form: C=128 3x3 pad 1, with bias, bf16 operands
    "c128-bf16": dict(n=1, cin=128, h=6, w=6, cout=128, k=3, pad=1,
                      relu=True, bias=True, prec="bf16"),
    "c128-bf16-nhwc-storage": dict(n=1, cin=128, h=6, w=6, cout=128, k=3,
                                   pad=1, relu=True, bias=True, prec="bf16",
                                   storage=True),
}


def _case(c):
    op = make_conv_op(c["n"], c["cin"], c["h"], c["w"], c["cout"], c["k"],
                      c["k"], 1, 1, c["pad"], c["pad"], func_name="tconv",
                      relu=c["relu"], bias=c["bias"])
    if c.get("prec"):
        op.str_vals["prec"] = c["prec"]
    if c.get("storage"):
        op.str_vals["io_layout"] = "nhwc"
        op.str_vals["edge_prec"] = "bf16"
    if c.get("work"):
        op.set_dims("work", Dims.make(tn="none", **c["work"]))
    rng = np.random.RandomState(0)
    x = rng.randn(c["n"], c["cin"], c["h"], c["w"]).astype(np.float32) * 0.3
    w = rng.randn(c["cout"], c["cin"], c["k"], c["k"]).astype(np.float32) * 0.3
    args = [x, w]
    if c["bias"]:
        args.append(rng.randn(c["cout"]).astype(np.float32))
    return op, args


def _port_op(op):
    """The port's copy of a JAX op sig, through its lexp text."""
    return PortOpBase.from_lexp(str(op.to_lexp()))


@pytest.mark.parametrize("name", list(CASES))
def test_tconv_template_matches_pallas_interpret(monkeypatch, name):
    monkeypatch.setenv("BODA_PALLAS_MODE", "interpret")
    c = CASES[name]
    op, args = _case(c)
    storage = c.get("storage", False)
    if storage:
        args[0] = args[0].transpose(0, 2, 3, 1).copy()
    jt = jax_template("tconv")
    jargs = [jnp.asarray(args[0]).astype(jnp.bfloat16)] + args[1:] \
        if storage else args
    want = np.asarray(jt.build(jt.check_args(op))(*jargs), np.float32)

    pt = get_template("tconv")
    rfs = pt.check_args(_port_op(op))
    assert str(rfs) == str(jt.check_args(op))
    targs = [torch.from_numpy(a) for a in args]
    if storage:
        targs[0] = targs[0].bfloat16()
    out = pt.build(rfs)(*targs)
    assert out.dtype == (torch.bfloat16 if storage else torch.float32)
    got = out.float().numpy()
    assert got.shape == want.shape
    if c.get("prec") == "bf16":
        assert mrd(got, want) <= 5e-3
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, pt.ref_impl(rfs, *args), rtol=2e-5,
                                   atol=2e-5)


def test_tconv_wrapper_nhwc_against_ref():
    # the wrapper's own interface: NHWC x, OHWI w, f32 bias, NHWC out
    op, (x, w, b) = _case(CASES["c16-3x3-relu-bias"])
    ref = jax_template("tconv").ref_impl(op, x, w, b)
    got = tconv(torch.from_numpy(x.transpose(0, 2, 3, 1).copy()),
                torch.from_numpy(w.transpose(0, 2, 3, 1).copy()),
                torch.from_numpy(b), (1, 1), True)
    np.testing.assert_allclose(got.numpy().transpose(0, 3, 1, 2), ref,
                               rtol=2e-5, atol=2e-5)


def test_tconv_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 5, 5, 8)
    w = torch.zeros(4, 3, 3, 8)  # OHWI
    with pytest.raises(RtErr, match="channels"):
        tconv(x, torch.zeros(4, 3, 3, 6))
    with pytest.raises(RtErr, match="channels"):
        tconv(x, torch.zeros(4, 8, 3, 3))  # an OIHW filter
    with pytest.raises(RtErr, match="contiguous"):
        tconv(torch.zeros(1, 8, 5, 5).permute(0, 2, 3, 1), w)
    with pytest.raises(RtErr, match="but w is"):
        tconv(x, w.bfloat16())
    with pytest.raises(RtErr, match="empty output"):
        tconv(torch.zeros(1, 2, 2, 8), w)
    with pytest.raises(RtErr, match="bias length"):
        tconv(x, w, torch.zeros(3), (1, 1))
    with pytest.raises(RtErr, match="no kernel for device 'meta'"):
        tconv(x.to("meta"), w.to("meta"), pad=(1, 1))


@pytest.mark.parametrize("pallas_mode", ["interpret", "fallback"])
@pytest.mark.parametrize("name", ["c8-3x3", "c16-3x3-relu-bias", "c4-5x5",
                                  "c8-1x1", "c128-bf16"])
def test_tconv_plain_matches_the_jax_tconv(monkeypatch, pallas_mode, name):
    # the JAX template in NCHW with an OIHW filter; tconv_plain in NHWC with
    # the filter in OHWI order, as the template hands it to the kernel.
    # Under prec=bf16 the inputs are bf16-exact, so both multiply the same
    # values and differ only in the order of the f32 sums
    monkeypatch.setenv("BODA_PALLAS_MODE", pallas_mode)
    c = CASES[name]
    op, args = _case(c)
    bf16 = c.get("prec") == "bf16"
    if bf16:
        args = [torch.from_numpy(a).bfloat16().float().numpy() for a in args]
    jt = jax_template("tconv")
    want = np.asarray(jt.build(jt.check_args(op))(*args), np.float32)
    dt = torch.bfloat16 if bf16 else torch.float32
    x = torch.from_numpy(args[0].transpose(0, 2, 3, 1).copy()).to(dt)
    w = torch.from_numpy(args[1].transpose(0, 2, 3, 1).copy()).to(dt)
    b = torch.from_numpy(args[2]) if c["bias"] else None
    got = tconv_plain(x, w, b, (c["pad"], c["pad"]), c["relu"])
    got = got.numpy().transpose(0, 3, 1, 2)
    assert got.shape == want.shape
    if bf16:
        assert mrd(got, want) <= 5e-3
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# (n, H, W, C, oc, k, pad) -> (bf16 splits, f32 splits, output tiles, bf16
# vec, f32 vec) on a card of 132 SMs (an H100 SXM): the ResNet-50 3x3
# layers (res2 reaches the im2col conv, res3 to res5 tconv) at batch 32 and
# 1, and the edge shapes of chip_smoke.py
PLANS = {
    "res2 b32": ((32, 56, 56, 64, 64, 3, 1), (1, 1, 784, True, True)),
    "res3 b32": ((32, 28, 28, 128, 128, 3, 1), (1, 4, 196, True, True)),
    "res4 b32": ((32, 14, 14, 256, 256, 3, 1), (1, 4, 98, True, True)),
    "res5 b32": ((32, 7, 7, 512, 512, 3, 1), (4, 4, 52, True, True)),
    "res2 n1": ((1, 56, 56, 64, 64, 3, 1), (5, 8, 25, True, True)),
    "res3 n1": ((1, 28, 28, 128, 128, 3, 1), (9, 29, 7, True, True)),
    "res4 n1": ((1, 14, 14, 256, 256, 3, 1), (18, 58, 4, True, True)),
    "res5 n1": ((1, 7, 7, 512, 512, 3, 1), (36, 64, 4, True, True)),
    "edge 5x5 C=13": ((2, 5, 9, 13, 70, 5, 2), (3, 21, 1, False, False)),
    "edge 1x1 C=6": ((1, 3, 3, 6, 5, 1, 0), (1, 1, 1, False, False)),
    "edge 13x11 C=64 oc=72": ((3, 13, 11, 64, 72, 3, 1),
                              (5, 36, 4, True, True)),
    "edge split 7^2 C=256 oc=200": ((1, 7, 7, 256, 200, 3, 1),
                                    (18, 96, 2, True, True)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_tconv_plan(name):
    (n, H, W, C, oc, k, p), (s16, s32, blocks, v16, v32) = PLANS[name]
    p16 = tconv_plan(n, H, W, C, oc, k, k, torch.bfloat16, (p, p), 132)
    p32 = tconv_plan(n, H, W, C, oc, k, k, torch.float32, (p, p), 132)
    assert p16 == GemmPlan("mma", v16, 128, 128, 64, s16, blocks)
    assert p32 == GemmPlan("ffma", v32, 128, 128, 8, s32, blocks)
    for plan in (p16, p32):
        chunks = -(-k * k * C // plan.bk)
        per = -(-chunks // plan.splits)
        # every split sums at least two chunks (or all there are), none
        # is empty, and a split grid reaches every one of the 132 SMs
        # where it can (a bf16 grid splits only under half of them, an f32
        # grid under two tiles per SM)
        assert per >= min(2, chunks) and (plan.splits - 1) * per < chunks
        below = 66 if plan.route == "mma" else 264
        if plan.splits > 1:
            assert blocks < below
            assert blocks * plan.splits >= 132 or per == 2, plan
        else:
            assert blocks >= below or chunks < 4, plan


@pytest.mark.parametrize("sms, splits", [(132, 4), (114, 1), (33, 1)])
def test_tconv_plan_follows_the_sm_count(sms, splits):
    # 60 output tiles in bf16 fill less than half of an H100 SXM's 132 SMs,
    # so K splits in 4 there, but more than half of an H100 PCIe's 114
    plan = tconv_plan(15, 16, 32, 128, 128, 3, 3, torch.bfloat16, (1, 1),
                      sms)
    assert (plan.blocks, plan.splits) == (60, splits)


def test_tconv_plan_refuses_other_dtypes():
    with pytest.raises(RtErr, match="not f32/bf16"):
        tconv_plan(1, 5, 5, 8, 8, 3, 3, torch.float16, (1, 1), 132)
