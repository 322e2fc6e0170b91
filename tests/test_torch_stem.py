"""fused_stem (kernel B4) and the port's `fused_stem` template against the
JAX package's Pallas build_fused_stem body in interpret mode, on the same
seeded inputs: the cases of tests/test_stem.py, in f32 and bf16, in the
NCHW form and the NHWC bf16-edge storage form; plus the wrapper's own
interface, its plan (route, tile, grid), its filter reorder and the
operands it refuses.

Both kernels add the bias in f32, unrounded (stem.py:174), and round once
to the output dtype.

Tolerances: f32 rtol = atol = 3e-5 (tests/test_stem.py's); bf16 mrd <=
5e-3 (the repo's bf16 mrd_toler: the two packages sum in another order, so
a bf16 output may round the other way, 2^-8 at most).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.ops.pallas.stem import make_stem_op
from boda_tpu.ops.registry import get_template as jax_template
from boda_tpu.testing.comp import mrd
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.ops.op_base import OpBase as PortOpBase
from boda_tpu_torch.ops.cuda.stem import SMEM_MAX, filter_layout, fused_stem, \
    fused_stem_plain, stem_filter, stem_plan
from boda_tpu_torch.ops.registry import get_template

CASES = {
    # tests/test_stem.py:50-55
    "f32": dict(),
    "f32-nhwc": dict(io_layout="nhwc"),
    "f32-nonsquare-nobias": dict(n=2, h=48, w=40, cout=8, bias=False),
    "f32-58": dict(h=58, w=58),
    # tests/test_stem.py:62-64, and the bf16 forms of the plans
    "bf16-nhwc": dict(io_layout="nhwc", prec="bf16"),
    "bf16-nchw": dict(prec="bf16"),
    "bf16-nhwc-storage": dict(io_layout="nhwc", prec="bf16", edge="bf16"),
}


def _case(n=1, cin=3, h=56, w=56, cout=16, k=7, io_layout="", prec="",
          edge="", bias=True):
    op = make_stem_op(n, cin, h, w, cout, k=k, bias=bias)
    if io_layout:
        op.str_vals["io_layout"] = io_layout
    if prec:
        op.str_vals["prec"] = prec
    if edge:
        op.str_vals["edge_prec"] = edge
    rng = np.random.RandomState(0)
    x = rng.randn(n, cin, h, w).astype(np.float32) * 0.3
    wts = rng.randn(cout, cin, k, k).astype(np.float32) * 0.3
    args = [x, wts] + ([rng.randn(cout).astype(np.float32)] if bias else [])
    return op, args


def _port_op(op):
    """The port's copy of a JAX op sig, through its lexp text."""
    return PortOpBase.from_lexp(str(op.to_lexp()))


@pytest.mark.parametrize("name", list(CASES))
def test_stem_template_matches_pallas_interpret(monkeypatch, name):
    monkeypatch.setenv("BODA_PALLAS_MODE", "interpret")
    c = CASES[name]
    op, args = _case(**c)
    nhwc = c.get("io_layout") == "nhwc"
    edge = c.get("edge") == "bf16"
    if nhwc:
        args[0] = args[0].transpose(0, 2, 3, 1).copy()
    jt = jax_template("fused_stem")
    jrfs = jt.check_args(op)
    jargs = [jnp.asarray(args[0]).astype(jnp.bfloat16)] + args[1:] \
        if edge else args
    want = np.asarray(jt.build(jrfs)(*jargs), np.float32)

    pt = get_template("fused_stem")
    rfs = pt.check_args(_port_op(op))
    assert str(rfs) == str(jrfs)
    targs = [torch.from_numpy(a) for a in args]
    if edge:
        targs[0] = targs[0].bfloat16()
    out = pt.build(rfs)(*targs)
    assert out.dtype == (torch.bfloat16 if edge else torch.float32)
    got = out.float().numpy()
    assert got.shape == want.shape
    if c.get("prec") == "bf16":
        assert mrd(got, want) <= 5e-3
    else:
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
        ref = pt.ref_impl(rfs, *[a.transpose(0, 3, 1, 2) if nhwc and i == 0
                                 else a for i, a in enumerate(args)])
        if nhwc:
            ref = ref.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("relu", [True, False])
def test_stem_wrapper_nhwc_against_ref(relu):
    # the wrapper's own interface: NHWC x, OIHW w, f32 bias, NHWC out; with
    # relu off, a window's max is over the conv values it covers
    op, (x, w, b) = _case(n=2, h=20, w=18, cout=70)
    if not relu:
        op.set_u32("conv_has_relu", 0)
    ref = jax_template("fused_stem").ref_impl(op, x, w, b)
    xh = torch.from_numpy(x.transpose(0, 2, 3, 1).copy())
    got = fused_stem(xh, torch.from_numpy(w), torch.from_numpy(b), relu=relu)
    np.testing.assert_allclose(got.numpy().transpose(0, 3, 1, 2), ref,
                               rtol=3e-5, atol=3e-5)
    assert got.shape == (2, 5, 4, 70)
    np.testing.assert_array_equal(
        got.numpy(), fused_stem_plain(xh, torch.from_numpy(w),
                                      torch.from_numpy(b), relu=relu).numpy())


# name -> (stem_plan arguments, route, tile (ty, tx) or None, blocks)
PLANS = {
    # ResNet-50's conv1 + pool1 on an H100 SXM (132 SMs) and PCIe (114)
    "rn50-b32-bf16-132": (dict(n=32, es=2, sms=132), "mma", (8, 8), 264),
    "rn50-b32-bf16-114": (dict(n=32, es=2, sms=114), "mma", (8, 8), 228),
    "rn50-b32-f32-132": (dict(n=32, es=4, sms=132), "ffma", (3, 8), 264),
    "rn50-b32-f32-114": (dict(n=32, es=4, sms=114), "ffma", (3, 8), 228),
    # at batch 1 the grid is what is scarce: small tiles
    "rn50-b1-bf16-132": (dict(n=1, es=2, sms=132), "mma", None, None),
    "rn50-b1-f32-132": (dict(n=1, es=4, sms=132), "ffma", None, None),
    # f32 out of bf16 in: a wider conv tile, still two blocks per SM
    "rn50-b32-bf16-f32out": (dict(n=32, es=2, sms=132, out_bytes=4), "mma",
                             None, None),
    # two blocks of output channels, the second ragged
    "oc72": (dict(n=2, H=40, W=36, oc=72, es=2, sms=132), "mma", None, None),
    # C = 5: filter rows of 35 values, one lead zero, padded to 48
    "c5-bf16": (dict(n=2, H=30, W=34, C=5, oc=24, es=2, sms=132), "mma",
                None, None),
    "c5-f32": (dict(n=2, H=30, W=34, C=5, oc=24, es=4, sms=132), "ffma",
               None, None),
    # stride 1 x 3 channels: bf16 leaves the tensor cores, and says why
    "stride1-bf16": (dict(n=2, H=20, W=24, oc=16, es=2, sms=132,
                          stride=(1, 1)), "ffma", None, None),
    # a 9x9 pool window: a 1 x 4 tile is a 9 x 12 conv tile
    "pool9": (dict(n=1, H=64, W=64, oc=8, es=4, sms=132,
                   pool=((9, 9), (1, 1))), "ffma", None, None),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_stem_plan(name):
    kw, route, tile, blocks = PLANS[name]
    kw = dict(kw)
    args = (kw.pop("n"), kw.pop("H", 224), kw.pop("W", 224), kw.pop("C", 3),
            kw.pop("oc", 64), kw.pop("es"), kw.pop("sms"))
    p = stem_plan(*args, **kw)
    n, H, W, C, oc, es, sms = args
    assert p is stem_plan(*args, **kw)            # cached
    assert p.route == route
    assert bool(p.why) == (es == 2 and route == "ffma")
    if tile is not None:
        assert (p.ty, p.tx, p.blocks) == (*tile, blocks)
    (ky, kx), (_, px) = kw.get("kern", (7, 7)), kw.get("pad", (3, 3))
    assert (p.lead, p.KR, p.Kp) == filter_layout(route, C, ky, kx, px)
    if route == "mma":
        assert p.lead == (px * C) % 2 and p.KR % 16 == 0 and p.Kp % 64 == 0
        assert p.KR >= p.lead + kx * C
    else:
        assert (p.lead, p.KR) == (0, kx * C) and p.Kp % 8 == 0
    assert p.Kp >= ky * p.KR
    assert p.vec == ((W * C * es) % 16 == 0)
    assert p.smem <= SMEM_MAX and p.per_sm in (1, 2)
    assert p.per_sm * (p.smem + 1024) <= 228 * 1024
    # a persistent grid: no more blocks than the card holds, or than tiles
    sy, sx = kw.get("stride", (2, 2))
    (pky, pkx), (psy, psx) = kw.get("pool", ((3, 3), (2, 2)))
    cy, cx = (H + 6 - ky) // sy + 1, (W + 6 - kx) // sx + 1
    oy, ox = -(-(cy - pky) // psy) + 1, -(-(cx - pkx) // psx) + 1
    ntiles = n * -(-oy // p.ty) * -(-ox // p.tx)
    assert 1 <= p.blocks <= min(ntiles, sms * p.per_sm)


def test_stem_plan_refuses_a_window_no_block_holds():
    with pytest.raises(RtErr, match="do not fit"):
        stem_plan(1, 400, 400, 3, 8, 4, 132, pool=((40, 40), (1, 1)))


@pytest.mark.parametrize("route,C,k,px", [("mma", 3, 7, 3), ("mma", 5, 7, 3),
                                          ("mma", 4, 5, 2), ("ffma", 3, 7, 3),
                                          ("ffma", 5, 3, 1)])
def test_stem_filter_reorder(route, C, k, px):
    # the kernel's layout against a numpy loop: w[o, c, yy, xx] at
    # yy * KR + lead + xx * C + c, zeros elsewhere
    oc = 6
    rng = np.random.RandomState(1)
    w = rng.randn(oc, C, k, k).astype(np.float32)
    lead, KR, Kp = filter_layout(route, C, k, k, px)
    want = np.zeros((oc, Kp), np.float32)
    for yy in range(k):
        for xx in range(k):
            for c in range(C):
                want[:, yy * KR + lead + xx * C + c] = w[:, c, yy, xx]
    for dt in (torch.float32, torch.bfloat16):
        got = stem_filter(torch.from_numpy(w).to(dt), lead, KR, Kp)
        assert got.dtype == dt and got.is_contiguous()
        np.testing.assert_array_equal(
            got.float().numpy(),
            torch.from_numpy(want).to(dt).float().numpy())


def test_stem_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 16, 16, 3)
    w = torch.zeros(8, 3, 7, 7)
    with pytest.raises(RtErr, match="channels"):
        fused_stem(x, torch.zeros(8, 4, 7, 7))
    with pytest.raises(RtErr, match="contiguous"):
        fused_stem(torch.zeros(1, 3, 16, 16).permute(0, 2, 3, 1), w)
    with pytest.raises(RtErr, match="but w is"):
        fused_stem(x, w.bfloat16())
    with pytest.raises(RtErr, match="expected 4-d"):
        fused_stem(torch.zeros(16, 16, 3), w)
    with pytest.raises(RtErr, match="dtype torch.float64"):
        fused_stem(x.double(), w.double())
    with pytest.raises(RtErr, match="bias length"):
        fused_stem(x, w, torch.zeros(3))
    with pytest.raises(RtErr, match="windows empty"):
        fused_stem(x, w, pool=((2, 2), (3, 3)))
    with pytest.raises(RtErr, match="empty output"):
        fused_stem(torch.zeros(1, 2, 2, 3), w)
    with pytest.raises(RtErr, match="no kernel for device 'meta'"):
        fused_stem(x.to("meta"), w.to("meta"))


def test_stem_template_refuses_an_unfused_relu():
    op, _ = _case()
    op.set_u32("conv_has_relu", 0)
    pt = get_template("fused_stem")
    with pytest.raises(RtErr, match="conv_has_relu"):
        pt.build(pt.check_args(_port_op(op)))
