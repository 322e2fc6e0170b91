"""resblock (kernel B5) and the port's `resblock` template against the JAX
package's Pallas build_resblock body in interpret mode, on the same seeded
inputs: the shapes of tests/test_resblock.py, in f32 and bf16, in the NCHW
form and the NHWC bf16-edge storage form, with and without the output
ReLU; plus the wrapper's own interface, its plan (route, band, cluster and
tile) at the ResNet-50 shapes, and the operands it refuses.

Both follow the Pallas kernel body's roundings (resblock.py:98-135): under
prec=bf16 the weights and biases are rounded to bf16, and h1 and h2 are
stored in bf16.

Tolerances: f32 rtol = atol = 3e-5 (tests/test_resblock.py's); bf16 mrd <=
5e-3 (the repo's bf16 mrd_toler: the packages sum in another order, so a
stored bf16 h1, h2 or output may round the other way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.core.dims import Dims
from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.registry import get_template as jax_template
from boda_tpu.testing.comp import mrd
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.ops.op_base import OpBase as PortOpBase
from boda_tpu_torch.ops.cuda.resblock import CLUSTERS, SMEM_MAX, \
    ResblockPlan, ffma_static_smem, resblock, resblock_plain, resblock_plan
from boda_tpu_torch.ops.registry import get_template

SHAPES = [(1, 16, 10, 10, 8), (2, 32, 9, 7, 8)]   # tests/test_resblock.py:149-152
FORMS = {
    "f32": dict(),
    "f32-relu_out0": dict(relu_out=False),
    "bf16": dict(prec="bf16"),
    "bf16-nhwc-storage": dict(prec="bf16", storage=True),
    "bf16-nhwc-storage-relu_out0": dict(prec="bf16", storage=True,
                                        relu_out=False),
}


def _make_op(n, C, H, W, Cm, prec="", relu_out=True, storage=False):
    op = OpBase({"type": "resblock", "func_name": "resblock"})
    op.set_dims("in", Dims.make(img=n, chan=C, y=H, x=W))
    op.set_dims("w1", Dims.make(out_chan=Cm, in_chan=C, y=1, x=1))
    op.set_dims("b1", Dims.make(out_chan=Cm))
    op.set_dims("w2", Dims.make(out_chan=Cm, in_chan=Cm, y=3, x=3))
    op.set_dims("b2", Dims.make(out_chan=Cm))
    op.set_dims("w3", Dims.make(out_chan=C, in_chan=Cm, y=1, x=1))
    op.set_dims("b3", Dims.make(out_chan=C))
    op.set_dims("out", Dims.make(img=n, chan=C, y=H, x=W))
    op.set_u32("relu_out", int(relu_out))
    if prec:
        op.str_vals["prec"] = prec
    if storage:
        op.str_vals["io_layout"] = "nhwc"
        op.str_vals["edge_prec"] = "bf16"
    return op


def _args(n, C, H, W, Cm, seed=0):
    # tests/test_resblock.py:137-146
    rng = np.random.RandomState(seed)
    s = 0.2
    return [rng.randn(n, C, H, W).astype(np.float32) * s,
            rng.randn(Cm, C, 1, 1).astype(np.float32) * s,
            rng.randn(Cm).astype(np.float32) * s,
            rng.randn(Cm, Cm, 3, 3).astype(np.float32) * s / 3,
            rng.randn(Cm).astype(np.float32) * s,
            rng.randn(C, Cm, 1, 1).astype(np.float32) * s,
            rng.randn(C).astype(np.float32) * s]


def _port_op(op):
    """The port's copy of a JAX op sig, through its lexp text."""
    return PortOpBase.from_lexp(str(op.to_lexp()))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_resblock_template_matches_pallas_interpret(monkeypatch, shape, form):
    monkeypatch.setenv("BODA_PALLAS_MODE", "interpret")
    f = FORMS[form]
    storage = f.get("storage", False)
    op = _make_op(*shape, **f)
    args = _args(*shape)
    if storage:
        args[0] = args[0].transpose(0, 2, 3, 1).copy()
    jt = jax_template("resblock")
    jargs = [jnp.asarray(args[0]).astype(jnp.bfloat16)] + args[1:] \
        if storage else args
    want = np.asarray(jt.build(jt.check_args(op))(*jargs), np.float32)

    pt = get_template("resblock")
    rfs = pt.check_args(_port_op(op))
    assert str(rfs) == str(jt.check_args(op))
    targs = [torch.from_numpy(a) for a in args]
    if storage:
        targs[0] = targs[0].bfloat16()
    out = pt.build(rfs)(*targs)
    assert out.dtype == (torch.bfloat16 if storage else torch.float32)
    got = out.float().numpy()
    assert got.shape == want.shape
    if f.get("relu_out", True) is False:
        assert (got < 0).any()  # relu_out=0 respected
    if f.get("prec") == "bf16":
        assert mrd(got, want) <= 5e-3
    else:
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(got, pt.ref_impl(rfs, *args), rtol=3e-5,
                                   atol=3e-5)


def test_resblock_wrapper_takes_2d_and_4d_1x1_weights():
    n, C, H, W, Cm = 2, 12, 5, 6, 5     # no size a multiple of anything
    x, w1, b1, w2, b2, w3, b3 = [torch.from_numpy(a)
                                 for a in _args(n, C, H, W, Cm, seed=1)]
    xh = x.permute(0, 2, 3, 1).contiguous()
    w2h = w2.permute(0, 2, 3, 1).contiguous()     # OIHW -> OHWI
    got = resblock(xh, w1, b1, w2h, b2, w3, b3)
    got2 = resblock(xh, w1.view(Cm, C), b1, w2h, b2, w3.view(C, Cm), b3)
    np.testing.assert_array_equal(got.numpy(), got2.numpy())
    op = _make_op(n, C, H, W, Cm)
    ref = jax_template("resblock").ref_impl(op, *[t.numpy() for t in
                                                  (x, w1, b1, w2, b2, w3, b3)])
    np.testing.assert_allclose(got.numpy().transpose(0, 3, 1, 2), ref,
                               rtol=3e-5, atol=3e-5)
    # bf16 operands: h1 and h2 are stored in bf16, the output rounded once
    ops16 = [t.bfloat16() for t in (xh, w1, b1, w2h, b2, w3, b3)]
    y16 = resblock(*ops16, out_dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        y16.float().numpy(),
        resblock_plain(*ops16, out_dtype=torch.bfloat16).float().numpy())


# ResNet-50's identity bottlenecks: (H=W, C, Cm) of res2b, res3b, res4b, res5b
RESNET50 = {"res2": (56, 256, 64), "res3": (28, 512, 128),
            "res4": (14, 1024, 256), "res5": (7, 2048, 512)}


def _mma_smem(p, W, Cm):
    """Dynamic shared memory of the tensor-core route (csrc/resblock.cu
    configure): 1 KB to align, the 3-stage ring, h2 padded to whole tiles
    and h1, in 128-byte rows per 64 channels."""
    rows1, rows2 = (p.ty + 2) * (W + 2), p.ty * W
    rows2p = -(-rows2 // p.tile_m) * p.tile_m
    return 1024 + 3 * (p.tile_m + p.tile_n) * 128 \
        + (Cm // 64) * (rows1 + rows2p) * 128


# (stage, elem bytes, SMs, n) -> (ty, cluster, tile_m, tile_n): the plan's
# choices, pinned; those at 132 SMs and batch 32, and res5 at batch 1, are
# within 2% of the fastest of the smoke's `resblock plan` sweep on an H100
PLANS = {
    ("res2", 4, 132, 32): (2, 1, 128, 64),
    ("res2", 4, 132, 1): (1, 4, 128, 64),
    ("res2", 4, 114, 32): (2, 1, 128, 64),
    ("res2", 4, 114, 1): (1, 2, 128, 64),
    ("res2", 2, 132, 32): (7, 1, 128, 64),
    ("res2", 2, 132, 1): (2, 4, 128, 64),
    ("res2", 2, 114, 32): (8, 1, 128, 64),
    ("res2", 2, 114, 1): (1, 2, 128, 64),
    ("res3", 4, 132, 32): (4, 1, 128, 128),
    ("res3", 4, 132, 1): (1, 8, 128, 64),
    ("res3", 4, 114, 32): (4, 1, 128, 128),
    ("res3", 4, 114, 1): (1, 4, 128, 64),
    ("res3", 2, 132, 32): (4, 1, 128, 128),
    ("res3", 2, 132, 1): (1, 4, 128, 128),
    ("res3", 2, 114, 32): (4, 1, 128, 128),
    ("res3", 2, 114, 1): (2, 4, 128, 128),
    ("res4", 4, 132, 32): (4, 1, 128, 128),
    ("res4", 4, 132, 1): (1, 8, 128, 64),
    ("res4", 4, 114, 32): (2, 1, 128, 128),
    ("res4", 4, 114, 1): (1, 8, 128, 64),
    ("res4", 2, 132, 32): (7, 2, 64, 128),
    ("res4", 2, 132, 1): (1, 8, 64, 128),
    ("res4", 2, 114, 32): (5, 1, 128, 128),
    ("res4", 2, 114, 1): (2, 8, 64, 128),
    ("res5", 4, 132, 32): (4, 2, 128, 128),
    ("res5", 4, 132, 1): (1, 8, 128, 64),
    ("res5", 4, 114, 32): (1, 1, 128, 128),
    ("res5", 4, 114, 1): (1, 8, 128, 64),
    ("res5", 2, 132, 32): (4, 2, 64, 128),
    ("res5", 2, 132, 1): (1, 8, 64, 128),
    ("res5", 2, 114, 32): (7, 2, 64, 128),
    ("res5", 2, 114, 1): (1, 8, 64, 128),
}


@pytest.mark.parametrize("n", [32, 1])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("stage", list(RESNET50))
def test_resblock_plan_at_resnet50_shapes(stage, elem, sms, n):
    H, C, Cm = RESNET50[stage]
    p = resblock_plan(n, H, H, C, Cm, elem, sms)
    assert isinstance(p, ResblockPlan)
    # bf16 at ResNet's channel counts runs on the tensor cores, f32 on FFMA
    # with 16-byte loads
    assert p.route == ("mma" if elem == 2 else "ffma")
    assert p.vec == (elem == 4)
    assert 1 <= p.ty <= H and p.cluster in CLUSTERS
    assert Cm % p.cluster == 0 and C % p.cluster == 0
    assert p.blocks == n * -(-H // p.ty) * p.cluster
    if p.route == "mma":
        assert (p.tile_m, p.tile_n) in ((128, 128), (128, 64), (64, 128))
        assert p.tile_n <= Cm
        assert p.smem == _mma_smem(p, H, Cm) <= SMEM_MAX
    else:
        assert p.tile_m == 128 and p.tile_n in (64, 128)
        assert p.smem == ((p.ty + 2) * (H + 2) + p.ty * H) * Cm * elem
        assert p.smem + ffma_static_smem(p.tile_n) <= SMEM_MAX
    # the grid covers at least two fifths of the card wherever the shape
    # has that many (image row, channel split) pairs
    assert p.blocks >= min(sms, n * H * max(CLUSTERS)) * 2 // 5
    assert (p.ty, p.cluster, p.tile_m, p.tile_n) == PLANS[stage, elem, sms, n]


@pytest.mark.parametrize("case", ["ragged-bf16", "ragged-f32", "vec-f32",
                                  "wide-row", "too-wide", "cached"])
def test_resblock_plan_edge_cases(case):
    if case == "ragged-bf16":
        # channels off the 64-value K chunk: bf16 on the FFMA route, staged
        # element by element
        p = resblock_plan(2, 9, 7, 32, 8, 2, 132)
        assert (p.route, p.vec) == ("ffma", False)
    elif case == "ragged-f32":
        p = resblock_plan(2, 5, 6, 12, 5, 4, 132)
        assert (p.route, p.vec, p.cluster) == ("ffma", False, 1)
    elif case == "vec-f32":
        p = resblock_plan(1, 10, 10, 16, 8, 4, 132)
        assert (p.route, p.vec) == ("ffma", True)
    elif case == "wide-row":
        # one band row of 150 pixels x 64 channels in f32 fits only at ty=1
        p = resblock_plan(1, 4, 150, 64, 64, 4, 132)
        assert p.ty == 1 and p.smem == (3 * 152 + 150) * 64 * 4
    elif case == "too-wide":
        with pytest.raises(RtErr, match="do not fit"):
            resblock_plan(1, 4, 300, 64, 64, 4, 132)
    else:
        assert resblock_plan(32, 7, 7, 2048, 512, 2, 132) is \
            resblock_plan(32, 7, 7, 2048, 512, 2, 132)


def test_resblock_refuses_what_the_kernel_does_not_take():
    n, C, H, W, Cm = 1, 8, 4, 4, 4
    x, w1, b1, w2, b2, w3, b3 = [torch.from_numpy(a)
                                 for a in _args(n, C, H, W, Cm)]
    xh = x.permute(0, 2, 3, 1).contiguous()
    w2 = w2.permute(0, 2, 3, 1).contiguous()      # OIHW -> OHWI
    ok = (w1, b1, w2, b2, w3, b3)
    assert resblock(xh, *ok).shape == (n, H, W, C)
    with pytest.raises(RtErr, match="contiguous"):
        resblock(x.permute(0, 2, 3, 1), *ok)
    with pytest.raises(RtErr, match="expected 4-d"):
        resblock(xh[0], *ok)
    with pytest.raises(RtErr, match="w1 is"):
        resblock(xh, torch.zeros(Cm, C + 1), b1, w2, b2, w3, b3)
    with pytest.raises(RtErr, match="w3 is"):
        resblock(xh, w1, b1, w2, b2, torch.zeros(C, Cm, 3, 3), b3)
    with pytest.raises(RtErr, match="w2 is"):
        resblock(xh, w1, b1, torch.zeros(Cm, Cm, 1, 1), b2, w3, b3)
    # the 3x3 filter comes in OHWI order, [Cm, 3, 3, Cm]: OIHW is refused
    with pytest.raises(RtErr, match=r"w2 is \(4, 4, 3, 3\), expected OHWI"):
        resblock(xh, w1, b1, torch.zeros(Cm, Cm, 3, 3), b2, w3, b3)
    with pytest.raises(RtErr, match="b3 length"):
        resblock(xh, w1, b1, w2, b2, w3, b1)
    with pytest.raises(RtErr, match="but b2 is"):
        resblock(xh, w1, b1, w2, b2.bfloat16(), w3, b3)
    with pytest.raises(RtErr, match="dtype torch.float64"):
        resblock(xh.double(), *[t.double() for t in ok])
    with pytest.raises(RtErr, match="output dtype"):
        resblock(xh, *ok, out_dtype=torch.float16)
    with pytest.raises(RtErr, match="no kernel for device 'meta'"):
        resblock(xh.to("meta"), *[t.to("meta") for t in ok])
