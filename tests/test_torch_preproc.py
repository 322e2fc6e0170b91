"""Device-side preprocessing of the port (io/device_preproc.py) on the CPU,
against the JAX package's (jax.image.resize and XLA ops), and the
engine's input preprocessing (TorchFwd.set_input_preproc).

The same numpy-seeded uint8 images go through both functions. At the
net's own size there is no resize and the results are equal; a resize
(jax.image.resize's bilinear: its weight matrices, to one f32 ulp) is
held within 1e-3 of JAX on the 0-255 scale, at downscales and upscales,
and within 1e-4 of the same weights applied in float64. The pyramid pack
is held within 1e-3 too, and its uncovered pixels must be exactly -mean
in both.
"""

import jax
import numpy as np
import pytest
import torch

from boda_tpu.apps.pyra import ImgPyraPack as JImgPyraPack
from boda_tpu.core.dims import Dims as JDims
from boda_tpu.core.geom import Pt as JPt
from boda_tpu.io import device_preproc as jdp
from boda_tpu_torch.apps.pyra import ImgPyraPack
from boda_tpu_torch.core.dims import NDA, Dims
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.geom import Pt
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.io import device_preproc as dp
from boda_tpu_torch.io.img import DEFAULT_MEAN_BGR, img_to_chw
from boda_tpu_torch.models.zoo import build_model

RESIZE_TOL = 1e-3


def _imgs(b, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, h, w, 3)) \
        .astype(np.uint8)


@pytest.mark.parametrize("kw", [{}, {"bgr": False}, {"mean": None},
                                {"mean": (1.0, 2.0, 3.0), "bgr": False}])
def test_same_size_is_equal_to_jax_and_to_img_to_chw(kw):
    imgs = _imgs(2, 24, 40)
    got = dp.device_preproc_fn(24, 40, **kw)(torch.from_numpy(imgs)).numpy()
    want = np.asarray(jdp.device_preproc_fn(24, 40, **kw)(imgs))
    assert got.shape == (2, 3, 24, 40) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    host = np.stack([img_to_chw(i, bgr=kw.get("bgr", True),
                                mean=kw.get("mean", DEFAULT_MEAN_BGR))
                     for i in imgs])
    np.testing.assert_array_equal(got, host)


@pytest.mark.parametrize("src,dst", [((64, 80), (32, 32)),   # 0.5, 0.4
                                     ((50, 50), (32, 32)),   # 0.64
                                     ((100, 70), (31, 22)),  # ~0.31
                                     ((16, 20), (32, 32)),   # up
                                     ((24, 40), (40, 24))])  # up and down
def test_resize_within_1e_3_of_jax(src, dst):
    imgs = _imgs(2, *src, seed=src[0])
    got = dp.device_preproc_fn(*dst)(torch.from_numpy(imgs)).numpy()
    want = np.asarray(jdp.device_preproc_fn(*dst)(imgs))
    assert got.shape == want.shape == (2, 3, *dst)
    assert np.abs(got - want).max() <= RESIZE_TOL


@pytest.mark.parametrize("i,o", [(300, 224), (100, 224), (400, 224),
                                 (640, 507), (7, 3), (32, 32)])
def test_resize_weights_are_jax_image_resizes(i, o):
    """The weight matrix of one axis is the one jax.image.resize builds
    (jax/_src/image/scale.py compute_weight_mat, bilinear, antialias), to
    one f32 ulp."""
    from jax._src.image import scale as jscale
    w = np.asarray(jscale.compute_weight_mat(
        i, o, o / i, 0.0, jscale._kernels[jscale.ResizeMethod.LINEAR], True))
    np.testing.assert_allclose(dp._weight_mat(i, o), w, rtol=0, atol=6e-8)


@pytest.mark.parametrize("src,dst", [((300, 400), (224, 224)),
                                     ((100, 150), (224, 224)),
                                     ((240, 320), (151, 201))])
def test_resize_within_1e_4_of_float64(src, dst):
    """The contraction in full FP32 stays within 1e-4 (0-255 scale) of the
    same weights applied in float64, at sizes where the JAX package's CPU
    result is 1e-3 to 3e-3 off it."""
    x = _imgs(2, *src, seed=9).astype(np.float32)
    wy = dp._weight_mat(src[0], dst[0]).astype(np.float64)
    wx = dp._weight_mat(src[1], dst[1]).astype(np.float64)
    ref = np.einsum("byxc,xX->byXc",
                    np.einsum("byxc,yY->bYxc", x.astype(np.float64), wy), wx)
    got = dp.resize_nhwc(torch.from_numpy(x), *dst, {}).numpy()
    assert np.abs(got - ref).max() <= 1e-4


def test_out_dtype_and_make_device_preproc():
    imgs = _imgs(1, 20, 20)
    f = dp.make_device_preproc(10, 10, dtype="float16")
    got = f(torch.from_numpy(imgs))
    assert got.dtype == torch.float16 and not got.requires_grad
    want = np.asarray(jdp.make_device_preproc(10, 10, dtype="float16")(imgs))
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=1e-3, atol=RESIZE_TOL)


def test_preprocess_batch_nda_matches_jax():
    imgs = _imgs(3, 40, 30)
    got = dp.preprocess_batch_nda(imgs, Dims.make(img=3, chan=3, y=32, x=32),
                                  device="cpu")
    want = jdp.preprocess_batch_nda(imgs, JDims.make(img=3, chan=3, y=32,
                                                     x=32))
    assert got.v.shape == (3, 3, 32, 32)
    assert np.abs(got.v - np.asarray(want.v)).max() <= RESIZE_TOL


@pytest.mark.parametrize("cfg", [((128, 128), (256, 256), 2, 32, (8, 8)),
                                 ((96, 80), (128, 128), 3, 24, (10, 6)),
                                 ((48, 64), (64, 96), 2, 16, (4, 4))])
def test_pyra_pack_within_1e_3_of_jax(cfg):
    in_sz, bin_sz, interval, min_sz, pad = cfg
    pp = ImgPyraPack(Pt(*in_sz), Pt(*bin_sz), interval, min_sz, Pt(*pad))
    jpp = JImgPyraPack(JPt(*in_sz), JPt(*bin_sz), interval, min_sz,
                       JPt(*pad))
    frame = _imgs(1, *in_sz, seed=3)[0]
    got = dp.make_device_pyra_pack(pp)(torch.from_numpy(frame)).numpy()
    want = np.asarray(jax.jit(jdp.make_device_pyra_pack(jpp))(
        frame.astype(np.float32)))
    assert got.shape == want.shape == (pp.num_bins, 3, *bin_sz)
    assert np.abs(got - want).max() <= RESIZE_TOL
    # the full-scale placement is the frame itself, exactly
    s0 = pp.scales[0]
    b = s0.place
    np.testing.assert_array_equal(
        got[s0.bin_ix, :, b.p0.y:b.p1.y, b.p0.x:b.p1.x], img_to_chw(frame))
    # uncovered pixels are exactly 0 - mean (BGR), in both packages
    m = pp.trash_mask()
    assert m.any()
    mean = -np.asarray(DEFAULT_MEAN_BGR, np.float32)
    for out in (got, want):
        trash = out.transpose(0, 2, 3, 1)[m]
        np.testing.assert_array_equal(trash, np.broadcast_to(mean,
                                                             trash.shape))


def test_prefetch_feeder_yields_every_batch_in_order():
    batches = [_imgs(2, 20, 24, seed=i) for i in range(5)]
    fed = list(dp.PrefetchFeeder(iter(batches), 16, 16, device="cpu"))
    assert len(fed) == 5
    pre = dp.device_preproc_fn(16, 16)
    for got, b in zip(fed, batches):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      pre(torch.from_numpy(b)).numpy())
    assert list(dp.PrefetchFeeder(iter([]), 16, 16, device="cpu")) == []


def test_prefetch_feeder_refuses_a_card_that_is_not_there():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RtErr, match="CUDA is not available"):
        dp.PrefetchFeeder(iter([]), 16, 16)


# ---- the engine's input preprocessing ----

def _u8_engine(spec="(engine=torch,device=cpu)", b=2):
    pipe = build_model("mini", batch=b)
    eng = make_engine(spec)
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    wire = Dims.make(tn="uint8_t", img=b, y=d["y"], x=d["x"], chan=3)
    return pipe, eng, d, wire


@pytest.mark.parametrize("tune", ["()", "(prec=bf16,layout=nhwc)"])
def test_set_input_preproc_equals_the_host_path(tune):
    """A u8 wire batch through set_input_preproc gives the forward of the
    host-preprocessed f32 batch (under NHWC bf16 storage too)."""
    spec = f"(engine=torch,device=cpu,op_tune={tune})"
    pipe, eng, d, wire = _u8_engine(spec)
    imgs = _imgs(2, d["y"], d["x"], seed=5)
    host = np.stack([img_to_chw(i) for i in imgs])
    want = eng.run_fwd({"data": NDA(d, host)}, ["prob"])["prob"].v
    eng.set_input_preproc("data", dp.device_preproc_fn(d["y"], d["x"]), wire)
    got = eng.run_fwd({"data": NDA(wire, imgs)}, ["prob"])["prob"].v
    np.testing.assert_array_equal(got, want)


def test_set_input_preproc_checks_the_wire_and_its_output():
    pipe, eng, d, wire = _u8_engine()
    eng.set_input_preproc("data", dp.device_preproc_fn(d["y"], d["x"]), wire)
    # the plan's f32 NCHW batch is not the declared wire, nor is an f32
    # batch of the wire's shape
    with pytest.raises(RtErr, match="!= the declared wire dims"):
        eng.run_fwd({"data": NDA(d, np.zeros(d.shape, np.float32))},
                    ["prob"])
    f32 = Dims.make(tn="float", img=2, y=d["y"], x=d["x"], chan=3)
    with pytest.raises(RtErr, match="dtype torch.float32 != torch.uint8 "
                                    r"\(the declared wire dims\)"):
        eng.run_fwd({"data": NDA(f32, np.zeros(f32.shape, np.float32))},
                    ["prob"])
    bad = Dims.make(tn="uint8_t", img=2, y=d["y"] + 1, x=d["x"], chan=3)
    with pytest.raises(RtErr, match="!= the declared wire dims"):
        eng.run_fwd({"data": NDA(bad, np.zeros(bad.shape, np.uint8))},
                    ["prob"])
    # a transform whose output is not the plan's input is refused
    eng.set_input_preproc("data", dp.device_preproc_fn(d["y"], d["x"] - 1),
                          wire)
    with pytest.raises(RtErr, match="the output of its input preprocessing"):
        eng.run_fwd({"data": NDA(wire, np.zeros(wire.shape, np.uint8))},
                    ["prob"])
    with pytest.raises(RtErr, match="not input nodes of the plan"):
        eng.set_input_preproc("conv1", lambda v: v, wire)


def test_set_input_preproc_refused_under_fuse_0_and_by_engine_ref():
    """The per-call mode raises the JAX engine's text (rtc_fwd.py:416);
    an engine without preprocessing raises the interface's
    (iface.py:33-39), as the JAX engine=ref does."""
    from boda_tpu.core.error import RtErr as JRtErr
    from boda_tpu.engine import iface as jiface
    from boda_tpu.models import zoo as jzoo
    texts = []
    for spec in ("(engine=torch,device=cpu,fuse=0)", "(engine=ref)"):
        pipe, eng, d, wire = _u8_engine(spec)
        with pytest.raises(RtErr) as e:
            eng.set_input_preproc("data", lambda v: v, wire)
        texts.append(str(e.value))
    jtexts = []
    for spec in ("(engine=rtc,fuse=0)", "(engine=ref)"):
        jeng = jiface.make_engine(spec)
        jeng.init(jzoo.build_model("mini", batch=2))
        with pytest.raises(JRtErr) as e:
            jeng.set_input_preproc("data", lambda v: v)
        jtexts.append(str(e.value))
    assert texts == jtexts
    assert texts[0] == "set_input_preproc requires the fused engine (fuse=1)"
