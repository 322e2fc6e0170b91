"""The dense-inference path of the port on the CPU, against the JAX
package: pyramid scales and bin placement (apps/pyra.py), the host pack,
dense prediction (apps/predict.py), the upsampled companion net
(models/upsamp.py), and the modes conv_pyra, cnet_predict dense=1,
blf_pack and pyra_bench through the port's engine on the CPU
(engine=torch,device=cpu) beside the JAX modes (engine=rtc).

Equal: scales, placements (the port's Python placement against the JAX
package's, native when built), the host pack, the trash mask, the dense
annotations' boxes and labels on the same feature maps, per-scale feature
shapes and pyra_bench's geometry fields. Within 1e-4: the upsampled net's
forward, annotation confidences of the modes, and the feature digests.
Under an odd first-conv pad (ResNet-50's stem), conv_pyra's upsampled
octave is held to the original net on the 2x-upsampled bins instead: the
JAX fold is half a pixel off there (ROADMAP C7).
"""

import copy
import re

import jax
import numpy as np
import pytest

from boda_tpu.apps import predict as jpredict
from boda_tpu.apps import pyra as jpyra
from boda_tpu.core import has_main as jhas_main
from boda_tpu.core.dims import NDA as JNDA
from boda_tpu.core.geom import Pt as JPt
from boda_tpu.engine import iface as jiface
from boda_tpu.graph.support import SupportInfo as JSupportInfo
from boda_tpu.models import upsamp as jupsamp
from boda_tpu.models import zoo as jzoo
import boda_tpu_torch.modes  # noqa: F401  (registers the modes and engines)
from boda_tpu_torch.apps import predict, pyra
from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.geom import Pt
from boda_tpu_torch.core.has_main import create_and_run_has_main
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.graph.support import SupportInfo
from boda_tpu_torch.models import upsamp, zoo
from boda_tpu_torch.testing.comp import read_digest_stream

CPU = "(engine=torch,device=cpu)"
TOL = 1e-4


@pytest.fixture(autouse=True)
def _jnp_fallback(monkeypatch):
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")


def _boxes(places):
    return [(bi, (b.p0.y, b.p0.x, b.p1.y, b.p1.x)) for bi, b in places]


# ---- scales and placement ----

@pytest.mark.parametrize("cfg", [((227, 227), 3, 32, 0), ((100, 100), 2, 32, 1),
                                 ((480, 640), 3, 32, 0), ((37, 90), 4, 8, 0)])
def test_calc_pyra_scales_equal(cfg):
    (y, x), interval, min_sz, up = cfg
    got = pyra.calc_pyra_scales(Pt(y, x), interval, min_sz, up)
    want = jpyra.calc_pyra_scales(JPt(y, x), interval, min_sz, up)
    assert [(s.scale, s.sz.y, s.sz.x) for s in got] == \
        [(s.scale, s.sz.y, s.sz.x) for s in want]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("jimpl", ["auto", "py"])
def test_blf_place_equal_box_for_box(seed, jimpl):
    rng = np.random.RandomState(seed)
    sizes = [(int(a), int(b)) for a, b in rng.randint(4, 120, (14, 2))]
    bin_sz, pad = (128, 160), (int(rng.randint(0, 9)), int(rng.randint(0, 9)))
    got = pyra.blf_place([Pt(*s) for s in sizes], Pt(*bin_sz), Pt(*pad))
    want = jpyra.blf_place([JPt(*s) for s in sizes], JPt(*bin_sz), JPt(*pad),
                           impl=jimpl)
    assert _boxes(got) == _boxes(want)


def test_blf_place_refusals():
    with pytest.raises(RtErr, match="larger than bin"):
        pyra.blf_place([Pt(300, 300)], Pt(256, 256), Pt(0, 0))
    # impl=cpp (the native host core) refuses the same rect, before it is
    # built; an unknown impl is refused
    with pytest.raises(RtErr, match="larger than bin"):
        pyra.blf_place([Pt(300, 300)], Pt(256, 256), Pt(0, 0), impl="cpp")
    with pytest.raises(RtErr, match="unknown impl 'rust'"):
        pyra.blf_place([Pt(3, 3)], Pt(256, 256), Pt(0, 0), impl="rust")


@pytest.mark.parametrize("cfg", [((128, 128), (256, 256), 2, 32, (8, 8)),
                                 ((480, 640), (640, 640), 3, 32, (91, 91))])
def test_img_pyra_pack_host_pack_and_trash_mask_equal(cfg):
    pytest.importorskip("PIL")
    in_sz, bin_sz, interval, min_sz, pad = cfg
    pp = pyra.ImgPyraPack(Pt(*in_sz), Pt(*bin_sz), interval, min_sz, Pt(*pad))
    jpp = jpyra.ImgPyraPack(JPt(*in_sz), JPt(*bin_sz), interval, min_sz,
                            JPt(*pad))
    assert pp.num_bins == jpp.num_bins
    assert [(s.bin_ix, str(s.place)) for s in pp.scales] == \
        [(s.bin_ix, str(s.place)) for s in jpp.scales]
    img = np.random.RandomState(1).randint(0, 256, (*in_sz, 3)) \
        .astype(np.uint8)
    np.testing.assert_array_equal(pp.scale_and_pack_img_into_bins(img),
                                  jpp.scale_and_pack_img_into_bins(img))
    np.testing.assert_array_equal(pp.trash_mask(), jpp.trash_mask())


# ---- dense prediction on the same feature maps ----

def _anno_key(a):
    return (tuple(int(v) for v in a.box), a.item_cnt,
            [ln.split()[0] for ln in a.str.splitlines()])


def _same_annos(got, want, tol=0.0):
    assert [_anno_key(a) for a in got] == [_anno_key(a) for a in want]
    for a, b in zip(got, want):
        assert abs(a.top_prob - b.top_prob) <= tol


def test_dense_predictor_annos_equal():
    """Three frames of the same seeded feature maps (softmax and PDF
    pixels, the temporal filter) through a multi-scale and a single-scale
    predictor of each package."""
    rng = np.random.RandomState(4)
    kw = dict(filt_show_thresh=0.05, max_num_disp=12)
    sizes = [(48, 48), (34, 34), (24, 24)]
    places = [(0, (0, 0)), (1, (0, 0)), (1, (0, 40))]
    labels = [f"lbl{i}" for i in range(6)]
    preds = []
    for pk in ((predict, SupportInfo, Pt), (jpredict, JSupportInfo, JPt)):
        mod, si, pt = pk
        csi = si(support_sz=pt(12, 12), support_stride=pt(4, 4),
                 eff_tot_pad=pt(4, 4))
        multi = mod.DensePredictor(labels, **kw)
        multi.setup_scale_infos(csi, 2, sizes=[pt(*s) for s in sizes],
                                placements=[(b, pt(*p)) for b, p in places],
                                nominal_in_sz=pt(48, 48), num_chans=6,
                                feat_sz=pt(24, 24))
        single = mod.DensePredictor(labels, **kw)
        single.setup_single_scale(csi, pt(5, 7), pt(40, 56), 6)
        preds.append((multi, single))
    for frame in range(3):
        fm = rng.randn(2, 6, 24, 24) * 3
        fm[0, :, :4, :4] = rng.dirichlet(np.ones(6), (4, 4)).transpose(2, 0, 1)
        fs = rng.randn(1, 6, 5, 7) * 2
        outs = [(m.do_predict(fm), s.do_predict(fs)) for m, s in preds]
        assert outs[0][0] and outs[0][1]
        _same_annos(outs[0][0], outs[1][0])
        _same_annos(outs[0][1], outs[1][1])
    for (m, _), (jm, _) in zip([preds[0]], [preds[1]]):
        assert [str(s) for s in m.scale_infos] == \
            [str(s) for s in jm.scale_infos]


# ---- the upsampled companion net ----

def test_fold_filters_and_upsample_equal():
    w = np.random.RandomState(0).randn(4, 3, 7, 5).astype(np.float32)
    np.testing.assert_array_equal(upsamp.fold_filters_2x(w),
                                  jupsamp.fold_filters_2x(w))
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(upsamp.upsample_2x_nn(x),
                                  jupsamp.upsample_2x_nn(x))


def test_make_upsamp_pipe_geometry_and_refusal():
    pipe = zoo.build_model("mini", batch=1, ysz=64, xsz=64)
    up = upsamp.make_upsamp_pipe(pipe, in_dims=pipe.get_data_img_dims()
                                 .with_dim("y", 32).with_dim("x", 32))
    op = upsamp.first_conv_op(up)
    assert (op.kern_sz().y, op.stride().y, op.in_pad().y) == (3, 1, 1)
    assert up.op_params["conv1_filts"].v.shape == (16, 3, 3, 3)
    assert upsamp.make_upsamp_pipe(pipe).get_data_img_dims() == \
        pipe.get_data_img_dims()
    jpipe = jzoo.build_model("mini", batch=1, ysz=64, xsz=64)
    jup = jupsamp.make_upsamp_pipe(jpipe)
    assert {n: str(v.dims) for n, v in upsamp.make_upsamp_pipe(pipe)
            .op_params.items()} == {n: str(v.dims)
                                    for n, v in jup.op_params.items()}
    upsamp.first_conv_op(pipe)._set_param("stride", (3, 3))
    with pytest.raises(RtErr, match="odd stride"):
        upsamp.make_upsamp_pipe(pipe)


@pytest.mark.parametrize("half", [True, False])
def test_upsamp_forward_against_jax(half):
    """The companion net through engine=torch on the CPU against the JAX
    engine=rtc within 1e-4; at half size it also equals the original net
    on the 2x nearest-neighbour input (the folded-filter identity)."""
    pipe = zoo.build_model("mini", batch=1, ysz=64, xsz=64)
    jpipe = jzoo.build_model("mini", batch=1, ysz=64, xsz=64)
    d = pipe.get_data_img_dims()
    ind = d.with_dim("y", 32).with_dim("x", 32) if half else None
    up = upsamp.make_upsamp_pipe(pipe, in_dims=ind)
    jind = jpipe.get_data_img_dims().with_dim("y", 32).with_dim("x", 32) \
        if half else None
    jup = jupsamp.make_upsamp_pipe(jpipe, in_dims=jind)
    ud = up.get_data_img_dims()
    x = np.random.RandomState(0).randn(*ud.shape).astype(np.float32)
    e = make_engine(CPU)
    e.init(up)
    got = e.run_fwd({"data": NDA(ud, x)}, ["prob"])["prob"].v
    je = jiface.make_engine("(engine=rtc,fuse=1)")
    je.init(jup)
    want = je.run_fwd({"data": JNDA(jup.get_data_img_dims(), x)},
                      ["prob"])["prob"].v
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    if half:
        e2 = make_engine(CPU)
        e2.init(pipe)
        full = e2.run_fwd({"data": NDA(d, upsamp.upsample_2x_nn(x))},
                          ["prob"])["prob"].v
        np.testing.assert_allclose(got, full, rtol=2e-4, atol=1e-6)


def test_run_cnet_enable_upsamp():
    from boda_tpu_torch.apps.run_cnet import RunCnet
    t = RunCnet.init_from_lexp(f"(model=mini,in_dims=(dims=(img=1,y=64,x=64)),"
                               f"enable_upsamp_net=1,conv_fwd={CPU},"
                               f"conv_fwd_upsamp={CPU})")
    t.setup_cnet()
    d = t.pipe_upsamp.get_data_img_dims()
    assert d["y"] == 64  # the companion keeps the input size
    x = np.random.RandomState(1).randn(*d.shape).astype(np.float32)
    assert t.run_one_blob_in_one_blob_out_upsamp(NDA(d, x)).v.shape[1] == 10


# ---- the modes, port against JAX ----

@pytest.fixture()
def anno_recorder(monkeypatch):
    """Both packages' DensePredictor.pred_state_to_annos record what they
    return: {'port': [annos per call], 'jax': [...]}."""
    rec = {"port": [], "jax": []}
    for name, cls in (("port", predict.DensePredictor),
                      ("jax", jpredict.DensePredictor)):
        orig = cls.pred_state_to_annos

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            out = _orig(self, *a, **k)
            rec[_name].append(out)
            return out
        monkeypatch.setattr(cls, "pred_state_to_annos", wrapped)
    return rec


def _scale_shapes(out):
    return re.findall(r"scale (\d+) \(s=[\d.]+\): (feats \([\d, ]+\)|no valid "
                      r"features)", out)


@pytest.mark.parametrize("upsamp_net", [0, 1])
def test_conv_pyra_predict_against_jax(tmp_path, capsys, anno_recorder,
                                       upsamp_net):
    """conv_pyra predict=1 (and enable_upsamp_net=1) on the same net and
    image: the same annotations, per-scale feature shapes, and per-scale
    and whole-plane feature digests within 1e-4."""
    pytest.importorskip("PIL")
    base = (f"mode=conv_pyra,model=mini,in_dims=(dims=(img=1,chan=3,y=48,"
            f"x=48)),out_node=conv2,bin_sz=96 96,interval=2,min_sz=24,"
            f"predict=1,filt_show_thresh=0.05,frames=2,"
            f"enable_upsamp_net={upsamp_net},boda_output_dir={tmp_path}")
    jhas_main.create_and_run_has_main(
        f"({base},digest_fn=j.boda,plane_digest_fn=jp.boda)", {})
    jout = capsys.readouterr().out
    hm = create_and_run_has_main(
        f"({base},digest_fn=p.boda,plane_digest_fn=pp.boda,"
        f"conv_fwd=(engine=torch,device=cpu,keep_all_nodes=1),"
        f"conv_fwd_upsamp=(engine=torch,device=cpu,keep_all_nodes=1))", {})
    pout = capsys.readouterr().out
    assert "---- frame -----" in pout and "conv_pyra:" in pout
    assert len(anno_recorder["port"]) == len(anno_recorder["jax"]) == 2
    for got, want in zip(anno_recorder["port"], anno_recorder["jax"]):
        assert got
        _same_annos(got, want, TOL)
    assert hm.annos is anno_recorder["port"][-1]
    assert _scale_shapes(pout) == _scale_shapes(jout) != []
    assert len([s for s in hm.per_scale if s is not None]) == \
        len(re.findall(r"feats \(", jout))
    for p, j in (("p.boda", "j.boda"), ("pp.boda", "jp.boda")):
        got, want = (read_digest_stream(tmp_path / f) for f in (p, j))
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].comp(want[k], TOL) is None, k


@pytest.mark.parametrize("node", ["pool1", "res2a_branch2c"])
def test_conv_pyra_upsamp_octave_under_an_odd_pad(node, tmp_path, capsys,
                                                  monkeypatch):
    """ROADMAP C7 through conv_pyra predict=1,enable_upsamp_net=1, on
    ResNet-50's stem (conv1 7x7/2, pad 3): the companion's planes equal, in
    every upsampled scale's feature box, the original net's planes of the
    packed bins upsampled 2x nearest-neighbour (within 1e-4); and the
    annotations equal those the same predictor gives with those planes in
    the companion's place."""
    seen = {}
    pack = pyra.ImgPyraPack.scale_and_pack_img_into_bins
    pred = predict.DensePredictor.do_predict

    def packed(self, *a, **k):
        seen["packed"] = out = pack(self, *a, **k)
        return out

    def predicted(self, fv, fv_up=None, **k):
        seen.update(predictor=self, fresh=copy.deepcopy(self), fv=fv,
                    fv_up=fv_up)
        return pred(self, fv, fv_up, **k)
    monkeypatch.setattr(pyra.ImgPyraPack, "scale_and_pack_img_into_bins",
                        packed)
    monkeypatch.setattr(predict.DensePredictor, "do_predict", predicted)
    eng = "(engine=torch,device=cpu,keep_all_nodes=1)"
    hm = create_and_run_has_main(
        f"(mode=conv_pyra,model=resnet-50,in_dims=(dims=(img=1,chan=3,"
        f"y=64,x=64)),out_node={node},bin_sz=160 160,interval=2,min_sz=32,"
        f"predict=1,filt_show_thresh=0.05,enable_upsamp_net=1,"
        f"conv_fwd={eng},conv_fwd_upsamp={eng},boda_output_dir={tmp_path})",
        {})
    capsys.readouterr()
    ups = [si for si in seen["predictor"].scale_infos if si.from_upsamp_net]
    assert len(ups) == 2
    from boda_tpu_torch.io.img import img_to_chw
    bins = np.stack([img_to_chw(b) for b in seen["packed"]])
    nb, _, by, bx = bins.shape
    ref = zoo.build_model("resnet-50", batch=nb, ysz=2 * by,
                          xsz=2 * bx).pruned_to(node)
    ref.op_params = hm.conv_fwd.pipe.op_params
    e = make_engine(CPU)
    e.init(ref)
    up = upsamp.upsample_2x_nn(bins)
    want = e.run_fwd({"data": NDA(ref.get_data_img_dims(), up)},
                     [node])[node].v
    got = seen["fv_up"]
    scale = np.abs(want).max()
    for si in ups:
        b = si.feat_box
        assert b.p1.y <= want.shape[2] and b.p1.x <= want.shape[3]
        g = got[si.bix, :, b.p0.y:b.p1.y, b.p0.x:b.p1.x]
        w = want[si.bix, :, b.p0.y:b.p1.y, b.p0.x:b.p1.x]
        assert np.abs(g - w).max() <= TOL * scale, si
    # the original net's planes in the companion's place: the same annos
    aligned = np.zeros_like(got)
    ny, nx = (min(a, c) for a, c in zip(got.shape[2:], want.shape[2:]))
    aligned[:, :, :ny, :nx] = want[:, :, :ny, :nx]
    annos = pred(seen["fresh"], seen["fv"], aligned)
    assert hm.annos
    assert [(a.box, a.str) for a in annos] == \
        [(a.box, a.str) for a in hm.annos]


def test_cnet_predict_dense_against_jax(tmp_path, capsys, anno_recorder):
    jhas_main.create_and_run_has_main(
        "(mode=cnet_predict,model=mini,dense=1)", {})
    jout = capsys.readouterr().out
    hm = create_and_run_has_main(
        f"(mode=cnet_predict,model=mini,dense=1,conv_fwd={CPU})", {})
    pout = capsys.readouterr().out
    assert "---- frame -----" in pout and "---- end frame -----" in pout
    assert len(anno_recorder["port"]) == len(anno_recorder["jax"]) == 1
    _same_annos(anno_recorder["port"][0], anno_recorder["jax"][0], TOL)
    assert hm.annos == anno_recorder["port"][0]
    labels = [ln.split()[0] for ln in pout.split("---- frame -----")[1]
              .split("---- end frame -----")[0].splitlines() if ln.strip()]
    assert labels == [ln.split()[0] for ln in jout.split("---- frame -----")[1]
                      .split("---- end frame -----")[0].splitlines()
                      if ln.strip()]
    # the annotated image (io/disp): the same file as the JAX mode's
    jhas_main.create_and_run_has_main(
        f"(mode=cnet_predict,model=mini,dense=1,anno_fn=a.png,"
        f"boda_output_dir={tmp_path}/j)", {})
    create_and_run_has_main(
        f"(mode=cnet_predict,model=mini,dense=1,conv_fwd={CPU},"
        f"anno_fn=a.png,boda_output_dir={tmp_path}/p)", {})
    assert (tmp_path / "p" / "a.png").read_bytes() == \
        (tmp_path / "j" / "a.png").read_bytes()


def test_blf_pack_mode_equal(tmp_path, capsys):
    spec = (f"(mode=blf_pack,in_sz=128 96,bin_sz=256 256,interval=2,"
            f"min_sz=32,boda_output_dir={tmp_path},out_fn=%s)")
    jhas_main.create_and_run_has_main(spec % "j.txt", {})
    create_and_run_has_main(spec % "p.txt", {})
    capsys.readouterr()
    txt = (tmp_path / "p.txt").read_text()
    assert "num_scales=" in txt and "scale[0]: s=1.0000" in txt
    assert txt == (tmp_path / "j.txt").read_text()


GEOM = re.compile(r"in=(\S+) bins=(\S+) scales=(\d+) out=(\S+) (\w+) "
                  r"pack=(\w+):")


@pytest.mark.parametrize("pack", ["host", "device"])
def test_pyra_bench_geometry_against_jax(capsys, pack):
    if pack == "host":
        pytest.importorskip("PIL")
    spec = ("mode=pyra_bench,model=mini,pack=%s,"
            "in_dims=(dims=(img=1,chan=3,y=48,x=48)),bin_sz=96 96,"
            "interval=2,min_sz=24,iters=2,reps=1,pack_reps=1" % pack)
    jhas_main.create_and_run_has_main(f"({spec})", {})
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    hm = create_and_run_has_main(f"({spec},conv_fwd={CPU})", {})
    pline = capsys.readouterr().out.strip().splitlines()[-1]
    assert GEOM.search(pline).groups() == GEOM.search(jline).groups()
    assert GEOM.search(pline).group(2) == "2x96x96"
    for key in ("pack_ms", "fwd_ms", "frames_per_sec", "overlapped",
                "tflops", "frac_roofline"):
        assert f" {key}=" in pline
    assert hm.forwards == 3 and hm.record["bins"] == 2
    assert (hm.record["dev_pack_ms"] is None) == (pack == "host")
