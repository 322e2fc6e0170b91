"""run_cnet / cnet_predict: the canonical single-net inference drivers.

Capability parity with caffeif.{H,cc}: run_cnet_t (load net+weights → pipe
→ engine → forward, caffeif.cc:163-210; single-blob helpers :104-106) and
cnet_predict_t (ImageNet classification: top-k with labels, temporal prob
filtering, caffeif.H:121-161), with the 2x-upsampled companion net
(enable_upsamp_net, caffeif.cc:185-236; models/upsamp.py) and
cnet_predict's dense path (dense: scale infos, NMS grid and annotations,
apps/predict.py).

The port's copy of boda_tpu/apps/run_cnet.py, whose default engines are
engine=torch; cnet_predict's annotated image (anno_fn) is drawn by
io/disp.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.config import Attr
from ..core.digest import nda_digest
from ..core.dims import NDA
from ..core.has_main import mode
from ..core.timers import timer
from ..engine.iface import ConvFwd
from ..graph.modes import _NetMode


class RunCnetBase(_NetMode):
    conv_fwd = Attr(ConvFwd, default="torch", help="execution engine")
    out_node = Attr(str, default="", help="output node (default: single top)")
    enable_upsamp_net = Attr(bool, default=False,
                             help="also build the 2x-upsampled companion "
                                  "net (folded first-conv filters; "
                                  "caffeif.cc:185-236)")
    conv_fwd_upsamp = Attr(ConvFwd, default="torch",
                           help="engine for the companion net")

    def setup_cnet(self):
        from ..graph.modes import _load_pipe
        with timer("setup_cnet"):
            self.pipe = _load_pipe(self)
            self.pipe.out_node_name = self.out_node
            self.conv_fwd.init(self.pipe)
            if self.enable_upsamp_net:
                from ..models.upsamp import make_upsamp_pipe
                self.pipe_upsamp = make_upsamp_pipe(self.pipe)
                self.conv_fwd_upsamp.init(self.pipe_upsamp)
        return self.pipe

    def run_one_blob_in_one_blob_out(self, blob: NDA) -> NDA:
        """reference: conv_pipe_t::run_one_blob_in_one_blob_out
        (conv_util.cc:921)."""
        data_node = self.pipe.data_img_node_names[0]
        top = self.pipe.get_single_top_node().name
        return self.conv_fwd.run_fwd({data_node: blob}, [top])[top]

    def run_one_blob_in_one_blob_out_upsamp(self, blob: NDA) -> NDA:
        """reference: run_one_blob_in_one_blob_out_upsamp (caffeif.cc:105)."""
        data_node = self.pipe_upsamp.data_img_node_names[0]
        top = self.pipe_upsamp.get_single_top_node().name
        return self.conv_fwd_upsamp.run_fwd({data_node: blob}, [top])[top]


@mode("run_cnet", help="load a net and run one forward pass")
class RunCnet(RunCnetBase):
    img_fn = Attr(str, default="", help="input image (else: test pattern)")
    tpd = Attr(int, default=0, help="test-pattern mode if no image")
    digest_fn = Attr(str, default="", help="write output digest here")
    dump_top = Attr(int, default=5, help="print top-N output channels")

    def main(self):
        from ..io.img import img_to_batch, load_img, make_test_pattern_img
        pipe = self.setup_cnet()
        d = pipe.get_data_img_dims()
        if self.img_fn:
            img = load_img(self.img_fn)
        else:
            img = make_test_pattern_img(d["y"], d["x"], self.tpd)
        blob = img_to_batch(img, d)
        out = self.run_one_blob_in_one_blob_out(blob)
        dig = nda_digest(out)
        print(f"run_cnet: out node '{pipe.get_single_top_node().name}' "
              f"dims {out.dims.pretty()}")
        print(f"digest: {dig}")
        if self.digest_fn:
            self.out_path(self.digest_fn).write_text(str(dig) + "\n")
        flat = out.v.reshape(out.v.shape[0], -1)
        for i in range(out.v.shape[0]):
            top = np.argsort(flat[i])[::-1][:self.dump_top]
            tops = " ".join(f"{int(t)}:{flat[i][t]:.4f}" for t in top)
            print(f"img {i} top-{self.dump_top}: {tops}")


@mode("cnet_predict", help="classify an image: top-k with labels")
class CnetPredict(RunCnetBase):
    img_fn = Attr(str, default="", help="input image (else: test pattern)")
    label_fn = Attr(str, default="", help="synset/label names, one per line")
    top_k = Attr(int, default=5)
    filt_rate = Attr(float, default=0.0,
                     help="temporal prob filtering rate (streaming use)")
    anno_fn = Attr(str, default="", help="write the input image annotated "
                   "with the top-1 label here (reference: cnet_predict "
                   "annotated output, caffeif.H:159-160)")
    dense = Attr(bool, default=False,
                 help="use the dense prediction path (scale_infos + NMS "
                      "grid + per-region annos; reference default — "
                      "caffeif.cc setup_scale_infos single-scale case)")
    filt_show_thresh = Attr(float, default=0.02)
    filt_drop_thresh = Attr(float, default=0.005)
    max_num_disp = Attr(int, default=20)
    nms_grid_pels = Attr(list[int], default="25 25")
    nms_core_rat = Attr(float, default=0.75)

    def base_setup(self):
        self._filt_prob = None
        self._dense_pred = None

    def load_labels(self, n: int) -> list[str]:
        if self.label_fn and Path(self.label_fn).exists():
            lines = Path(self.label_fn).read_text().splitlines()
            return [ln.strip() for ln in lines]
        return [f"class_{i}" for i in range(n)]

    def do_predict(self, prob: np.ndarray) -> list[tuple[int, float, str]]:
        """Top-k over (possibly temporally filtered) class probabilities
        (reference: cnet_predict_t prob filtering caffeif.H:136)."""
        p = prob.reshape(-1)
        if self.filt_rate > 0.0:
            if self._filt_prob is None:
                self._filt_prob = p.copy()
            else:
                self._filt_prob = (1 - self.filt_rate) * self._filt_prob + self.filt_rate * p
            p = self._filt_prob
        labels = self.load_labels(len(p))
        top = np.argsort(p)[::-1][:self.top_k]
        return [(int(i), float(p[i]), labels[i] if i < len(labels) else str(i))
                for i in top]

    def do_predict_dense(self, pipe, out) -> list:
        """Single-scale dense path (reference cnet_predict default):
        whole-feature-map region → pred_state → NMS grid → annos."""
        from ..core.geom import Pt
        from .predict import DensePredictor
        if self._dense_pred is None:
            d = pipe.get_data_img_dims()
            top = pipe.get_single_top_node()
            labels = self.load_labels(out.v.shape[1])
            self._dense_pred = DensePredictor(
                labels,
                filt_rate=self.filt_rate if self.filt_rate > 0 else 0.2,
                filt_show_thresh=self.filt_show_thresh,
                filt_drop_thresh=self.filt_drop_thresh,
                max_num_disp=self.max_num_disp,
                nms_grid_pels=Pt(*self.nms_grid_pels),
                nms_core_rat=self.nms_core_rat)
            self._dense_pred.setup_single_scale(
                top.csi, Pt(out.v.shape[2], out.v.shape[3]),
                Pt(d["y"], d["x"]), out.v.shape[1])
        return self._dense_pred.do_predict(out.v, print_to_terminal=True)

    def main(self):
        from ..io.img import img_to_batch, load_img, make_test_pattern_img
        pipe = self.setup_cnet()
        d = pipe.get_data_img_dims()
        img = load_img(self.img_fn) if self.img_fn else make_test_pattern_img(d["y"], d["x"])
        out = self.run_one_blob_in_one_blob_out(img_to_batch(img, d))
        if self.dense:
            annos = self.annos = self.do_predict_dense(pipe, out)
            if self.anno_fn:
                from ..io.disp import annotate_img
                from ..io.img import save_img
                h, w = img.shape[0], img.shape[1]
                draw = [(tuple(np.clip(a.box, 0, [h, w, h, w])),
                         a.str.splitlines()[0] if a.str else "")
                        for a in annos]
                save_img(self.out_path(self.anno_fn), annotate_img(img, draw))
                print(f"wrote {len(annos)} annos to {self.anno_fn}")
            return
        preds = self.do_predict(out.v[0])
        for rank, (idx, p, lbl) in enumerate(preds, 1):
            print(f"#{rank}: {lbl} (class {idx}) p={p:.5f}")
        if self.anno_fn and preds:
            from ..io.disp import annotate_img
            from ..io.img import save_img
            idx, p, lbl = preds[0]
            h, w = img.shape[0], img.shape[1]
            anno = annotate_img(img, [((2, 2, h - 3, w - 3),
                                       f"{lbl} {p:.3f}")])
            save_img(self.out_path(self.anno_fn), anno)
            print(f"wrote annotated image to {self.anno_fn}")
