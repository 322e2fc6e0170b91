"""run_cnet / cnet_predict: the canonical single-net inference drivers.

Capability parity with caffeif.{H,cc}: run_cnet_t (load net+weights → pipe
→ engine → forward, caffeif.cc:163-210; single-blob helpers :104-106) and
cnet_predict_t (ImageNet classification: top-k with labels, temporal prob
filtering, caffeif.H:121-161).

The port's copy of boda_tpu/apps/run_cnet.py, whose default engine is
engine=torch. Left out: the 2x-upsampled companion net
(enable_upsamp_net) and cnet_predict's dense path and annotated output
(dense, anno_fn and their thresholds), which need the JAX package's
pyramid, prediction and display modules.
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

    def setup_cnet(self):
        from ..graph.modes import _load_pipe
        with timer("setup_cnet"):
            self.pipe = _load_pipe(self)
            self.pipe.out_node_name = self.out_node
            self.conv_fwd.init(self.pipe)
        return self.pipe

    def run_one_blob_in_one_blob_out(self, blob: NDA) -> NDA:
        """reference: conv_pipe_t::run_one_blob_in_one_blob_out
        (conv_util.cc:921)."""
        data_node = self.pipe.data_img_node_names[0]
        top = self.pipe.get_single_top_node().name
        return self.conv_fwd.run_fwd({data_node: blob}, [top])[top]


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

    def base_setup(self):
        self._filt_prob = None

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

    def main(self):
        from ..io.img import img_to_batch, load_img, make_test_pattern_img
        pipe = self.setup_cnet()
        d = pipe.get_data_img_dims()
        img = load_img(self.img_fn) if self.img_fn else make_test_pattern_img(d["y"], d["x"])
        out = self.run_one_blob_in_one_blob_out(img_to_batch(img, d))
        preds = self.do_predict(out.v[0])
        for rank, (idx, p, lbl) in enumerate(preds, 1):
            print(f"#{rank}: {lbl} (class {idx}) p={p:.5f}")
