"""cnet-infer: run a CNN on image stream blocks, in-process.

Capability parity with the reference's net-in-the-loop streaming demos
(cap_app.cc:254 `capture_classify` / :298 `capture_feats`: camera frames
→ run_cnet → top-k display). The frame source is any image-producing
data-stream stage, and the result rides the stream: each block gains a
named subblock `pred` holding the top-k (class, prob) rows and a meta
text line.

The engine is the same ConvFwd used by run_cnet (`engine=torch` on the
card by default, `engine=ref` float64 numpy), with frames
resized/mean-subtracted through io.img.img_to_batch.

The port's copy of the cnet-infer stage of boda_tpu/apps/stream_infer.py;
feats_node's channel-map montage is drawn by io/disp.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.config import Attr, register
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..engine.iface import ConvFwd
from ..io.data_stream import DataBlock, DataStream


@register(DataStream, "cnet-infer",
          help="run a CNN on image blocks; attach top-k predictions "
               "(capture_classify parity, net in-process)")
class CnetInferStream(DataStream):
    model = Attr(str, default="", help="model zoo name")
    ptt_fn = Attr(str, default="", help="prototxt filename")
    trained_fn = Attr(str, default="", help="caffemodel filename")
    in_dims = Attr(Dims, default=None, help="override net input dims")
    batch = Attr(int, default=1)
    conv_fwd = Attr(ConvFwd, default="torch", help="execution engine")
    out_node = Attr(str, default="", help="output node (default: top)")
    top_k = Attr(int, default=5)
    label_fn = Attr(str, default="", help="label names, one per line")
    pred_tag = Attr(str, default="pred",
                    help="named-subblock tag for the (top_k,2) "
                         "[class,prob] result nda")
    feats_node = Attr(str, default="",
                      help="also fetch this node's feature maps and "
                           "attach a per-channel montage image as an "
                           "'img' subblock (capture_feats role, "
                           "cap_app.cc:298)")
    feats_max_chans = Attr(int, default=64,
                           help="montage at most this many channels")
    preprocessed = Attr(str, default="auto",
                        help="float-block handling: 1 = blocks are "
                             "already net-input preprocessed (lmdb-src "
                             "mean/scale) and are fed unresized with no "
                             "further mean subtraction; 0 = blocks are "
                             "raw [0,255] pixels (video-src) and take "
                             "the image path (resize + mean-sub); "
                             "auto = floats with negatives or max<=1 "
                             "count as preprocessed")

    def data_stream_init(self):
        from ..graph.modes import _load_pipe
        self._pipe = _load_pipe(self)
        self._pipe.out_node_name = self.out_node
        self.conv_fwd.init(self._pipe)
        self._data_node = self._pipe.data_img_node_names[0]
        self._top = (self._pipe.must_get_node(self.out_node).name
                     if self.out_node
                     else self._pipe.get_single_top_node().name)
        self._labels = None
        if self.label_fn:
            if not Path(self.label_fn).exists():
                raise RtErr(f"cnet-infer: label_fn '{self.label_fn}' "
                            f"not found")
            self._labels = [ln.strip() for ln in
                            Path(self.label_fn).read_text().splitlines()]

    def _label(self, i: int) -> str:
        if self._labels and i < len(self._labels):
            return self._labels[i]
        return f"class_{i}"

    def proc_block(self, db: DataBlock) -> DataBlock:
        from ..io.img import img_to_batch
        if not db.valid() or db.nda is None:
            return db
        img = np.asarray(db.nda.v)
        if img.ndim != 3:
            raise RtErr(f"cnet-infer: expected a 3-d image block, got "
                        f"{img.shape}")
        if img.shape[2] in (3, 4):     # (y,x,C) — img-dir-src, data-to-img
            img = img[:, :, :3]        # drop alpha (reference img_t is RGBA)
            chw_in = False
        elif img.shape[0] in (3, 4):   # (C,y,x) — video-src, lmdb-src
            img = img[:3]
            chw_in = True
        else:
            raise RtErr(f"cnet-infer: can't infer image layout from "
                        f"shape {img.shape} (want (y,x,3|4) or (3|4,y,x))")
        dims = self._pipe.get_data_img_dims()
        is_float = np.issubdtype(img.dtype, np.floating)
        if self.preprocessed == "auto":
            # raw-pixel float frames (video-src: RGB in [0,255]) are
            # non-negative with max > 1; mean/scale-normalized blocks
            # (lmdb-src) have negatives (pixels below the mean) or sit
            # in a unit range
            pre = is_float and (float(img.min()) < 0.0
                                or float(img.max()) <= 1.0)
        else:
            pre = self.preprocessed not in ("0", "", "false")
        if is_float and pre:
            # already-preprocessed float block (lmdb-src applies caffe
            # transform_param mean/scale): feed as-is — the uint8 image
            # path (PIL resize + BGR mean subtraction) would wrap
            # negatives and subtract the mean a second time
            chw = img if chw_in else np.transpose(img, (2, 0, 1))
            if chw.shape[1:] != (dims["y"], dims["x"]):
                raise RtErr(
                    f"cnet-infer: float block spatial {chw.shape[1:]} != "
                    f"net input ({dims['y']},{dims['x']}); float blocks "
                    f"are fed unresized — set in_dims to match or resize "
                    f"upstream")
            batch = np.broadcast_to(
                chw[None].astype(np.float32), dims.shape).copy()
            blob = NDA(dims, batch)
        else:
            if chw_in:
                img = np.transpose(img, (1, 2, 0))
            if is_float:
                img = np.clip(img, 0, 255).astype(np.uint8)
            blob = img_to_batch(img, dims)
        want = [self._top]
        if self.feats_node:
            want.append(self.feats_node)
        outs = self.conv_fwd.run_fwd({self._data_node: blob}, want)
        out = outs[self._top]
        if self.feats_node:
            db = self._attach_feats(db, outs[self.feats_node])
        p = np.asarray(out.v[0], np.float32).reshape(-1)
        k = min(self.top_k, p.size)
        top = np.argsort(p)[::-1][:k]
        rows = np.stack([top.astype(np.float32), p[top]], axis=1)
        pred = DataBlock(NDA(Dims.make(tn="float", obj=k, cls_prob=2),
                             rows), tag=self.pred_tag)
        pred.timestamp_ns = db.timestamp_ns
        db.set_sdb(pred)
        db.meta = " ".join(f"{self._label(int(i))}:{p[i]:.4f}" for i in top)
        return db

    def get_pos_info_str(self) -> str:
        return f"cnet-infer[{self.model or self.ptt_fn}->{self._top}]"

    def _attach_feats(self, db: DataBlock, feats: NDA) -> DataBlock:
        """Montage the first feats_max_chans channel maps into one image
        subblock tagged 'img' (the capture_feats display, file-backed)."""
        from ..io.disp import make_montage, nda_to_img
        v = np.asarray(feats.v, np.float32)
        if v.ndim == 4:          # (img, chan, y, x) — first image
            v = v[0]
        if v.ndim != 3:
            raise RtErr(f"cnet-infer: feats node '{self.feats_node}' is "
                        f"not a (chan,y,x) map: dims {feats.dims.pretty()}")
        tiles = [nda_to_img(v[c]) for c in
                 range(min(v.shape[0], self.feats_max_chans))]
        img = make_montage(tiles)
        dims = Dims([("y", img.shape[0]), ("x", img.shape[1]),
                     ("chan", 3)], tn="uint8_t")
        sdb = DataBlock(NDA(dims, img), tag="img", meta="image",
                        frame_ix=db.frame_ix, timestamp_ns=db.timestamp_ns)
        db.set_sdb(sdb)
        return db
