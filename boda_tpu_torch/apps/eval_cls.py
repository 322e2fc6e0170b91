"""Classification accuracy and agreement over labeled streams.

The port's copy of part of boda_tpu/apps/eval_cls.py: `score_batch`; the
labeled sources `labeled-npy-src`, `shapes-src` (the procedural dataset of
io/synth.py) and `lmdb-src` (caffe Datums, read by the real `lmdb` module
when installed, else by utils/lmdbmini.py) with `encode_datum`; and the
modes `test_lmdb` (reference: lmdb_caffe_io.cc:36-62) and `cls_agree`,
whose default engines are engine=torch; and the LMDB modes
`lmdb_parse_datums`, `lmdb_bench`, `display_lmdb` and `gen_lmdb`.

Labeled block convention: block.nda = one image (chan,y,x float32,
already preprocessed) and a named subblock 'label' holding a 1-elem
int/float nda with the ground-truth class index.
"""

from __future__ import annotations

import numpy as np

from ..core.config import Attr, register
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.has_main import HasMain, mode
from ..core.timers import timer
from ..engine.iface import ConvFwd
from ..io.data_stream import DataBlock, DataStream
from .run_cnet import RunCnetBase


def score_batch(out_batch: np.ndarray, labels_gt: list[int],
                top_k: int = 1) -> int:
    """Count batch rows whose gt label is in the top-k output channels
    (reference: score_batch, lmdb_caffe_io.cc:10-34)."""
    assert out_batch.ndim == 4 and out_batch.shape[2:] == (1, 1)
    num_out = out_batch.shape[1]
    num_pos = 0
    for i, gt in enumerate(labels_gt):
        if not gt < num_out:
            raise RtErr(f"gt output index too large for number of network "
                        f"outputs: i={i} batch_labels_gt[i]={gt} "
                        f"num_out={num_out} -- gt data / network mismatch?")
        p = out_batch[i, :, 0, 0]
        top = np.argsort(-p)[:top_k]
        if gt in top:
            num_pos += 1
    return num_pos


@register(DataStream, "labeled-npy-src",
          help="labeled image blocks from images.npy + labels.npy")
class LabeledNpySrc(DataStream):
    images_fn = Attr(str, req=True, help=".npy of images (N,chan,y,x) float32")
    labels_fn = Attr(str, req=True, help=".npy of int labels (N,)")
    tag = Attr(str, default="data")

    def data_stream_init(self):
        self._imgs = np.load(self.images_fn, mmap_mode="r")
        self._labels = np.load(self.labels_fn)
        if self._imgs.shape[0] != self._labels.shape[0]:
            raise RtErr(f"labeled-npy-src: {self._imgs.shape[0]} images but "
                        f"{self._labels.shape[0]} labels")
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self._ix >= self._imgs.shape[0]:
            return DataBlock()
        v = np.ascontiguousarray(self._imgs[self._ix], dtype=np.float32)
        if v.ndim != 3:
            raise RtErr("labeled-npy-src: images must be (N,chan,y,x)")
        dims = Dims.make(tn="float", chan=v.shape[0], y=v.shape[1], x=v.shape[2])
        ret = DataBlock(NDA(dims, v), tag=self.tag, frame_ix=self._ix,
                        timestamp_ns=self._ix)
        lab = DataBlock(NDA(Dims.make(tn="float", v=1),
                            np.array([self._labels[self._ix]], np.float32)),
                        tag="label")
        ret.set_sdb(lab)
        self._ix += 1
        return ret

    def seek_to_block(self, frame_ix: int) -> bool:
        self._ix = min(frame_ix, self._imgs.shape[0])
        return True

    def get_pos_info_str(self) -> str:
        return f"labeled-npy-src: {self._ix}/{self._imgs.shape[0]}"


@register(DataStream, "shapes-src",
          help="labeled blocks from the procedural shapes dataset")
class ShapesSrc(DataStream):
    """Deterministic trainable dataset (io/synth.py): image i is a pure
    function of (seed, start_ix + i), so train/val splits are index
    ranges reproducible in any process. Images are pre-rendered once at
    first init (re-init after EOF — cnet_train's epoch wrap — reuses the
    cache) and served preprocessed: (pixel - mean) * scale."""

    num_imgs = Attr(int, req=True)
    start_ix = Attr(int, default=0, help="first dataset index (split base)")
    ysz = Attr(int, default=32)
    xsz = Attr(int, default=32)
    num_classes = Attr(int, default=10)
    seed = Attr(int, default=0)
    mean = Attr(float, default=128.0)
    scale = Attr(float, default=1.0 / 64.0)
    tag = Attr(str, default="data")

    def data_stream_init(self):
        from ..io.synth import render_shapes
        if getattr(self, "_imgs", None) is None:
            self._imgs, self._labels = render_shapes(
                range(self.start_ix, self.start_ix + self.num_imgs),
                self.ysz, self.xsz, self.num_classes, self.seed)
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self._ix >= self.num_imgs:
            return DataBlock()
        v = (self._imgs[self._ix].astype(np.float32) - self.mean) * self.scale
        ret = DataBlock(NDA(Dims.make(tn="float", chan=3, y=self.ysz,
                                      x=self.xsz), v),
                        tag=self.tag, frame_ix=self._ix,
                        timestamp_ns=self._ix)
        ret.set_sdb(DataBlock(NDA(Dims.make(tn="float", v=1),
                                  np.array([self._labels[self._ix]],
                                           np.float32)), tag="label"))
        self._ix += 1
        return ret

    def seek_to_block(self, frame_ix: int) -> bool:
        self._ix = min(frame_ix, self.num_imgs)
        return True

    def get_pos_info_str(self) -> str:
        return f"shapes-src: {self._ix}/{self.num_imgs}"


def encode_datum(img_u8: np.ndarray, label: int) -> bytes:
    """Serialize a caffe Datum (caffe.proto fields: 1=channels 2=height
    3=width 4=data 5=label) for LMDB fixtures."""
    from ..graph.pbwire import enc_field_bytes, enc_field_varint
    c, y, x = img_u8.shape
    return (enc_field_varint(1, c) + enc_field_varint(2, y)
            + enc_field_varint(3, x)
            + enc_field_bytes(4, np.ascontiguousarray(img_u8, np.uint8).tobytes())
            + enc_field_varint(5, int(label)))


def open_lmdb_kv_iter(fn: str):
    """(key, value) iterator over an LMDB env: the real `lmdb` module when
    installed, else the built-in pure-Python reader (utils/lmdbmini.py)."""
    try:
        import lmdb
        env = lmdb.open(fn, readonly=True, lock=False)
        txn = env.begin()
        return iter(txn.cursor())
    except ImportError:
        from ..utils.lmdbmini import LmdbMini
        return LmdbMini(fn).items()


@register(DataStream, "lmdb-src",
          help="labeled blocks from a caffe-Datum LMDB")
class LmdbSrc(DataStream):
    """Reference: lmdb_parse_datums_t + parse_datum (lmdbif.cc,
    caffepb.H:39). Datum wire fields: 1=channels 2=height 3=width
    4=data(bytes) 5=label."""

    fn = Attr(str, req=True, help="lmdb directory")
    tag = Attr(str, default="data")
    mean = Attr(float, default=0.0, help="scalar mean subtracted from pixels")
    scale = Attr(float, default=1.0,
                 help="multiplier applied after mean subtraction (caffe "
                      "transform_param scale; e.g. 0.0078125 = 1/128 for "
                      "unit-range training inputs)")

    def data_stream_init(self):
        self._iter = open_lmdb_kv_iter(self.fn)
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        from ..graph.pbwire import decode_wire
        try:
            _key, raw = next(self._iter)
        except StopIteration:
            return DataBlock()
        d = decode_wire(raw)
        chans, y, x = d.varint(1, 0), d.varint(2, 0), d.varint(3, 0)
        data = d.bytes_field(4)
        label = d.varint(5, 0)
        v = np.frombuffer(data, dtype=np.uint8).astype(np.float32)
        v = (v.reshape(chans, y, x) - self.mean) * self.scale
        ret = DataBlock(NDA(Dims.make(tn="float", chan=chans, y=y, x=x), v),
                        tag=self.tag, frame_ix=self._ix, timestamp_ns=self._ix)
        ret.set_sdb(DataBlock(NDA(Dims.make(tn="float", v=1),
                                  np.array([label], np.float32)), tag="label"))
        self._ix += 1
        return ret

    def get_pos_info_str(self) -> str:
        return f"lmdb-src: {self._ix}"


@mode("test_lmdb",
      help="classification accuracy over a labeled stream (lmdb/npy)")
class TestLmdb(RunCnetBase):
    """Reference: test_lmdb_t (lmdb_caffe_io.cc:36-62). The stream spec
    generalizes the lmdb reader: any labeled-block source works."""

    src = Attr(DataStream, req=True, help="labeled-block stream spec")
    top_k = Attr(int, default=1, help="count hit if gt in top-k")
    max_imgs = Attr(int, default=0, help="stop after this many (0: all)")

    def main(self):
        pipe = self.setup_cnet()
        d = pipe.get_data_img_dims()
        batch_sz = d["img"]
        data_node = pipe.data_img_node_names[0]
        top = pipe.get_single_top_node().name
        self.src.data_stream_init()
        num_test = 0
        num_pos = 0
        with timer("test_lmdb"):
            while not self.max_imgs or num_test < self.max_imgs:
                imgs, labels = [], []
                for _ in range(batch_sz):
                    b = self.src.proc_block(DataBlock())
                    if not b.valid():
                        break
                    lab = b.get_sdb("label")
                    if lab is None:
                        raise RtErr("test_lmdb: stream block missing 'label' "
                                    "subblock")
                    imgs.append(b.nda.v)
                    labels.append(int(lab.nda.v.ravel()[0]))
                if not labels:
                    break
                # pad a short final batch (the plan's shapes are static)
                while len(imgs) < batch_sz:
                    imgs.append(np.zeros_like(imgs[0]))
                batch = NDA(d, np.stack(imgs).astype(d.dtype))
                out = self.conv_fwd.run_fwd({data_node: batch}, [top])[top]
                num_pos += score_batch(out.v, labels, self.top_k)
                num_test += len(labels)
        top_1_acc = num_pos / max(num_test, 1)
        acc_tag = "top_1_acc" if self.top_k == 1 else f"top_{self.top_k}_acc"
        print(f"{acc_tag}={top_1_acc:g} num_pos={num_pos} num_test={num_test}")


@mode("cls_agree",
      help="prediction agreement of two engine configs over a labeled "
           "stream (quantization accuracy gate)")
class ClsAgree(RunCnetBase):
    """Accuracy gate for selective-precision configs (VERDICT r3 #1): run
    the SAME net through two execution configs (conv_fwd = the reference
    precision, conv_fwd_b = the candidate, e.g. the int8 preset via
    op_tunes_pat/act_scales_fn) over one labeled stream and report, per
    the BASELINE north star's 'top-5 predictions matching' clause:
    per-config top-1 accuracy, top-1 prediction agreement, candidate
    top-1 ∈ reference top-5, and mean top-5 set overlap. The reference's
    analog gate was output-digest comparison against ground-truth runs
    (test_compute.cc:267-269, comp_util.H:13)."""

    conv_fwd_b = Attr(ConvFwd, default="torch",
                      help="candidate engine config (e.g. int8 preset)")
    src = Attr(DataStream, req=True, help="labeled-block stream spec")
    max_imgs = Attr(int, default=0, help="stop after this many (0: all)")

    def main(self):
        pipe = self.setup_cnet()
        self.conv_fwd_b.init(pipe)
        d = pipe.get_data_img_dims()
        batch_sz = d["img"]
        data_node = pipe.data_img_node_names[0]
        top = pipe.get_single_top_node().name
        self.src.data_stream_init()
        num_test = num_pos_a = num_pos_b = 0
        top1_agree = b1_in_a5 = 0
        top5_overlap = 0.0
        while not self.max_imgs or num_test < self.max_imgs:
            imgs, labels = [], []
            for _ in range(batch_sz):
                b = self.src.proc_block(DataBlock())
                if not b.valid():
                    break
                lab = b.get_sdb("label")
                if lab is None:
                    raise RtErr("cls_agree: stream block missing 'label' "
                                "subblock")
                imgs.append(b.nda.v)
                labels.append(int(lab.nda.v.ravel()[0]))
            if not labels:
                break
            while len(imgs) < batch_sz:  # pad short final batch
                imgs.append(np.zeros_like(imgs[0]))
            batch = NDA(d, np.stack(imgs).astype(d.dtype))
            pa = self.conv_fwd.run_fwd({data_node: batch}, [top])[top].v
            pb = self.conv_fwd_b.run_fwd({data_node: batch}, [top])[top].v
            num_pos_a += score_batch(pa, labels)
            num_pos_b += score_batch(pb, labels)
            for i in range(len(labels)):
                ta = np.argsort(-pa[i, :, 0, 0])[:5]
                tb = np.argsort(-pb[i, :, 0, 0])[:5]
                top1_agree += int(ta[0] == tb[0])
                b1_in_a5 += int(tb[0] in ta)
                top5_overlap += len(set(ta) & set(tb)) / 5.0
            num_test += len(labels)
        n = max(num_test, 1)
        print(f"top_1_acc_a={num_pos_a / n:g} top_1_acc_b={num_pos_b / n:g} "
              f"top_1_agree={top1_agree / n:g} "
              f"b_top1_in_a_top5={b1_in_a5 / n:g} "
              f"top_5_overlap={top5_overlap / n:g} "
              f"num_pos_a={num_pos_a} num_pos_b={num_pos_b} "
              f"num_test={num_test}")


@mode("lmdb_parse_datums", help="parse caffe Datums from an LMDB, one line each")
class LmdbParseDatums(HasMain):
    """Reference: lmdb_parse_datums (lmdb_caffe_io.H:14) — cursor over the
    DB parsing each Datum; here each record prints a summary line (the
    reference's verbose path) so the scan is goldenable."""

    db_fn = Attr(str, req=True, help="input lmdb dir")
    num_to_read = Attr(int, default=10, help="read this many records (0: all)")

    def main(self):
        from ..graph.pbwire import decode_wire
        n = 0
        for key, raw in open_lmdb_kv_iter(self.db_fn):
            if self.num_to_read and n >= self.num_to_read:
                break
            d = decode_wire(raw)
            ks = key.decode("utf-8", "replace") if isinstance(key, bytes) else key
            print(f"datum {n}: key={ks} label={d.varint(5, 0)} "
                  f"chan={d.varint(1, 0)} y={d.varint(2, 0)} "
                  f"x={d.varint(3, 0)} bytes={len(d.bytes_field(4) or b'')}")
            n += 1
        print(f"lmdb_parse_datums: read {n} datums from {self.db_fn}")


@mode("lmdb_bench", help="scan an LMDB: count entries/bytes, datum stats")
class LmdbBench(HasMain):
    """Reference: lmdb_bench_t (lmdbif.cc:13-38 — full-scan read bench)."""

    fn = Attr(str, req=True, help="lmdb directory (or data.mdb file)")
    parse_datums = Attr(bool, default=True, help="also decode caffe Datums")
    max_entries = Attr(int, default=0, help="stop after N (0: all)")

    def main(self):
        import time
        from ..graph.pbwire import decode_wire
        t0 = time.perf_counter()
        n = 0
        key_bytes = val_bytes = 0
        label_hist: dict[int, int] = {}
        dims_seen = set()
        for k, v in open_lmdb_kv_iter(self.fn):
            n += 1
            key_bytes += len(k)
            val_bytes += len(v)
            if self.parse_datums:
                d = decode_wire(v)
                dims_seen.add((d.varint(1, 0), d.varint(2, 0), d.varint(3, 0)))
                lab = d.varint(5, 0)
                label_hist[lab] = label_hist.get(lab, 0) + 1
            if self.max_entries and n >= self.max_entries:
                break
        dt = time.perf_counter() - t0
        print(f"lmdb_bench: entries={n} key_bytes={key_bytes} "
              f"val_bytes={val_bytes}")
        if self.parse_datums:
            print(f"datum dims (chan,y,x): {sorted(dims_seen)}; "
                  f"labels: {len(label_hist)} distinct")
        print(f"scan took {dt:.3f}s "
              f"({(key_bytes + val_bytes) / max(dt, 1e-9) / 1e6:.1f} MB/s)")


@mode("display_lmdb", help="render LMDB datums to a montage image")
class DisplayLmdb(HasMain):
    """Reference: lmdb_caffe_disp.cc:14 (display datums as they stream);
    file-backed here (no display stack on a headless host): first N datums are
    tiled into one PNG."""

    fn = Attr(str, req=True, help="lmdb directory")
    num_imgs = Attr(int, default=16)
    out_fn = Attr(str, default="lmdb_montage.png")

    def main(self):
        from ..graph.pbwire import decode_wire
        from ..io.disp import make_montage
        from ..io.img import save_img
        imgs = []
        for _k, v in open_lmdb_kv_iter(self.fn):
            d = decode_wire(v)
            c, y, x = d.varint(1, 0), d.varint(2, 0), d.varint(3, 0)
            u8 = np.frombuffer(d.bytes_field(4), np.uint8).reshape(c, y, x)
            imgs.append(np.transpose(u8, (1, 2, 0)))
            if len(imgs) >= self.num_imgs:
                break
        if not imgs:
            raise RtErr(f"display_lmdb: no datums in '{self.fn}'")
        out = self.out_path(self.out_fn)
        save_img(out, make_montage(imgs))
        print(f"display_lmdb: wrote {len(imgs)} datums to {self.out_fn}")


@mode("gen_lmdb", help="generate a labeled test-pattern Datum LMDB")
class GenLmdb(HasMain):
    """Fixture generator (the role scripts filled upstream by converting
    ImageNet with caffe's convert_imageset): deterministic test-pattern
    images + labels, written via the built-in LMDB writer."""

    out_dir = Attr(str, req=True, help="lmdb env directory to create")
    num_imgs = Attr(int, default=16)
    chan = Attr(int, default=3)
    ysz = Attr(int, default=32)
    xsz = Attr(int, default=32)
    num_classes = Attr(int, default=10)
    seed = Attr(int, default=42)
    kind = Attr(str, default="pattern",
                help="pattern = label-banded noise (fast fixture); "
                     "shapes = the procedural shape-classification "
                     "dataset (io/synth.py — same pixels shapes-src "
                     "serves, so a net trained on shapes-src evaluates "
                     "against this LMDB through test_lmdb)")
    start_ix = Attr(int, default=0,
                    help="first dataset index (kind=shapes split base)")

    def main(self):
        from ..utils.lmdbmini import write_lmdb
        rng = np.random.RandomState(self.seed)
        kvs = []
        if self.kind == "shapes":
            if self.chan != 3:
                raise RtErr("gen_lmdb: kind=shapes renders chan=3 images")
            from ..io.synth import render_shapes
            imgs, labels = render_shapes(
                range(self.start_ix, self.start_ix + self.num_imgs),
                self.ysz, self.xsz, self.num_classes, self.seed)
            kvs = [(b"%08d" % i, encode_datum(imgs[i], int(labels[i])))
                   for i in range(self.num_imgs)]
        elif self.kind != "pattern":
            raise RtErr(f"gen_lmdb: unknown kind '{self.kind}' "
                        f"(pattern | shapes)")
        for i in range(len(kvs), self.num_imgs):
            label = i % self.num_classes
            img = rng.randint(0, 256, size=(self.chan, self.ysz, self.xsz),
                              dtype=np.uint8)
            # bias a band by the label so accuracy isn't pure chance for
            # nets trained on the same generator
            img[:, label % self.ysz, :] = 255
            kvs.append((b"%08d" % i, encode_datum(img, label)))
        st = write_lmdb(self.out_path(self.out_dir), kvs)
        print(f"gen_lmdb: wrote {st['entries']} datums "
              f"(depth={st['depth']}, last_pg={st['last_pg']}) to {self.out_dir}")
