"""Display / visualization layer (file-backed).

The port's copy of boda_tpu/io/disp.py.

Capability parity with the reference's viz stack — disp_util.cc (SDL2
window + annotation overlays, disp_util.H:63-110), font-util.cc
(stb_truetype text), data-to-img.cc (nda→image heatmaps) — re-targeted at
files: no SDL on a headless host, so "display" renders annotated frames /
montages to PNGs (the same annos drive both). Modes `display_test` and
`display_pil` mirror disp_app.cc:19,48; stream stages `data-to-img` and
`img-sink` mirror data-to-img.cc and the dumpvideo sink.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ..core.config import Attr
from ..core.error import RtErr
from ..core.geom import Box, Pt
from ..core.has_main import HasMain, mode
from .data_stream import DataBlock, DataStream, register
from .img import save_img

# anno = (box(y0,x0,y1,x1) in pixel coords, label string, rgb tuple)
DEFAULT_COLORS = [(255, 64, 64), (64, 255, 64), (64, 128, 255),
                  (255, 255, 64), (255, 64, 255), (64, 255, 255)]


def annotate_img(img: np.ndarray, annos: list) -> np.ndarray:
    """Draw boxes + labels onto an RGB uint8 image (reference: the
    disp_win_t annotation overlay path). annos: [(Box|tuple, label, rgb?)]."""
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        raise RtErr("annotate_img requires PIL (feature 'pil' disabled)")
    im = Image.fromarray(np.asarray(img, np.uint8)).convert("RGB")
    dr = ImageDraw.Draw(im)
    for i, anno in enumerate(annos):
        box = anno[0]
        label = anno[1] if len(anno) > 1 else ""
        color = anno[2] if len(anno) > 2 else DEFAULT_COLORS[i % len(DEFAULT_COLORS)]
        if isinstance(box, Box):
            x0, y0, x1, y1 = box.p0.x, box.p0.y, box.p1.x, box.p1.y
        else:
            y0, x0, y1, x1 = box
        x1 = max(x1, x0 + 1)
        y1 = max(y1, y0 + 1)
        dr.rectangle([x0, y0, x1, y1], outline=tuple(color), width=2)
        if label:
            dr.text((x0 + 2, max(y0 - 11, 0)), str(label), fill=tuple(color))
    return np.asarray(im)


def make_montage(imgs: list[np.ndarray], pad: int = 2,
                 bg: int = 32) -> np.ndarray:
    """Tile images into a near-square grid (the multi-image disp window)."""
    if not imgs:
        raise RtErr("make_montage: no images")
    n = len(imgs)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    ch = max(i.shape[0] for i in imgs)
    cw = max(i.shape[1] for i in imgs)
    out = np.full((rows * (ch + pad) + pad, cols * (cw + pad) + pad, 3), bg,
                  np.uint8)
    for k, im in enumerate(imgs):
        r, c = divmod(k, cols)
        y = pad + r * (ch + pad)
        x = pad + c * (cw + pad)
        out[y:y + im.shape[0], x:x + im.shape[1]] = np.asarray(im, np.uint8)
    return out


def nda_to_img(v: np.ndarray, mode: str = "gray") -> np.ndarray:
    """Render a 2-D (or collapsible) float array as an RGB uint8 heatmap
    (reference: data-to-img.cc nda→image viz)."""
    v = np.asarray(v, np.float64)
    while v.ndim > 2:
        v = v.mean(axis=0)
    if v.ndim == 1:
        v = v[None, :]
    lo, hi = float(v.min()), float(v.max())
    norm = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    g = (norm * 255).astype(np.uint8)
    if mode == "gray":
        return np.stack([g, g, g], axis=-1)
    # simple blue->red colormap
    r = g
    b = 255 - g
    gr = (255 - np.abs(g.astype(np.int32) - 128) * 2).clip(0, 255).astype(np.uint8)
    return np.stack([r, gr, b], axis=-1)


@mode("display_test", help="render moving-box test frames to PNGs")
class DisplayTest(HasMain):
    """Reference: display_test (disp_app.cc:19) — synthetic frames with
    moving annotations; here written to out_dir as frame_NNN.png."""

    out_dir = Attr(str, req=True)
    num_frames = Attr(int, default=4)
    sz = Attr(int, default=128)

    def main(self):
        out = self.out_path(self.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for f in range(self.num_frames):
            img = np.zeros((self.sz, self.sz, 3), np.uint8)
            img[:, :, 2] = np.linspace(0, 200, self.sz, dtype=np.uint8)[None, :]
            p = 8 + f * (self.sz - 48) // max(self.num_frames - 1, 1)
            ann = [((p, p, p + 32, p + 32), f"f{f}")]
            save_img(out / f"frame_{f:03d}.png", annotate_img(img, ann))
        print(f"display_test: wrote {self.num_frames} frames to {self.out_dir}")


@mode("display_pil", help="render PASCAL image-list images + GT boxes to PNGs")
class DisplayPil(HasMain):
    """Reference: display_pil (disp_app.cc:48) — cycle a PASCAL image DB
    with ground-truth annotations."""

    imgset_fn = Attr(str, req=True, help="image-set list file")
    ann_dir = Attr(str, default="", help="VOC annotations dir")
    img_dir = Attr(str, req=True, help="image files dir")
    out_dir = Attr(str, req=True)
    max_imgs = Attr(int, default=8)

    def main(self):
        from ..apps.score import load_pil
        from .img import load_img
        db = load_pil(self.imgset_fn, self.ann_dir or None)
        out = self.out_path(self.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        n = 0
        for img_id, info in sorted(db.items()):
            if n >= self.max_imgs:
                break
            img_fn = Path(self.img_dir) / f"{img_id}.jpg"
            if not img_fn.exists():
                img_fn = Path(self.img_dir) / f"{img_id}.png"
            if not img_fn.exists():
                continue
            img = load_img(img_fn)
            annos = []
            for cls, gts in info.gt.items():
                for g in gts:
                    x0, y0, x1, y1 = g.box
                    annos.append(((y0, x0, y1, x1), cls))
            save_img(out / f"{img_id}.png", annotate_img(img, annos))
            n += 1
        print(f"display_pil: wrote {n} annotated images to {out}")


@mode("display_raw_vid",
      help="render an image-bearing data stream to montage frame PNGs")
class DisplayRawVid(HasMain):
    """Reference: display-raw-vid (raw-vid-disp.cc:46) — read blocks from
    a data stream and composite their images into a display window at a
    fixed rate. File-backed here (no SDL window on a headless host): one montage
    PNG per frame. Images are found, in order of preference, in the
    block's add-img 'img' subblock, its image subblocks, an image-shaped
    nda, or an nda heatmap (the display fallback the reference used for
    un-annotated raw blocks)."""

    src = Attr(DataStream, req=True, help="data stream to read images from")
    out_dir = Attr(str, default="raw_vid")
    max_frames = Attr(int, default=8)
    display_downsample_factor = Attr(
        int, default=1, help="downsample images by this factor before "
                             "compositing (reference: same knob)")
    print_timestamps = Attr(bool, default=False)

    def _img_of(self, db: DataBlock) -> Optional[np.ndarray]:
        sub = db.get_sdb("img")
        if sub is not None and sub.nda is not None:
            return sub.nda.v
        v = db.nda.v if db.nda is not None else None
        if v is not None and v.ndim == 3 and v.shape[-1] == 3 \
                and v.dtype == np.uint8:
            return v
        if v is not None:
            return nda_to_img(v)
        return None

    def main(self):
        out = self.out_path(self.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.src.data_stream_init()
        n = 0
        while n < self.max_frames:
            db = self.src.proc_block(DataBlock())
            if not db.valid():
                break
            imgs = []
            for b in ([db] + (db.subblocks or [])):
                im = self._img_of(b)
                if im is not None:
                    f = self.display_downsample_factor
                    imgs.append(im[::f, ::f] if f > 1 else im)
            if not imgs:
                continue
            if self.print_timestamps:
                print(f"frame {n}: ts={db.timestamp_ns}")
            save_img(out / f"frame_{n:05d}.png",
                     imgs[0] if len(imgs) == 1 else make_montage(imgs))
            n += 1
        print(f"display_raw_vid: wrote {n} frames to {self.out_dir} "
              f"[{self.src.get_pos_info_str()}]")


@mode("ds_test", help="image downsampling test: write the full 2x pyramid")
class DsTest(HasMain):
    """Reference: ds_test (img_io.cc:371, downsample_test) — repeatedly
    2x-downsample one image until either dim is < 2, writing each level."""

    image_fn = Attr(str, req=True, help="input image filename")
    out_dir = Attr(str, default="ds_test_out")

    def main(self):
        from .img import downsample_2x, load_img
        out = self.out_path(self.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        cur = load_img(self.image_fn)
        lvl = 0
        while True:
            save_img(out / f"level_{lvl:02d}.png", cur)
            print(f"ds_test: level {lvl}: {cur.shape[0]}x{cur.shape[1]}")
            if cur.shape[0] < 2 or cur.shape[1] < 2:
                break
            cur = downsample_2x(cur)
            lvl += 1
        print(f"ds_test: wrote {lvl + 1} levels to {self.out_dir}")


# ---- stream stages ----

@register(DataStream, "data-to-img",
          help="convert nda blocks to RGB heatmap image blocks")
class DataToImg(DataStream):
    cmap = Attr(str, default="gray", help="gray | heat")

    def proc_block(self, db: DataBlock) -> DataBlock:
        if db.valid() and db.nda is not None:
            from ..core.dims import NDA, Dims
            img = nda_to_img(db.nda.v, self.cmap)
            dims = Dims([("y", img.shape[0]), ("x", img.shape[1]),
                         ("chan", 3)], tn="uint8_t")
            db = db.clone()
            db.nda = NDA(dims, img)
            db.meta = "image"
        return db

    def get_pos_info_str(self) -> str:
        return "data-to-img"


@register(DataStream, "add-img",
          help="render raw sensor frames (16u/32f grey, 16u-RGGB bayer) "
               "into an 'img' subblock")
class AddImg(DataStream):
    """Reference: data-to-img.cc:12 (type_id add-img) — annotate raw
    video-frame blocks with a viewable RGB image (`as_img`; here a named
    subblock tagged 'img'), with sliding-window min/max level adjustment
    and RGGB bayer demosaic (half-res bilinear-free: R/B direct, G
    averaged)."""

    img_fmt = Attr(str, req=True, help="16u-grey | 32f-grey | 16u-RGGB")
    level_adj = Attr(bool, default=True,
                     help="LPF sliding-window min/max normalization; off = "
                          "assume 12-bit for 16u, direct cast for 32f")
    level_filt_alpha = Attr(float, default=0.9,
                            help="LPF alpha for the sliding min/max window")
    invert_intensity = Attr(bool, default=False,
                            help="grey only: map [min,max] to [1,0]")

    def data_stream_init(self):
        if self.img_fmt not in ("16u-grey", "32f-grey", "16u-RGGB"):
            raise RtErr(f"add-img: unknown img_fmt '{self.img_fmt}' "
                        "(16u-grey | 32f-grey | 16u-RGGB)")
        self._filt_min: Optional[float] = None
        self._filt_rng: Optional[float] = None

    def _norm(self, v: np.ndarray) -> np.ndarray:
        """float frame -> [0,1] via the sliding min/max window."""
        fmin, fmax = float(v.min()), float(v.max())
        rng = max(fmax - fmin, 1e-20)
        if self._filt_min is None:
            self._filt_min, self._filt_rng = fmin, rng
        else:
            a = self.level_filt_alpha
            self._filt_min = a * self._filt_min + (1 - a) * fmin
            self._filt_rng = a * self._filt_rng + (1 - a) * rng
        return np.clip((v - self._filt_min) / self._filt_rng, 0.0, 1.0)

    def _render(self, raw: np.ndarray) -> np.ndarray:
        if self.img_fmt == "16u-RGGB":
            v = np.asarray(raw, np.float64)
            r = v[0::2, 0::2]
            g = (v[0::2, 1::2] + v[1::2, 0::2]) * 0.5
            b = v[1::2, 1::2]
            rgb = np.stack([r, g, b], axis=-1)
            norm = (self._norm(rgb) if self.level_adj
                    else np.clip(rgb / 4095.0, 0.0, 1.0))
            return (norm * 255).astype(np.uint8)
        v = np.asarray(raw, np.float64)
        if self.level_adj:
            norm = self._norm(v)
        elif self.img_fmt == "16u-grey":
            norm = np.clip(v / 4095.0, 0.0, 1.0)
        else:  # 32f-grey, no level-adj: direct cast to uint8 range
            norm = np.clip(v / 255.0, 0.0, 1.0)
        if self.invert_intensity:
            norm = 1.0 - norm
        g8 = (norm * 255).astype(np.uint8)
        return np.stack([g8, g8, g8], axis=-1)

    def proc_block(self, db: DataBlock) -> DataBlock:
        if db.valid() and db.nda is not None:
            from ..core.dims import NDA, Dims
            raw = db.nda.v
            if raw.ndim != 2:
                raise RtErr(f"add-img: expected a 2-D (y,x) raw frame, got "
                            f"dims {db.nda.dims.pretty()}")
            img = self._render(raw)
            dims = Dims([("y", img.shape[0]), ("x", img.shape[1]),
                         ("chan", 3)], tn="uint8_t")
            db = db.clone()
            sdb = DataBlock(nda=NDA(dims, img), tag="img", meta="image",
                            frame_ix=db.frame_ix,
                            timestamp_ns=db.timestamp_ns)
            db.set_sdb(sdb)
        return db

    def get_pos_info_str(self) -> str:
        return f"add-img: fmt={self.img_fmt}"


@register(DataStream, "img-add-text",
          help="draw a text string onto image blocks (modify in stream)")
class ImgAddText(DataStream):
    """Reference: data-stream-img-util.cc:12 (type_id img-add-text) —
    render text onto the block's image at text_pos, optionally prefixed
    with the block's meta/tag strings (stb_truetype there, PIL here).
    Operates on an add-img 'img' subblock if present, else on a main
    (y,x,3) image nda; errors on non-image blocks like the reference."""

    text_pos = Attr(str, default="8:8", help="text position as x:y")
    text_str = Attr(str, req=True, help="text string")
    prefix_with_meta = Attr(bool, default=False,
                            help="prefix text_str with the block meta")
    prefix_with_tag = Attr(bool, default=False,
                           help="prefix text_str with the block tag")
    color = Attr(str, default="255:255:64", help="text rgb as r:g:b")

    def data_stream_init(self):
        try:
            self._rgb = tuple(int(c) for c in self.color.split(":"))
            if len(self._rgb) != 3:
                raise ValueError
        except ValueError:
            raise RtErr(f"img-add-text: bad color '{self.color}' "
                        "(want r:g:b)")
        try:
            x, y = (int(c) for c in self.text_pos.split(":"))
            self._pos = Pt(y, x)
        except ValueError:
            raise RtErr(f"img-add-text: bad text_pos '{self.text_pos}' "
                        "(want x:y)")

    def proc_block(self, db: DataBlock) -> DataBlock:
        if not db.valid():
            return db
        try:
            from PIL import Image, ImageDraw
        except ImportError:
            raise RtErr("img-add-text requires PIL (feature 'pil' disabled)")
        sdb = db.get_sdb("img")
        on_sdb = sdb is not None and sdb.nda is not None
        tgt = sdb if on_sdb else db
        v = tgt.nda.v if tgt.nda is not None else None
        if v is None or v.ndim != 3 or v.shape[-1] != 3:
            raise RtErr("img-add-text: expected a data block with an image")
        txt = ""
        if self.prefix_with_meta:
            txt += db.meta or ""
        if self.prefix_with_tag:
            txt += db.tag or ""
        txt += self.text_str
        im = Image.fromarray(np.asarray(v, np.uint8)).convert("RGB")
        ImageDraw.Draw(im).text((self._pos.x, self._pos.y), txt,
                                fill=self._rgb)
        from ..core.dims import NDA
        out = NDA(tgt.nda.dims, np.asarray(im))
        db = db.clone()
        if on_sdb:
            new_sdb = sdb.clone()
            new_sdb.nda = out
            db.set_sdb(new_sdb)
        else:
            db.nda = out
        return db

    def get_pos_info_str(self) -> str:
        return (f"img-add-text: text_pos={self.text_pos} "
                f"text_str={self.text_str}")


@register(DataStream, "img-sink",
          help="write image blocks as numbered PNGs (dumpvideo role)")
class ImgSink(DataStream):
    out_dir = Attr(str, req=True)
    prefix = Attr(str, default="img")

    def data_stream_init(self):
        from .data_stream import resolve_stage_fn
        self._n = 0
        self._dir = Path(resolve_stage_fn(self.out_dir))
        self._dir.mkdir(parents=True, exist_ok=True)

    def proc_block(self, db: DataBlock) -> DataBlock:
        if db.valid():
            # prefer an add-img-rendered 'img' subblock over the raw nda
            src = db.get_sdb("img")
            v = (src or db).nda.v if (src or db).nda is not None else None
            if v is not None and v.ndim == 3 and v.shape[-1] == 3:
                save_img(self._dir / f"{self.prefix}_{self._n:05d}.png", v)
                self._n += 1
        return db

    def get_pos_info_str(self) -> str:
        return f"img-sink: wrote {self._n}"
