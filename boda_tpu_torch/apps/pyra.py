"""Multi-scale image-pyramid packing + dense pyramid inference.

Capability parity with the reference's blf_pack.{H,cc} + conv_pyra.cc:

  * scale-list generation per octave/interval (pyra_pack_t blf_pack.H:9-31),
  * bottom-left-fill 2-D bin packing of scaled images into fixed
    batch "bins" with support/stride-aware inter-image padding
    (blf_place, blf_pack.cc ~200-330) — fixed bins keep one plan's shapes
    across frames,
  * image scale+pack into the batch tensor with edge-pad interpolation
    (img_pyra_pack_t blf_pack.H:72-84),
  * conv_pyra (conv_pyra.cc:24): pack → forward → per-scale feature
    extraction with zero_trash masking of invalid inter-scale pixels
    (conv_pyra.cc:65-77), image/file-stream driven (camera optional).

CLI modes: blf_pack (placement math only), conv_pyra (full pipeline).

The port's copy of boda_tpu/apps/pyra.py, on engine=torch. conv_pyra packs
on the host (PIL), as in the JAX package; pyra_bench (apps/cnet_bench.py)
also packs on the card (io/device_preproc.make_device_pyra_pack).
blf_place's native placement core is the port's host core
(utils/cpplib.cpp_blf_place, impl=cpp); conv_pyra's annotated image
(anno_fn) is drawn by io/disp.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.config import Attr
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.geom import Box, Pt
from ..core.has_main import HasMain, mode
from ..engine.iface import ConvFwd
from ..graph.modes import _NetMode


@dataclass
class ScaleInfo:
    """One pyramid scale: image size + placement (reference: scale_info_t
    caffeif.H:88 + per-placement data in img_pyra_pack_t)."""

    scale: float
    sz: Pt
    bin_ix: int = -1
    place: Optional[Box] = None  # placement box in the bin, half-open


def calc_pyra_scales(in_sz: Pt, interval: int = 3, min_sz: int = 16,
                     num_upsamp_octaves: int = 0) -> list[ScaleInfo]:
    """Scale list: `interval` scales per octave from (optionally upsampled)
    full size down to min_sz (reference: pyra_pack_t scale generation)."""
    scales = []
    octave = num_upsamp_octaves
    base = 2.0 ** num_upsamp_octaves
    i = 0
    while True:
        s = base * 2.0 ** (-i / float(interval))
        sz = Pt(max(1, int(round(in_sz.y * s))), max(1, int(round(in_sz.x * s))))
        if min(sz.y, sz.x) < min_sz:
            break
        scales.append(ScaleInfo(s, sz))
        i += 1
    return scales


def blf_place(sizes: list[Pt], bin_sz: Pt, pad: Pt,
              impl: str = "auto") -> list[tuple[int, Box]]:
    """Bottom-left-fill packing: place each (pre-sorted descending) rect in
    the first bin position that fits; open new bins as needed. Returns
    (bin_ix, box) per input rect (in input order). Each placed rect
    reserves `pad` on its +y/+x sides (support padding so net receptive
    fields don't mix scales). impl: 'auto' and 'py' are this Python
    placement; 'cpp' the native placement core (csrc/host/blf_pack.cc,
    built at first use; raises where it cannot be), whose placements the
    differential tests pin to these."""
    if impl == "cpp":
        from ..utils.cpplib import cpp_blf_place
        for sz in sizes:
            if sz.y > bin_sz.y or sz.x > bin_sz.x:
                raise RtErr(f"blf_place: rect {sz} larger than bin {bin_sz}")
        _nb, flat = cpp_blf_place([(s.y, s.x) for s in sizes],
                                  (bin_sz.y, bin_sz.x), (pad.y, pad.x))
        return [(int(bi), Box(Pt(int(y), int(x)),
                              Pt(int(y) + sizes[i].y, int(x) + sizes[i].x)))
                for i, (bi, y, x) in enumerate(flat)]
    if impl not in ("auto", "py"):
        raise RtErr(f"blf_place: unknown impl '{impl}' (auto, py, cpp)")
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i].y * sizes[i].x, i))
    bins: list[list[Box]] = []  # placed (padded) boxes per bin
    cands: list[list[Pt]] = []  # candidate corners per bin
    out: list[Optional[tuple[int, Box]]] = [None] * len(sizes)

    def fits(bin_ix: int, at: Pt, sz: Pt) -> bool:
        padded = Box(at, at + sz + pad)
        if padded.p1.y > bin_sz.y + pad.y or padded.p1.x > bin_sz.x + pad.x:
            # allow the pad (not the image) to hang off the bin edge
            if at.y + sz.y > bin_sz.y or at.x + sz.x > bin_sz.x:
                return False
        clipped = Box(at, Pt(min(at.y + sz.y + pad.y, bin_sz.y),
                             min(at.x + sz.x + pad.x, bin_sz.x)))
        return all(not _overlap(clipped, b) for b in bins[bin_ix])

    for idx in order:
        sz = sizes[idx]
        if sz.y > bin_sz.y or sz.x > bin_sz.x:
            raise RtErr(f"blf_place: rect {sz} larger than bin {bin_sz}")
        placed = False
        for bi in range(len(bins)):
            # bottom-left: try candidates sorted by (y, x)
            for at in sorted(cands[bi], key=lambda p: (p.y, p.x)):
                if fits(bi, at, sz):
                    box = Box(at, at + sz)
                    bins[bi].append(Box(at, Pt(min(at.y + sz.y + pad.y, bin_sz.y),
                                               min(at.x + sz.x + pad.x, bin_sz.x))))
                    cands[bi].remove(at)
                    cands[bi] += [Pt(at.y + sz.y + pad.y, at.x),
                                  Pt(at.y, at.x + sz.x + pad.x)]
                    out[idx] = (bi, box)
                    placed = True
                    break
            if placed:
                break
        if not placed:
            bins.append([])
            cands.append([Pt(0, 0)])
            at = Pt(0, 0)
            if not fits(len(bins) - 1, at, sz):
                raise RtErr(f"blf_place: rect {sz} doesn't fit in empty bin {bin_sz}")
            box = Box(at, at + sz)
            bins[-1].append(Box(at, Pt(min(sz.y + pad.y, bin_sz.y),
                                       min(sz.x + pad.x, bin_sz.x))))
            cands[-1] += [Pt(sz.y + pad.y, 0), Pt(0, sz.x + pad.x)]
            out[idx] = (len(bins) - 1, box)
    return out  # type: ignore[return-value]


def _overlap(a: Box, b: Box) -> bool:
    return (a.p0.y < b.p1.y and b.p0.y < a.p1.y
            and a.p0.x < b.p1.x and b.p0.x < a.p1.x)


class ImgPyraPack:
    """Scale an image to all pyramid sizes and pack into fixed bins
    (reference: img_pyra_pack_t)."""

    def __init__(self, in_sz: Pt, bin_sz: Pt, interval: int = 3,
                 min_sz: int = 16, pad: Pt = Pt(16, 16),
                 num_upsamp_octaves: int = 0):
        self.scales = calc_pyra_scales(in_sz, interval, min_sz, num_upsamp_octaves)
        if not self.scales:
            raise RtErr("img_pyra_pack: no scales (input too small for min_sz?)")
        self.bin_sz = bin_sz
        self.pad = pad
        places = blf_place([s.sz for s in self.scales], bin_sz, pad)
        self.num_bins = 0
        for si, (bi, box) in zip(self.scales, places):
            si.bin_ix = bi
            si.place = box
            self.num_bins = max(self.num_bins, bi + 1)

    def scale_and_pack_img_into_bins(self, img: np.ndarray,
                                     edge_pad: bool = True) -> np.ndarray:
        """→ (num_bins, bin_y, bin_x, 3) uint8 packed pyramid."""
        from ..io.img import resample_to_size
        out = np.zeros((self.num_bins, self.bin_sz.y, self.bin_sz.x, 3), np.uint8)
        for si in self.scales:
            sc = resample_to_size(img, si.sz.y, si.sz.x)
            b = si.place
            out[si.bin_ix, b.p0.y:b.p1.y, b.p0.x:b.p1.x] = sc
            if edge_pad:  # replicate edges into the pad region (reference
                # pads with interpolation so borders aren't hard zeros)
                py = min(b.p1.y + self.pad.y, self.bin_sz.y)
                px = min(b.p1.x + self.pad.x, self.bin_sz.x)
                out[si.bin_ix, b.p1.y:py, b.p0.x:b.p1.x] = sc[-1:, :, :]
                out[si.bin_ix, b.p0.y:b.p1.y, b.p1.x:px] = sc[:, -1:, :]
                out[si.bin_ix, b.p1.y:py, b.p1.x:px] = sc[-1:, -1:, :]
        return out

    def trash_mask(self) -> np.ndarray:
        """(num_bins, bin_y, bin_x) bool: True where NO scale image (or its
        pad) lives — feature pixels whose support touches these are invalid
        (reference: zero_trash conv_pyra.cc:65-77)."""
        m = np.ones((self.num_bins, self.bin_sz.y, self.bin_sz.x), bool)
        for si in self.scales:
            b = si.place
            py = min(b.p1.y + self.pad.y, self.bin_sz.y)
            px = min(b.p1.x + self.pad.x, self.bin_sz.x)
            m[si.bin_ix, b.p0.y:py, b.p0.x:px] = False
        return m


@mode("blf_pack", help="pyramid scale generation + bottom-left-fill packing demo")
class BlfPack(HasMain):
    in_sz = Attr(list[int], default="227 227", help="input image size (y x)")
    bin_sz = Attr(list[int], default="512 512")
    interval = Attr(int, default=3)
    min_sz = Attr(int, default=32)
    pad = Attr(list[int], default="16 16")
    out_fn = Attr(str, default="", help="write placements to this file")

    def main(self):
        pp = ImgPyraPack(Pt(*self.in_sz), Pt(*self.bin_sz), self.interval,
                         self.min_sz, Pt(*self.pad))
        lines = [f"num_scales={len(pp.scales)} num_bins={pp.num_bins} "
                 f"bin_sz={pp.bin_sz}"]
        for i, si in enumerate(pp.scales):
            lines.append(f"scale[{i}]: s={si.scale:.4f} sz={si.sz} "
                         f"bin={si.bin_ix} place={si.place}")
        txt = "\n".join(lines)
        print(txt)
        if self.out_fn:
            self.out_path(self.out_fn).write_text(txt + "\n")


@mode("conv_pyra", help="multi-scale pyramid dense inference over an image")
class ConvPyra(_NetMode):
    conv_fwd = Attr(ConvFwd, default="(engine=torch,keep_all_nodes=1)")
    img_fn = Attr(str, default="", help="input image (else test pattern)")
    out_node = Attr(str, default="", help="feature node (default net top)")
    bin_sz = Attr(list[int], default="288 288")
    interval = Attr(int, default=3)
    min_sz = Attr(int, default=32)
    zero_trash = Attr(bool, default=True)
    digest_fn = Attr(str, default="")
    plane_digest_fn = Attr(str, default="", help="also digest the whole "
                           "(zero_trash-masked) feature planes")
    frames = Attr(int, default=1, help="repeat count (streaming simulation)")
    predict = Attr(bool, default=False,
                   help="run the dense multi-scale prediction path "
                        "(per-scale regions -> NMS grid -> annos; "
                        "caffeif.cc do_predict)")
    enable_upsamp_net = Attr(bool, default=False,
                             help="predict the first octave from the 2x-"
                                  "upsampled companion net (folded first-"
                                  "conv; conv_pyra.cc upsamp octave)")
    conv_fwd_upsamp = Attr(ConvFwd, default="(engine=torch,keep_all_nodes=1)")
    label_fn = Attr(str, default="", help="label names, one per line")
    anno_fn = Attr(str, default="", help="write box-annotated input image")
    filt_show_thresh = Attr(float, default=0.02)
    filt_drop_thresh = Attr(float, default=0.005)
    max_num_disp = Attr(int, default=20)
    nms_grid_pels = Attr(list[int], default="25 25")
    nms_core_rat = Attr(float, default=0.75)

    def main(self):
        from ..core.digest import nda_digest
        from ..graph.modes import _load_pipe
        from ..graph.support import CM_VALID, in_box_to_out_box
        from ..io.img import img_to_chw, load_img, make_test_pattern_img
        from ..models.zoo import build_model
        # build net at bin size; bins ride the batch (img) dim — one plan
        # handles every frame
        pipe = _load_pipe(self)
        if self.out_node:
            pipe = pipe.pruned_to(self.out_node)
        d0 = pipe.get_data_img_dims()
        in_sz = Pt(d0["y"], d0["x"])
        bin_sz = Pt(*self.bin_sz)
        out_node = pipe.must_get_node(self.out_node) if self.out_node \
            else pipe.get_single_top_node()
        csi = out_node.csi
        if not csi.valid() or csi.support_sz.is_zeros():
            raise RtErr("conv_pyra: output node needs finite support; pick a "
                        "conv feature node via --out-node")
        pad = Pt(max(csi.support_sz.y, 1), max(csi.support_sz.x, 1))
        pp = ImgPyraPack(in_sz, bin_sz, self.interval, self.min_sz, pad)
        # rebuild net at (num_bins, bin_sz) batch
        if self.model:
            bpipe = build_model(self.model, batch=pp.num_bins,
                                ysz=bin_sz.y, xsz=bin_sz.x)
            bpipe.op_params = pipe.op_params
        else:
            self.in_dims = Dims.make(img=pp.num_bins, chan=3, y=bin_sz.y, x=bin_sz.x)
            bpipe = _load_pipe(self)
        if self.out_node:
            bpipe = bpipe.pruned_to(self.out_node)
        self.conv_fwd.init(bpipe)
        img = load_img(self.img_fn) if self.img_fn else \
            make_test_pattern_img(in_sz.y, in_sz.x, 2)
        data_node = bpipe.data_img_node_names[0]
        bcsi = bpipe.must_get_node(out_node.name).csi
        upipe = ucsi = None
        if self.enable_upsamp_net:
            from ..models.upsamp import make_upsamp_pipe
            upipe = make_upsamp_pipe(bpipe)
            self.conv_fwd_upsamp.init(upipe)
            ucsi = upipe.must_get_node(out_node.name).csi
        predictor = None
        for frame in range(self.frames):
            packed = pp.scale_and_pack_img_into_bins(img)
            batch = np.stack([img_to_chw(packed[b]) for b in range(pp.num_bins)])
            blob = NDA(Dims.make(img=pp.num_bins, chan=3, y=bin_sz.y, x=bin_sz.x), batch)
            feats = self.conv_fwd.run_fwd({data_node: blob}, [out_node.name])[out_node.name]
            fv = np.array(feats.v)
            fv_up = None
            if upipe is not None:
                ufeats = self.conv_fwd_upsamp.run_fwd(
                    {data_node: blob}, [out_node.name])[out_node.name]
                fv_up = np.array(ufeats.v)
            per_scale = []
            valid_boxes = []
            for i, si in enumerate(pp.scales):
                ob = in_box_to_out_box(si.place, CM_VALID, bcsi)
                ob = ob.clip_to(Box(Pt(0, 0), Pt(fv.shape[2], fv.shape[3])))
                if not ob.is_strictly_normalized():
                    per_scale.append(None)
                    valid_boxes.append(None)
                    continue
                sf = fv[si.bin_ix, :, ob.p0.y:ob.p1.y, ob.p0.x:ob.p1.x]
                per_scale.append(sf)
                valid_boxes.append(ob)
            if self.zero_trash:
                # real trash masking (conv_pyra.cc:65-77 semantics): keep
                # only features inside some scale's valid box; pixels whose
                # support straddles scale placements (or lives in unused
                # plane area) are zeroed so downstream consumers of the
                # whole planes can't read inter-scale garbage
                vm = np.zeros((fv.shape[0], fv.shape[2], fv.shape[3]),
                              fv.dtype)
                for si, ob in zip(pp.scales, valid_boxes):
                    if ob is not None:
                        vm[si.bin_ix, ob.p0.y:ob.p1.y, ob.p0.x:ob.p1.x] = 1
                fv = fv * vm[:, None, :, :]
            if self.predict:
                if predictor is None:
                    from .predict import DensePredictor
                    from pathlib import Path
                    labels = (Path(self.label_fn).read_text().splitlines()
                              if self.label_fn else
                              [f"class_{i}" for i in range(fv.shape[1])])
                    predictor = DensePredictor(
                        labels,
                        filt_show_thresh=self.filt_show_thresh,
                        filt_drop_thresh=self.filt_drop_thresh,
                        max_num_disp=self.max_num_disp,
                        nms_grid_pels=Pt(*self.nms_grid_pels),
                        nms_core_rat=self.nms_core_rat)
                    predictor.setup_scale_infos(
                        bcsi, self.interval,
                        sizes=[si.sz for si in pp.scales],
                        placements=[(si.bin_ix, si.place.p0) for si in pp.scales],
                        nominal_in_sz=in_sz, num_chans=fv.shape[1],
                        feat_sz=Pt(fv.shape[2], fv.shape[3]),
                        csi_upsamp=ucsi,
                        upsamp_feat_sz=(Pt(fv_up.shape[2], fv_up.shape[3])
                                        if fv_up is not None else None))
                annos = self.annos = predictor.do_predict(
                    fv, fv_up, print_to_terminal=True)
                if self.anno_fn and frame == self.frames - 1:
                    from ..io.disp import annotate_img
                    from ..io.img import save_img
                    h, w = img.shape[0], img.shape[1]
                    draw = [(tuple(np.clip(a.box, 0, [h, w, h, w])),
                             a.str.splitlines()[0] if a.str else "")
                            for a in annos]
                    save_img(self.out_path(self.anno_fn),
                             annotate_img(img, draw))
                    print(f"wrote {len(annos)} annos to {self.anno_fn}")
            if frame == 0:
                self.per_scale = per_scale
                print(f"conv_pyra: {len(pp.scales)} scales in {pp.num_bins} "
                      f"bins of {bin_sz}; feature node '{out_node.name}' "
                      f"dims {feats.dims.pretty()}")
                for i, (si, sf) in enumerate(zip(pp.scales, per_scale)):
                    if sf is None:
                        print(f"  scale {i} (s={si.scale:.3f}): no valid features")
                        continue
                    print(f"  scale {i} (s={si.scale:.3f}): feats {sf.shape} "
                          f"mean={sf.mean():.4f}")
                if self.digest_fn:
                    from ..testing.comp import write_digest_stream
                    digs = {f"scale_{i}": NDA.from_array(sf, ["chan", "y", "x"])
                            for i, sf in enumerate(per_scale) if sf is not None}
                    write_digest_stream(self.out_path(self.digest_fn), digs)
                if self.plane_digest_fn:
                    from ..testing.comp import write_digest_stream
                    write_digest_stream(
                        self.out_path(self.plane_digest_fn),
                        {"planes": NDA.from_array(fv, ["img", "chan", "y", "x"])})
