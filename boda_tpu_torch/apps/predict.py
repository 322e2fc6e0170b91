"""Dense multi-scale prediction: per-scale regions → NMS grid → annotations.

Capability parity with the reference's marquee dense-inference path:
scale_info_t / pred_state_t / nms_grid_t (caffeif.H:88-160) and their
machinery in caffeif.cc — setup_scale_infos (:293-356), setup_predict's
per-feature-pixel image-box precompute (:249-291), do_predict /
do_predict_region (:380-417, :503-560: per-pel is-PDF check, selective
softmax, temporal filtering with show/drop hysteresis), nms_grid_op
(:407-436: quantized coverage grid, ¾-center-match merge) and
pred_state_to_annos (:438-501: sort by filtered prob, per-anno label caps).

TPU-era differences: pred_state is vectorized numpy per scale (the
reference's flat vector + triple loop becomes array ops over the feature
region); the per-pixel image-box map is computed once in closed form from
the support geometry (graph/support.py) instead of per-pixel box-math
calls. The NMS grid walk is kept host-side and faithful — it operates on
tens of boxes, not tensors.

The port's copy of boda_tpu/apps/predict.py (numpy on the host).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.error import RtErr
from ..core.geom import Box, Pt
from ..graph.support import (CM_VALID, SupportInfo, get_base_out_support,
                             in_box_to_out_box)


@dataclass
class PredScaleInfo:
    """One prediction scale (reference: scale_info_t caffeif.H:88-103)."""

    img_sz: Pt                    # scaled image size at this scale
    from_upsamp_net: bool = False
    bix: int = 0                  # batch plane index
    place: Pt = field(default_factory=Pt)  # offset of image nc in the plane
    feat_box: Box = field(default_factory=lambda: Box(Pt(), Pt()))
    feat_img_box: Box = field(default_factory=lambda: Box(Pt(), Pt()))

    def __str__(self):
        return (f"img_sz={self.img_sz} from_upsamp_net={int(self.from_upsamp_net)} "
                f"bix={self.bix} place={self.place} feat_box={self.feat_box}")


@dataclass
class Anno:
    """A display annotation: image box + multi-line label string
    (reference: anno_t)."""

    box: tuple[int, int, int, int]  # (y0, x0, y1, x1) half-open
    str: str = ""
    item_cnt: int = 0
    seen_label_ixs: set = field(default_factory=set)
    top_prob: float = 0.0           # best filtered prob among its labels


def _ceil_sqrt(v: int) -> int:
    r = int(np.ceil(np.sqrt(max(v, 1))))
    return r


class _ScaleState:
    """Vectorized pred_state for one scale: (C, fy, fx) arrays (reference:
    the psb..psb+num_pred slice of vect_pred_state_t)."""

    def __init__(self, si: PredScaleInfo, num_chans: int, img_boxes: np.ndarray):
        fy, fx = si.feat_box.sz().y, si.feat_box.sz().x
        self.si = si
        self.cur_prob = np.zeros((num_chans, fy, fx))
        self.filt_prob = np.zeros((num_chans, fy, fx))
        self.filt_init = False
        self.to_disp = np.zeros((num_chans, fy, fx), bool)
        self.img_boxes = img_boxes  # (fy, fx, 4) int: y0 x0 y1 x1


def _trunc_div(a: np.ndarray, d: int) -> np.ndarray:
    """C++ integer division semantics (truncate toward zero)."""
    return (np.sign(a) * (np.abs(a) // d)).astype(np.int64)


class DensePredictor:
    """Multi-scale dense predictor (reference: cnet_predict_t's prediction
    state + methods, caffeif.H:121-161)."""

    def __init__(self, labels: list[str],
                 filt_rate: float = 0.2,
                 filt_show_thresh: float = 0.02,
                 filt_drop_thresh: float = 0.005,
                 max_num_disp: int = 20,
                 max_labels_per_anno: int = 5,
                 nms_grid_pels: Pt = Pt(25, 25),
                 nms_core_rat: float = 0.75):
        self.labels = labels
        self.filt_rate = filt_rate
        self.filt_show_thresh = filt_show_thresh
        self.filt_drop_thresh = filt_drop_thresh
        self.max_num_disp = max_num_disp
        self.max_labels_per_anno = max_labels_per_anno
        self.nms_grid_pels = nms_grid_pels
        self.nms_core_rat = nms_core_rat
        self.scale_infos: list[PredScaleInfo] = []
        self.nominal_in_sz = Pt(0, 0)
        self._states: list[_ScaleState] = []
        self._nms_grid: dict[tuple[int, int], tuple[int, int, int, int]] = {}

    # ---- setup (reference: setup_scale_infos + setup_predict) ----

    def setup_single_scale(self, csi: SupportInfo, feat_sz: Pt,
                           nominal_in_sz: Pt, num_chans: int) -> None:
        """Whole-image single-scale case (caffeif.cc:293-301): the full
        feature map is one region over the nominal input size."""
        self.nominal_in_sz = nominal_in_sz
        fb = Box(Pt(0, 0), feat_sz)
        si = PredScaleInfo(img_sz=nominal_in_sz, feat_box=fb,
                           feat_img_box=fb.scale(_ceil_sqrt(num_chans)))
        self.scale_infos = [si]
        self._setup_pred_state(csi, None, num_chans)

    def setup_scale_infos(self, csi: SupportInfo, interval: int,
                          sizes: list[Pt], placements: list[tuple[int, Pt]],
                          nominal_in_sz: Pt, num_chans: int,
                          feat_sz: Pt,
                          csi_upsamp: Optional[SupportInfo] = None,
                          upsamp_feat_sz: Optional[Pt] = None) -> None:
        """Multi-scale case (caffeif.cc:303-356): one scale per pyramid
        placement; valid feature boxes from support geometry. When the
        upsampled companion net is enabled, the first `interval` scales come
        from it instead (from_upsamp_net=1)."""
        if csi.support_sz.is_zeros():
            raise RtErr("global pooling and/or\n inner product layers + trying "
                        "to compute dense features = madness!")
        self.nominal_in_sz = nominal_in_sz
        self.scale_infos = []
        up_count = interval if csi_upsamp is not None else 0
        if csi_upsamp is not None and len(sizes) < interval:
            raise RtErr("upsampled net needs >= one octave of scales")
        for six, (sz, (bix, dest)) in enumerate(zip(sizes, placements)):
            use_up = six < up_count
            ucsi = csi_upsamp if use_up else csi
            ufsz = upsamp_feat_sz if use_up else feat_sz
            # assume eff_tot_pad exists around each placed scale image
            psb = Box(dest - ucsi.eff_tot_pad, dest + sz + ucsi.eff_tot_pad)
            fb = in_box_to_out_box(psb, CM_VALID, ucsi)
            fb = fb.clip_to(Box(Pt(0, 0), ufsz))
            if not fb.is_strictly_normalized():
                raise RtErr(f"scale {six}: no valid feature box (sz={sz} "
                            f"dest={dest}; support {ucsi.support_sz})")
            self.scale_infos.append(PredScaleInfo(
                img_sz=sz, from_upsamp_net=use_up, bix=bix, place=dest,
                feat_box=fb, feat_img_box=fb.scale(_ceil_sqrt(num_chans))))
        self._setup_pred_state(csi, csi_upsamp, num_chans)

    def _setup_pred_state(self, csi: SupportInfo,
                          csi_upsamp: Optional[SupportInfo],
                          num_chans: int) -> None:
        """Precompute per-feature-pixel image boxes (caffeif.cc:268-291):
        feat pixel (y,x) → valid input support box → shift by placement →
        scale to nominal input size (C++ trunc-div semantics)."""
        self._states = []
        for si in self.scale_infos:
            ucsi = csi_upsamp if si.from_upsamp_net else csi
            fy, fx = si.feat_box.sz().y, si.feat_box.sz().x
            ys = np.arange(si.feat_box.p0.y, si.feat_box.p1.y)
            xs = np.arange(si.feat_box.p0.x, si.feat_box.p1.x)
            gy, gx = np.meshgrid(ys, xs, indexing="ij")
            if ucsi.support_sz.is_zeros():
                # global support: whole image for every pred
                b = np.empty((fy, fx, 4), np.int64)
                b[..., 0], b[..., 1] = -ucsi.eff_tot_pad.y, -ucsi.eff_tot_pad.x
                b[..., 2] = si.img_sz.y + ucsi.eff_tot_pad.y
                b[..., 3] = si.img_sz.x + ucsi.eff_tot_pad.x
            else:
                sup = get_base_out_support(ucsi, False)
                b = np.empty((fy, fx, 4), np.int64)
                b[..., 0] = gy * ucsi.support_stride.y + sup.p0.y - ucsi.eff_tot_pad.y
                b[..., 1] = gx * ucsi.support_stride.x + sup.p0.x - ucsi.eff_tot_pad.x
                b[..., 2] = gy * ucsi.support_stride.y + sup.p1.y - ucsi.eff_tot_pad.y
                b[..., 3] = gx * ucsi.support_stride.x + sup.p1.x - ucsi.eff_tot_pad.x
            # shift so the image's nc corner is at 0,0; scale to nominal
            b[..., 0] -= si.place.y
            b[..., 2] -= si.place.y
            b[..., 1] -= si.place.x
            b[..., 3] -= si.place.x
            b[..., 0::2] = _trunc_div(b[..., 0::2] * self.nominal_in_sz.y, si.img_sz.y)
            b[..., 1::2] = _trunc_div(b[..., 1::2] * self.nominal_in_sz.x, si.img_sz.x)
            self._states.append(_ScaleState(si, num_chans, b))

    # ---- per-frame prediction (reference: do_predict + do_predict_region) ----

    def do_predict(self, out_batch: np.ndarray,
                   out_batch_upsamp: Optional[np.ndarray] = None,
                   print_to_terminal: bool = False) -> list[Anno]:
        """out_batch: (bins, chans, fy, fx) feature/prob planes. Updates
        pred state for every scale region and returns display annos."""
        for st in self._states:
            src = out_batch_upsamp if st.si.from_upsamp_net else out_batch
            if src is None:
                raise RtErr("scale needs upsampled-net output but none given")
            fb = st.si.feat_box
            region = np.asarray(src[st.si.bix, :, fb.p0.y:fb.p1.y,
                                    fb.p0.x:fb.p1.x], np.float64)
            self._predict_region(st, region)
        return self.pred_state_to_annos(print_to_terminal)

    def _predict_region(self, st: _ScaleState, region: np.ndarray) -> None:
        """Vectorized do_predict_region (caffeif.cc:503-560): per-pel
        is-PDF check, selective softmax, temporal filter + hysteresis."""
        pel_sums = region.sum(axis=0)
        pel_maxs = region.max(axis=0)
        is_pdf = (np.abs(pel_sums - 1.0) < 0.01) & (pel_maxs < 1.01)
        e = np.exp(region - pel_maxs[None])
        sm = e / e.sum(axis=0)[None]
        st.cur_prob = np.where(is_pdf[None], region, sm)
        if not st.filt_init:
            st.filt_init = True
            st.filt_prob = st.cur_prob.copy()
        else:
            st.filt_prob *= (1.0 - self.filt_rate)
            st.filt_prob += st.cur_prob * self.filt_rate
        st.to_disp = np.where(st.filt_prob >= self.filt_show_thresh, True,
                              np.where(st.filt_prob <= self.filt_drop_thresh,
                                       False, st.to_disp))

    # ---- NMS grid (reference: nms_grid_op caffeif.cc:407-436) ----

    def _quant_box(self, img_box: tuple[int, int, int, int]):
        y0, x0, y1, x1 = img_box
        r = self.nms_core_rat
        qy0 = int(round(y0 * r)) // self.nms_grid_pels.y
        qx0 = int(round(x0 * r)) // self.nms_grid_pels.x
        qy1 = int(round(y1 * r)) // self.nms_grid_pels.y
        qx1 = int(round(x1 * r)) // self.nms_grid_pels.x
        return qy0, qx0, qy1, qx1

    def _nms_grid_op(self, do_set: bool, img_box: tuple[int, int, int, int]):
        """Returns img_box (no overlap), an existing box (¾ center match),
        or None (suppressed)."""
        qy0, qx0, qy1, qx1 = self._quant_box(img_box)
        center = ((qy0 + qy1) // 2, (qx0 + qx1) // 2)
        center_match = self._nms_grid.get(center)
        tot_pel = over_pel = center_match_cnt = 0
        for by in range(qy0, qy1):
            for bx in range(qx0, qx1):
                pel = (by, bx)
                if do_set:
                    self._nms_grid[pel] = img_box
                else:
                    tot_pel += 1
                    hit = self._nms_grid.get(pel)
                    if hit is not None:
                        over_pel += 1
                        if center_match is not None and hit == center_match:
                            center_match_cnt += 1
        if do_set:
            return img_box
        if center_match_cnt * 4 > tot_pel * 3:
            return center_match
        if over_pel:
            return None
        return img_box

    # ---- annos (reference: pred_state_to_annos caffeif.cc:438-501) ----

    def pred_state_to_annos(self, print_to_terminal: bool = False) -> list[Anno]:
        cands = []  # (filt_prob, scale_ix, chan, fy_off, fx_off)
        for s_ix, st in enumerate(self._states):
            idx = np.argwhere(st.to_disp)
            for c, y, x in idx:
                cands.append((float(st.filt_prob[c, y, x]), s_ix,
                              int(c), int(y), int(x)))
        cands.sort(key=lambda t: -t[0])
        annos: dict[tuple, Anno] = {}
        self._nms_grid.clear()
        num_disp = 0
        lines = []
        for fp, s_ix, c, y, x in cands:
            if num_disp == self.max_num_disp:
                break
            st = self._states[s_ix]
            img_box = tuple(int(v) for v in st.img_boxes[y, x])
            nms_box = self._nms_grid_op(False, img_box)
            if nms_box is None:
                continue  # overlaps another core, no close center match
            anno = annos.get(nms_box)
            if anno is not None and anno.item_cnt >= self.max_labels_per_anno:
                continue
            if anno is None:
                assert nms_box == img_box
                anno = annos[nms_box] = Anno(box=img_box)
                self._nms_grid_op(True, img_box)
            if c in anno.seen_label_ixs:
                continue
            anno.seen_label_ixs.add(c)
            lbl = self.labels[c] if c < len(self.labels) else f"class_{c}"
            cp = float(st.cur_prob[c, y, x])
            line = f"{lbl:<20} -- filt_p={fp:<10.5f} p={cp:<10.5f}"
            anno.str += line + "\n"
            anno.top_prob = max(anno.top_prob, fp)
            anno.item_cnt += 1
            lines.append(line)
            num_disp += 1
        if print_to_terminal:
            print("---- frame -----")
            for ln in lines:
                print(ln)
            print("---- end frame -----")
        return list(annos.values())
