"""PASCAL VOC detection evaluation.

The port's copy of boda_tpu/apps/score.py.

Capability parity with results_io.{H,cc}: image-list loading (load_pil_t
results_io.H:163), an image DB with per-class ground-truth boxes
(img_db_t :143 — VOC XML annotations), detection-results scoring with
matched-GT AP/mAP computation and PR curves (modes score :456 /
score-files :470).

Formats:
  image list   — one image id per line (VOC ImageSets format)
  annotations  — VOC XML per image: <object><name/><bndbox/></object>
  detections   — text: 'img_id score x0 y0 x1 y1' per line, per-class file
                 (the VOC comp3/comp4 results format)
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..core.config import Attr
from ..core.error import RtErr
from ..core.has_main import HasMain, mode


@dataclass
class GtBox:
    box: tuple[float, float, float, float]  # x0,y0,x1,y1
    difficult: bool = False
    matched: bool = False


@dataclass
class ImgInfo:
    ident: str
    gt: dict[str, list[GtBox]] = field(default_factory=dict)


def load_pil(imgset_fn, ann_dir=None) -> dict[str, ImgInfo]:
    """Load a PASCAL image list + (optionally) its XML annotations."""
    db: dict[str, ImgInfo] = {}
    for line in Path(imgset_fn).read_text().splitlines():
        ident = line.split()[0].strip() if line.strip() else ""
        if not ident:
            continue
        ii = ImgInfo(ident)
        if ann_dir:
            ann = Path(ann_dir) / f"{ident}.xml"
            if ann.exists():
                root = ET.parse(str(ann)).getroot()
                for obj in root.findall("object"):
                    cls = obj.findtext("name", "unknown")
                    bb = obj.find("bndbox")
                    box = (float(bb.findtext("xmin")), float(bb.findtext("ymin")),
                           float(bb.findtext("xmax")), float(bb.findtext("ymax")))
                    diff = obj.findtext("difficult", "0") == "1"
                    ii.gt.setdefault(cls, []).append(GtBox(box, diff))
        db[ident] = ii
    return db


@mode("load_pil", help="load PASCAL VOC image lists by class; print counts")
class LoadPil(HasMain):
    """Reference: load_pil (results_io.H:163) — read a pascal classes
    file, then each class's image-list file (pil_fn template), building
    the image DB with GT boxes. Here the loaded DB is summarized per
    class (images, GT boxes) so the load is goldenable."""

    classes_fn = Attr(str, req=True, help="file listing classes, one per line")
    pil_fn = Attr(str, req=True,
                  help="image-list filename template; %s -> class name")
    ann_dir = Attr(str, default="", help="VOC Annotations dir (XML per image)")

    def main(self):
        classes = [c.strip() for c in Path(self.classes_fn).read_text()
                   .splitlines() if c.strip()]
        db: dict[str, ImgInfo] = {}
        for cls in classes:
            part = load_pil(self.pil_fn % cls if "%s" in self.pil_fn
                            else self.pil_fn, self.ann_dir or None)
            n_new = sum(1 for k in part if k not in db)
            db.update(part)
            n_gt = sum(len(ii.gt.get(cls, [])) for ii in part.values())
            print(f"load_pil: class {cls}: {len(part)} images "
                  f"({n_new} new), {n_gt} gt boxes")
        tot_gt = sum(len(gs) for ii in db.values() for gs in ii.gt.values())
        print(f"load_pil: {len(db)} images total, {tot_gt} gt boxes, "
              f"{len(classes)} classes")


def box_iou(a, b) -> float:
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    iw, ih = max(0.0, ix1 - ix0), max(0.0, iy1 - iy0)
    inter = iw * ih
    ua = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / ua if ua > 0 else 0.0


def read_results_file(path) -> list[tuple[str, float, tuple]]:
    """'img_id score x0 y0 x1 y1' per line."""
    out = []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) != 6:
            if line.strip():
                raise RtErr(f"bad detection result line: '{line}'")
            continue
        out.append((parts[0], float(parts[1]), tuple(float(x) for x in parts[2:])))
    return out


def score_results_for_class(db: dict[str, ImgInfo], cls: str,
                            dets: list[tuple[str, float, tuple]],
                            iou_thresh: float = 0.5,
                            use_07_metric: bool = False):
    """VOC AP: greedy match by descending score; difficult GTs ignored.
    Returns (ap, prc) where prc = (recall, precision, score, tp) arrays
    over dets in descending-score order."""
    for ii in db.values():
        for g in ii.gt.get(cls, []):
            g.matched = False
    npos = sum(1 for ii in db.values() for g in ii.gt.get(cls, [])
               if not g.difficult)
    dets = sorted(dets, key=lambda d: -d[1])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (ident, score, box) in enumerate(dets):
        ii = db.get(ident)
        gts = ii.gt.get(cls, []) if ii else []
        best, best_iou = None, iou_thresh
        for g in gts:
            iou = box_iou(box, g.box)
            if iou >= best_iou:
                best, best_iou = g, iou
        if best is None:
            fp[i] = 1
        elif best.difficult:
            pass  # ignored
        elif best.matched:
            fp[i] = 1
        else:
            best.matched = True
            tp[i] = 1
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    rec = ctp / max(npos, 1)
    prec = ctp / np.maximum(ctp + cfp, 1e-12)
    if use_07_metric:
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            p = prec[rec >= t].max() if (rec >= t).any() else 0.0
            ap += p / 11.0
    else:
        mrec = np.concatenate([[0.0], rec, [1.0]])
        mpre = np.concatenate([[0.0], prec, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        ap = float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())
    scores = np.array([d[1] for d in dets])
    return ap, (rec, prec, scores, tp)


def write_prc_txt(path, cls: str, rec, prec, scores, npos: int, ap: float,
                  tp) -> None:
    """Text PR curve (reference: print_prc_line + the BEGIN/END framing,
    results_io.cc:531-591): ~20 recall-sampled lines between header and
    totals footer."""
    lines = [f"---BEGIN--- class_name={cls} tot_num_class={npos} "
             f"num_dets={len(scores)}"]
    print_skip = 1 + npos // 20
    next_print = 1
    running_ap = 0.0
    num_pos = 0
    last = None
    for i in range(len(scores)):
        if not tp[i]:
            continue
        num_pos = int(np.round(rec[i] * npos))
        running_ap += prec[i] / max(npos, 1)
        last = (num_pos, i)
        if num_pos >= next_print:
            next_print = num_pos + print_skip
            lines.append(f"num_pos={num_pos} num_test={i + 1} "
                         f"score={scores[i]:.6f} p={prec[i]:g} r={rec[i]:g} "
                         f"map={running_ap:g}")
            last = None
    if last is not None:
        num_pos, i = last
        lines.append(f"num_pos={num_pos} num_test={i + 1} "
                     f"score={scores[i]:.6f} p={prec[i]:g} r={rec[i]:g} "
                     f"map={running_ap:g}")
    num_test = len(scores)
    lines.append(f"---END--- class_name={cls} tot_num={npos} "
                 f"num_pos={num_pos} num_test={num_test} "
                 f"num_neg={num_test - num_pos} final_map={ap:g}")
    Path(path).write_text("\n".join(lines) + "\n")


def plot_prc_png(path, cls: str, rec, prec, ap: float) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(rec, prec)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_title(f"{cls} AP={ap:.3f}")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    fig.savefig(path, dpi=80)
    plt.close(fig)


def read_hamming_csv_file(path, ident: str) -> list[tuple[str, float, tuple]]:
    """Per-image CSV 'x0,y0,x1,y1,score' rows in 1-based closed PASCAL
    coords (reference: read_hamming_csv_file results_io.cc:620-643,
    incl. from_pascal_coord_adjust)."""
    out = []
    for line in Path(path).read_text().splitlines():
        parts = [p for p in line.strip().split(",") if p != ""]
        if not parts:
            continue
        if len(parts) != 5:
            raise RtErr(f"bad hamming csv line in {path}: '{line}'")
        x0, y0, x1, y1, score = (float(v) for v in parts)
        out.append((ident, score, (x0 - 1, y0 - 1, x1, y1)))
    return out


@mode("score", help="score PASCAL-format detection results (AP/mAP + PR curves)")
class Score(HasMain):
    imgset_fn = Attr(str, req=True, help="image list file")
    ann_dir = Attr(str, req=True, help="VOC Annotations dir (XML per image)")
    res_fns = Attr(dict[str, str], req=True,
                   help="per-class results files, e.g. (dog=res_dog.txt)")
    iou_thresh = Attr(float, default=0.5)
    use_07_metric = Attr(bool, default=False)
    prc_png_fn = Attr(str, default="", help="PR-curve plot (per class), '{cls}' expands")
    prc_txt_fn = Attr(str, default="", help="text PR curve (per class), "
                      "'{cls}' expands (reference: prc_txt_fn results_io.cc:460)")
    summary_fn = Attr(str, default="")

    def score_class_set(self, db, res_by_class: dict) -> tuple[dict, list[str]]:
        """Score one {class: dets} set; writes per-class prc txt/png."""
        aps = {}
        lines = []
        for cls, dets in sorted(res_by_class.items()):
            npos = sum(1 for ii in db.values() for g in ii.gt.get(cls, [])
                       if not g.difficult)
            ap, (rec, prec, scores, tp) = score_results_for_class(
                db, cls, dets, self.iou_thresh, self.use_07_metric)
            aps[cls] = ap
            line = f"{cls}: AP={ap:.4f} ({len(dets)} dets)"
            print(line)
            lines.append(line)
            if self.prc_txt_fn:
                write_prc_txt(self.out_path(self.prc_txt_fn.replace("{cls}", cls)),
                              cls, rec, prec, scores, npos, ap, tp)
            if self.prc_png_fn:
                plot_prc_png(self.out_path(self.prc_png_fn.replace("{cls}", cls)),
                             cls, rec, prec, ap)
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        line = f"mAP={mean_ap:.4f} over {len(aps)} classes"
        print(line)
        lines.append(line)
        return aps, lines

    def main(self):
        db = load_pil(self.imgset_fn, self.ann_dir)
        res = {cls: read_results_file(fn)
               for cls, fn in self.res_fns.items()}
        _aps, lines = self.score_class_set(db, res)
        if self.summary_fn:
            self.out_path(self.summary_fn).write_text("\n".join(lines) + "\n")


@mode("score_files", help="score per-class PASCAL results files by pattern")
class ScoreFiles(Score):
    """Reference: score_results_files_t (results_io.cc:470): a %s filename
    pattern over a class list, one summary + prc txt/png per class."""

    res_fns = Attr(dict[str, str], default=None, help="(unused here)")
    res_fn_pat = Attr(str, req=True,
                      help="results-file pattern; %s expands to class name")
    classes = Attr(list[str], default=None,
                   help="class names (default: all classes in annotations)")

    def main(self):
        db = load_pil(self.imgset_fn, self.ann_dir)
        classes = self.classes or sorted(
            {c for ii in db.values() for c in ii.gt})
        if not classes:
            raise RtErr("score_files: no classes (none given, none in "
                        "annotations)")
        res = {cls: read_results_file(self.res_fn_pat % cls)
               for cls in classes}
        _aps, lines = self.score_class_set(db, res)
        if self.summary_fn:
            self.out_path(self.summary_fn).write_text("\n".join(lines) + "\n")


@mode("ham_ana", help="two-detector matched-GT difference analysis")
class HamAna(Score):
    """Reference: hamming_analysis_t (results_io.cc:645): score a
    'hamming' per-image-CSV detection set and a PASCAL-format 'dpm' set
    over the same DB, then per class count GTs matched by each/both/
    neither into diff_summ.csv."""

    res_fns = Attr(dict[str, str], default=None, help="(unused here)")
    ham_fn_pat = Attr(str, req=True, help="per-image CSV pattern; "
                      "expands (class, 1-based image index) via %s,%s")
    dpm_fn_pat = Attr(str, req=True,
                      help="PASCAL results-file pattern; %s = class")
    classes = Attr(list[str], req=True)
    score_diff_summary_fn = Attr(str, default="diff_summ.csv")

    def main(self):
        db = load_pil(self.imgset_fn, self.ann_dir)
        idents = list(db)  # file order = image index order
        rows = ["class_name,num_tot,ham_only,dpm_only,num_ham,num_dpm,"
                "num_both,num_either,num_neither,"]
        for cls in self.classes:
            ham_dets = []
            for ix, ident in enumerate(idents):
                ham_dets += read_hamming_csv_file(
                    self.ham_fn_pat % (cls, ix + 1), ident)
            dpm_dets = read_results_file(self.dpm_fn_pat % cls)

            def matched_flags(dets):
                score_results_for_class(db, cls, dets, self.iou_thresh,
                                        self.use_07_metric)
                return [g.matched for ii in db.values()
                        for g in ii.gt.get(cls, [])]

            print(f"{cls} (hamming)")
            ham_m = matched_flags(ham_dets)
            print(f"{cls} (DPM)")
            dpm_m = matched_flags(dpm_dets)
            num_tot = len(ham_m)
            num_ham = sum(ham_m)
            num_dpm = sum(dpm_m)
            num_both = sum(h and d for h, d in zip(ham_m, dpm_m))
            ham_only = num_ham - num_both
            dpm_only = num_dpm - num_both
            num_either = num_ham + num_dpm - num_both
            num_neither = num_tot - num_either
            rows.append(f"{cls},{num_tot},{ham_only},{dpm_only},{num_ham},"
                        f"{num_dpm},{num_both},{num_either},{num_neither},")
        out = self.out_path(self.score_diff_summary_fn)
        out.write_text("\n".join(rows) + "\n")
        print(f"ham_ana: wrote {out.name} ({len(self.classes)} classes)")
