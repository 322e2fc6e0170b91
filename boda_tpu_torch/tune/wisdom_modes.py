"""Wisdom file CLI modes (reference: wis-merge op-tuner.cc:162, wis-ana
op-tuner.cc:205+ — best-tune-per-op analysis with speedup vs a reference
tune, CSV output for plots/papers).

The port's copy of boda_tpu/tune/wisdom_modes.py, over the port's copy of
the wisdom format (tune/wisdom.py): the same text, CSV and LaTeX.
"""

from __future__ import annotations

from ..core.config import Attr
from ..core.has_main import HasMain, mode
from .wisdom import merge_wisdoms, read_wisdom_file, write_wisdom_file


@mode("wis_merge", help="merge wisdom files (runs merge per op+tune+platform)")
class WisMerge(HasMain):
    wisdom_in_fns = Attr(list[str], req=True, help="input wisdom files")
    wisdom_out_fn = Attr(str, default="merged.wis")

    def main(self):
        streams = [read_wisdom_file(fn) for fn in self.wisdom_in_fns]
        merged = merge_wisdoms(streams)
        write_wisdom_file(self.out_path(self.wisdom_out_fn), merged)
        print(f"wis_merge: {sum(len(s) for s in streams)} records from "
              f"{len(self.wisdom_in_fns)} files -> {len(merged)} merged ops")


@mode("wis_ana", help="analyze wisdom: best tune per op, speedup vs ref tune")
class WisAna(HasMain):
    wisdom_in_fn = Attr(str, req=True)
    plat = Attr(str, default="", help="platform tag filter (default: all)")
    ref_tune_contains = Attr(str, default="use_culibs",
                             help="substring marking the reference tune")
    csv_fn = Attr(str, default="", help="also write CSV here")
    latex_fn = Attr(str, default="", help="also write a LaTeX table here "
                    "(reference: wis-ana latex output, op-tuner.cc:205+)")

    def main(self):
        ws = read_wisdom_file(self.wisdom_in_fn)
        rows = []
        for w in ws:
            plats = sorted({p for tw in w.tunes.values() for p in tw.runs})
            for plat in plats:
                if self.plat and self.plat not in plat:
                    continue
                best = w.best_tune(plat)
                if best is None:
                    continue
                ref_secs = None
                for ts, tw in w.tunes.items():
                    if self.ref_tune_contains and self.ref_tune_contains in ts:
                        s = tw.runs.get(plat)
                        if s is not None and (ref_secs is None or s < ref_secs):
                            ref_secs = s
                speedup = (ref_secs / best[1]) if ref_secs else 0.0
                rows.append((str(w.op.to_compact_lexp()), plat, best[0],
                             best[1], ref_secs or 0.0, speedup))
        hdr = f"{'op':60s} {'plat':24s} {'best_tune':28s} {'secs':>11s} {'ref_secs':>11s} {'speedup':>8s}"
        print(hdr)
        for op_s, plat, tune_s, secs, ref_s, spd in rows:
            print(f"{op_s[:60]:60s} {plat[:24]:24s} {tune_s[:28]:28s} "
                  f"{secs:11.3e} {ref_s:11.3e} {spd:8.2f}")
        if self.csv_fn:
            with open(self.out_path(self.csv_fn), "w") as f:
                f.write("op,plat,best_tune,secs,ref_secs,speedup\n")
                for r in rows:
                    f.write(",".join(str(x).replace(",", ";") for x in r) + "\n")
            print(f"wrote {len(rows)} rows to {self.csv_fn}")
        if self.latex_fn:
            with open(self.out_path(self.latex_fn), "w") as f:
                f.write("\\begin{tabular}{l l l r r r}\n")
                f.write("op & plat & best tune & secs & ref secs & speedup "
                        "\\\\\n\\hline\n")
                for op_s, plat, tune_s, secs, ref_s, spd in rows:
                    esc = lambda t: t.replace("_", "\\_")[:40]
                    f.write(f"{esc(op_s)} & {esc(plat)} & {esc(tune_s)} & "
                            f"{secs:.3e} & {ref_s:.3e} & {spd:.2f} "
                            "\\\\\n")
                f.write("\\end{tabular}\n")
            print(f"wrote latex table to {self.latex_fn}")
