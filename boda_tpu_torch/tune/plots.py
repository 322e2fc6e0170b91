"""Performance plotting modes.

Capability parity with the reference's pysrc plot suite —
roofline_plot.py (op GF/s vs arithmetic intensity against the device
roofline), op-eff-plot.py (per-op efficiency bars), wis-plot.py (per-op
runtime across tunes from a wisdom DB) — driven by boda-aa-fig-gen.py.
Rendered headless via matplotlib Agg to PNGs.

The port of boda_tpu/tune/plots.py. The roof is the card's
(core/machine.card_peaks: the peak in the tune's precision, f32 where the
tune names none, and the HBM rate) unless peak_flops and hbm_gbps are
given; --run and op_eff_plot time each op on be=torch (CUDA events on the
card) and score it against its own precision's peak, as cnn_op_info does.
"""

from __future__ import annotations

from pathlib import Path

from ..backend.iface import Backend
from ..core.config import Attr
from ..core.error import RtErr
from ..core.has_main import HasMain, mode
from ..core.machine import PRECS
from ..ops.cnn_variants import OpTune, add_codegen_annotations
from ..ops.registry import get_template
from .opinfo import op_bytes, op_prec, read_op_sigs


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:
        raise RtErr("plot modes require matplotlib") from e


def _card_peaks(rtc):
    """core/machine.card_peaks of the card of backend rtc (be=torch)."""
    from ..core.machine import card_peaks
    rtc.ensure_init()
    if not hasattr(rtc, "device_kind"):
        raise RtErr(f"be={rtc.TYPE_ID} has no card to take peaks from; "
                    f"give peak_flops and hbm_gbps")
    return card_peaks(rtc.device_kind())


@mode("roofline_plot",
      help="roofline chart of ops (GF/s vs AI) from a profiled op-sig file")
class RooflinePlot(HasMain):
    ops_fn = Attr(str, req=True, help="op-sig list file")
    out_fn = Attr(str, req=True, help="output PNG")
    op_tune = Attr(OpTune, default="()")
    peak_flops = Attr(float, default=0.0)
    hbm_gbps = Attr(float, default=0.0,
                    help="HBM bandwidth GB/s (0=auto: the card's, "
                         "core/machine.card_peaks)")
    run = Attr(bool, default=False, help="run ops to place achieved points "
                                         "(else plot AI positions on the roof)")
    run_iter = Attr(int, default=5)
    rtc = Attr(Backend, default="torch",
               help="backend for --run and the card's peaks: be=torch "
                    "(device=cuda by default)")

    def main(self):
        import numpy as np
        plt = _plt()
        ops = read_op_sigs(self.ops_fn)
        pk = None
        if not (self.peak_flops and self.hbm_gbps):
            pk = _card_peaks(self.rtc)
        # the tune's precision, f32 where it names none (opinfo.op_prec)
        prec = self.op_tune.prec if self.op_tune.prec in PRECS else "f32"
        peak = self.peak_flops or pk.flops(prec)
        bw = self.hbm_gbps * 1e9 if self.hbm_gbps else pk.hbm_bw
        ais, gfs, labels = [], [], []
        cg = None
        if self.run:
            from ..ops.registry import Codegen
            from .prof import profile_rcg_call
            self.rtc.ensure_init()
            cg = Codegen(self.rtc)
        for op in ops:
            top = op.copy()
            add_codegen_annotations(top, self.op_tune)
            tmpl = get_template(top.func_name)
            rfs = tmpl.check_args(top)
            fl = tmpl.flops(rfs)
            ai = fl / max(op_bytes(rfs), 1)
            ais.append(ai)
            if self.run:
                secs, _ = profile_rcg_call(cg, top, self.run_iter)
                gfs.append(fl / secs / 1e9 if secs > 0 else 0.0)
            else:
                gfs.append(min(peak, ai * bw) / 1e9)
            labels.append(top.func_name)
        fig, ax = plt.subplots(figsize=(7, 5))
        x = np.logspace(-2, 4, 200)
        ax.plot(x, np.minimum(peak, x * bw) / 1e9, "k-", lw=1.5,
                label=f"roof: {peak/1e12:.0f} TF/s, {bw/1e9:.0f} GB/s")
        ax.plot(ais, gfs, "o", ms=6, alpha=0.7)
        for ai, gf, lb in zip(ais, gfs, labels):
            ax.annotate(lb, (ai, gf), fontsize=6, alpha=0.6)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("arithmetic intensity (FLOP/byte)")
        ax.set_ylabel("GF/s")
        ax.set_title("op roofline" + (" (measured)" if self.run else " (bound)"))
        ax.legend(fontsize=8)
        ax.grid(True, which="both", alpha=0.2)
        fig.savefig(self.out_path(self.out_fn), dpi=110, bbox_inches="tight")
        knee = peak / bw  # AI where the memory roof meets the compute roof
        print(f"roofline_plot: {len(ops)} ops -> {self.out_fn} "
              f"(knee AI={knee:.2f} FLOP/B)")
        for ai, gf, lb in zip(ais, gfs, labels):
            print(f"  {lb}: ai={ai:.2f} {'meas' if self.run else 'bound'}"
                  f"={gf:.1f} GF/s")


@mode("wis_plot", help="per-op runtime across tunes/platforms from wisdom")
class WisPlot(HasMain):
    wis_fn = Attr(str, req=True, help="wisdom file")
    out_fn = Attr(str, req=True, help="output PNG")
    plat = Attr(str, default="", help="platform tag filter (default: all)")

    def main(self):
        import numpy as np
        plt = _plt()
        from .wisdom import read_wisdom_file
        ws = read_wisdom_file(self.wis_fn)
        if not ws:
            raise RtErr(f"wis_plot: no wisdom records in {self.wis_fn}")
        series: dict[str, list[tuple[int, float]]] = {}
        for i, w in enumerate(ws):
            for tune_str, tw in w.tunes.items():
                for plat, secs in tw.runs.items():
                    if self.plat and plat != self.plat:
                        continue
                    series.setdefault(f"{tune_str}@{plat}", []).append((i, secs))
        fig, ax = plt.subplots(figsize=(8, 5))
        for name, pts in sorted(series.items()):
            xs = [p[0] for p in pts]
            ys = [p[1] * 1e3 for p in pts]
            ax.plot(xs, ys, "o-", ms=4, lw=1, label=name[:48])
        ax.set_yscale("log")
        ax.set_xlabel("op index")
        ax.set_ylabel("runtime (ms)")
        ax.set_title(Path(self.wis_fn).name)
        ax.legend(fontsize=6)
        ax.grid(True, alpha=0.2)
        fig.savefig(self.out_path(self.out_fn), dpi=110, bbox_inches="tight")
        print(f"wis_plot: {len(ws)} ops, {len(series)} series -> {self.out_fn}")


@mode("op_eff_plot", help="per-op efficiency (%% of peak) bar chart")
class OpEffPlot(HasMain):
    ops_fn = Attr(str, req=True)
    out_fn = Attr(str, req=True)
    op_tune = Attr(OpTune, default="()")
    peak_flops = Attr(float, default=0.0,
                      help="peak FLOP/s (0=the card's, in each op's own "
                           "precision)")
    run_iter = Attr(int, default=5)
    rtc = Attr(Backend, default="torch",
               help="backend: be=torch (device=cuda by default)")

    def main(self):
        plt = _plt()
        from ..ops.registry import Codegen
        from .prof import profile_rcg_call
        ops = read_op_sigs(self.ops_fn)
        pk = None if self.peak_flops else _card_peaks(self.rtc)
        self.rtc.ensure_init()
        cg = Codegen(self.rtc)
        effs, labels = [], []
        for i, op in enumerate(ops):
            top = op.copy()
            add_codegen_annotations(top, self.op_tune)
            tmpl = get_template(top.func_name)
            rfs = tmpl.check_args(top)
            fl = tmpl.flops(rfs)
            peak = self.peak_flops or \
                pk.flops(op_prec(top, self.op_tune.prec))
            secs, _ = profile_rcg_call(cg, top, self.run_iter)
            effs.append(100.0 * fl / secs / peak if secs > 0 else 0.0)
            labels.append(f"{i}:{top.func_name}")
        fig, ax = plt.subplots(figsize=(max(6, len(ops) * 0.5), 4))
        ax.bar(range(len(effs)), effs)
        ax.set_xticks(range(len(labels)))
        ax.set_xticklabels(labels, rotation=60, fontsize=6, ha="right")
        ax.set_ylabel("% of peak")
        ax.grid(True, axis="y", alpha=0.2)
        fig.savefig(self.out_path(self.out_fn), dpi=110, bbox_inches="tight")
        print(f"op_eff_plot: {len(ops)} ops -> {self.out_fn}")
