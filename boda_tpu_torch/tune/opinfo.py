"""cnn_op_info and cnn_prof on the port: per-op FLOPs, bytes, arithmetic
intensity and, with run=1, time, achieved rate and % of peak.

Port of boda_tpu/tune/opinfo.py (cnn_op_info :76-154, cnn_prof :157-191)
on the port's Codegen, profile_rcg_call and machine model
(core/machine.py). %peak is against the op's own-precision peak of the
backend's card (or `peak_flops` when given); a card the machine model
does not know raises.

One difference from the JAX op_prec (opinfo.py:38-47): there an op with no
prec annotation defaults to bf16, the TPU's matrix-unit precision. The
port runs such an op in full FP32 on the CUDA cores, so it is scored
against the FP32 peak (67 TF/s on an H100 SXM), not the bf16 tensor-core
peak (989 TF/s), which would put every f32 op 15x further from its roof.
"""

from __future__ import annotations

from ..backend.iface import Backend
from ..core.config import Attr
from ..core.error import RtErr
from ..core.has_main import HasMain, mode
from ..core.machine import PRECS, peak_flops
from ..ops.cnn_variants import OpTune, add_codegen_annotations
from ..ops.op_base import OpBase, read_op_sigs
from ..ops.registry import Codegen, get_template
from ..testing.comp import comp_vars
from .prof import profile_rcg_call


def op_bytes(rfs) -> int:
    """Bytes of a reduced sig's tensors (boda_tpu/tune/opinfo.py:23-28)."""
    n = 0
    for k, v in rfs.nda_vals.items():
        if v.dims.tn != "none":
            n += v.dims.bytes_sz()
    return n


def op_prec(sig: OpBase, tune_prec: str = "") -> str:
    """The precision an annotated op sig computes in: int8 on the quant8
    path, else its prec annotation or the tune's, else f32."""
    if sig.get_u32_or("quant8", 0):
        return "int8"
    p = sig.str_vals.get("prec") or tune_prec or "f32"
    return p if p in PRECS else "f32"


def plan_mixed_peak(plan, device_kind: str) -> tuple[float, float]:
    """Site-weighted mixed-precision roofline for a lowered plan
    (boda_tpu/tune/opinfo.py:50-73): the effective peak = total_flops /
    sum_i(flops_i / peak(prec_i)), the rate a program hitting every site's
    own precision peak would achieve, each step's precision by op_prec and
    the peaks those of the named card. Returns (plan_flops,
    effective_peak_flops)."""
    tot = 0.0
    t_min = 0.0
    for s in plan.steps:
        try:
            fl = get_template(s.func_name).flops(s.sig)
        except Exception:
            continue
        if not fl:
            continue
        tot += fl
        t_min += fl / peak_flops(device_kind, op_prec(s.sig))
    return tot, (tot / t_min if t_min else 0.0)


@mode("cnn_op_info", help="cnn_op_info on the port: per-op flops/AI/"
                          "roofline report (+optional run)")
class CnnOpInfo(HasMain):
    ops_fn = Attr(str, req=True, help="op-sig list file")
    rtc = Attr(Backend, default="torch",
               help="backend: be=torch (device=cuda by default) or be=interp")
    op_tune = Attr(OpTune, default="()")
    comp_tune = Attr(OpTune, default=None, help="comparison tune (e.g. (use_culibs=1))")
    run = Attr(bool, default=False, help="also run+time each op")
    run_iter = Attr(int, default=5)
    peak_flops = Attr(float, default=0.0, help="peak FLOP/s (0=auto from device)")
    mrd_toler = Attr(float, default=5e-4)
    latex_fn = Attr(str, default="", help="also write a LaTeX table here "
                    "(reference: conv_op_info_to_latex_t, latex-util.H:22)")

    def get_ops(self):
        return read_op_sigs(self.ops_fn)

    def _peak(self, prec: str) -> float:
        """peak_flops when given, else the backend card's peak in prec."""
        if self.peak_flops:
            return self.peak_flops
        if not hasattr(self.rtc, "device_kind"):
            raise RtErr(f"{self.TYPE_ID}: be={self.rtc.TYPE_ID} has no card "
                        f"to take peaks from; give peak_flops")
        return peak_flops(self.rtc.device_kind(), prec)

    def main(self):
        ops = self.get_ops()
        cg = None
        if self.run:
            self.rtc.ensure_init()
            cg = Codegen(self.rtc)
        print(f"{'op':58s} {'func':12s} {'Mflops':>10s} {'MB':>8s} {'AI':>7s}"
              + (f" {'prec':>4s} {'secs':>11s} {'GF/s':>9s} {'%peak':>6s}"
                 if self.run else ""))
        n_err = 0
        rows = []
        for op in ops:
            top = op.copy()
            add_codegen_annotations(top, self.op_tune)
            tmpl = get_template(top.func_name)
            rfs = tmpl.check_args(top)
            fl = tmpl.flops(rfs)
            by = op_bytes(rfs)
            line = (f"{str(op.to_compact_lexp())[:58]:58s} {top.func_name:12s} "
                    f"{fl / 1e6:10.1f} {by / 1e6:8.2f} {fl / max(by, 1):7.1f}")
            secs_gfs, op_pk = None, None
            if self.run:
                prec = op_prec(top, self.op_tune.prec)
                op_pk = self._peak(prec)
                try:
                    secs, outs = profile_rcg_call(cg, top, self.run_iter)
                    gfs = fl / secs / 1e9 if secs > 0 else 0.0
                    secs_gfs = (secs, gfs)
                    line += (f" {prec:>4s} {secs:11.3e} {gfs:9.1f} "
                             f"{100 * gfs * 1e9 / op_pk:6.2f}")
                    if self.comp_tune is not None:
                        cop = op.copy()
                        add_codegen_annotations(cop, self.comp_tune)
                        csecs, couts = profile_rcg_call(cg, cop, self.run_iter)
                        errs = comp_vars(couts, outs, self.mrd_toler)
                        line += (f"  comp={csecs:.3e}({top.func_name} vs "
                                 f"{cop.func_name})")
                        if errs:
                            line += " COMP_FAIL: " + "; ".join(errs)
                            n_err += 1
                except RtErr as e:
                    line += f" ERROR {e}"
                    n_err += 1
            print(line)
            rows.append((top.func_name, fl, by, secs_gfs, op_pk))
        if self.latex_fn:
            self._write_latex(rows)
        if n_err:
            raise RtErr(f"{self.TYPE_ID}: {n_err} errors")

    def _write_latex(self, rows) -> None:
        with open(self.out_path(self.latex_fn), "w") as f:
            f.write("\\begin{tabular}{%s}\n"
                    % ("l r r r" + (" r r" if self.run else "")))
            f.write("op & MFLOPs & MB & AI"
                    + (" & GF/s & \\%peak" if self.run else "") + " \\\\\n"
                    "\\hline\n")
            for fn_name, fl, by, sg, pk in rows:
                r = (f"{fn_name} & {fl / 1e6:.1f} & {by / 1e6:.2f} & "
                     f"{fl / max(by, 1):.1f}")
                if sg:
                    r += f" & {sg[1]:.1f} & {100 * sg[1] * 1e9 / pk:.2f}"
                f.write(r + " \\\\\n")
            f.write("\\end{tabular}\n")
        print(f"wrote latex table to {self.latex_fn}")


@mode("cnn_prof", help="cnn_prof on the port: per-op profile of a "
                       "NET's ops (no sig file needed)")
class CnnProf(CnnOpInfo):
    """cnn_prof (opinfo.py:157-191) on the port: the same report over the
    conv and fc ops of a zoo model or prototxt, deduplicated by sig."""

    ops_fn = Attr(str, default="", help="(unused; ops come from the model)")
    model = Attr(str, default="", help="zoo model name")
    ptt_fn = Attr(str, default="", help="or a prototxt path")
    batch = Attr(int, default=1)
    dedup = Attr(bool, default=True, help="collapse duplicate op sigs")
    sigs_out_fn = Attr(str, default="", help="also write the op-sig list "
                       "here (feeds ops_prof sweeps)")

    def get_ops(self):
        from ..graph.modes import _load_pipe
        from ..ops.op_base import write_op_sigs
        pipe = _load_pipe(self)
        ops = []
        seen = set()
        for op in pipe.topo_order():
            if op.type not in ("Convolution", "Deconvolution", "InnerProduct"):
                continue
            o = op.copy()
            o.str_vals.pop("caffe_name", None)
            if self.dedup:
                k = o._key()
                if k in seen:
                    continue
                seen.add(k)
            ops.append(o)
        if self.sigs_out_fn:
            write_op_sigs(self.out_path(self.sigs_out_fn), ops)
        return ops
