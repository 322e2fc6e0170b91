"""Test-harness CLI modes.

The port's copy of boda_tpu/testing/modes.py, capability parity with the
reference's harness (SURVEY.md §4):

  * test_cmds (test_nesi.cc:516) — golden-output regression over real CLI
    invocations: each test spec line names a command, optional expected
    error string (err=, exact-match), feature gating (needs=), slow=
    gating; command outputs land in an output dir that is directory-diffed
    against an archived known-good tree (good_tr/<name>/), with
    --update-failing to re-archive.
  * test_compute_multi (test_compute.cc:24) — run N engines on the same
    net+inputs, compare all vars within per-var mrd tolerances, write
    digest files, compare vs known-good digest streams. The default
    engines are ref=(engine=ref) and torch=(engine=torch,keep_all_nodes=1).
  * test_dense (test_dense.cc:45) — dense-vs-sliding-window equivalence:
    features computed from an image window must match the corresponding
    crop of whole-image features (MRD ≤ 5e-5), validating the support/
    stride/padding semantics of the whole IR. The window runs through
    the same engine (conv_fwd, re-initialized on the window's net), so a
    tune is held against itself.
  * test_upsamp (test_dense.cc:145) — the 2x-upsampled companion net
    against the original net on the upsampled image, both through
    conv_fwd.
  * test_all (test_all.cc:18) — runs the suite list, and the generated
    suites (gen_test_compute_tests, gen_ops_prof_tests), which name the
    port's engines (engine=torch).
  * comp_ndas (test_nesi.cc:91) — compare two saved tensor files.
"""

from __future__ import annotations

import difflib
import shutil
import traceback
from pathlib import Path

import numpy as np

from ..core.config import Attr
from ..core.dims import NDA
from ..core.error import RtErr
from ..core.features import is_feature_enabled
from ..core.geom import Box, Pt
from ..core.has_main import HasMain, create_and_run_has_main, mode
from ..core.lexp import parse_lexp
from ..engine.iface import ConvFwd
from ..graph.modes import _NetMode
from .comp import (comp_digests, comp_vars, read_digest_stream,
                   write_digest_stream)


@mode("comp_ndas", help="compare two saved nda files within a tolerance")
class CompNdas(HasMain):
    a_fn = Attr(str, req=True)
    b_fn = Attr(str, req=True)
    mrd_toler = Attr(float, default=5e-4)

    def main(self):
        a, _ = NDA.bread(Path(self.a_fn).read_bytes())
        b, _ = NDA.bread(Path(self.b_fn).read_bytes())
        errs = comp_vars({"nda": a}, {"nda": b}, self.mrd_toler)
        if errs:
            raise RtErr("comp_ndas FAILED: " + "; ".join(errs))
        print("comp_ndas PASSED")


def _dir_diff(got: Path, want: Path, ignore_pat=None) -> list[str]:
    """Directory diff (reference: dtl-based diff_file, test_nesi.cc:569-639):
    missing/extra/differing files, with text diffs for small text files.
    Files matching ignore_pat are existence-checked but not content-diffed."""
    errs = []
    got_files = {p.relative_to(got) for p in got.rglob("*") if p.is_file()}
    want_files = {p.relative_to(want) for p in want.rglob("*") if p.is_file()}
    for f in sorted(want_files - got_files):
        errs.append(f"MISSING output file: {f}")
    for f in sorted(got_files - want_files):
        errs.append(f"EXTRA output file: {f}")
    for f in sorted(got_files & want_files):
        if ignore_pat is not None and ignore_pat.search(str(f)):
            continue
        gb = (got / f).read_bytes()
        wb = (want / f).read_bytes()
        if gb == wb:
            continue
        try:
            gt, wt = gb.decode(), wb.decode()
            diff = list(difflib.unified_diff(wt.splitlines(), gt.splitlines(),
                                             str(f) + ".good", str(f), lineterm=""))
            errs.append(f"DIFFERING output file: {f}\n" + "\n".join(diff[:20]))
        except UnicodeDecodeError:
            errs.append(f"DIFFERING (binary) output file: {f}")
    return errs


@mode("test_cmds", help="golden-output regression over CLI commands")
class TestCmds(HasMain):
    cmds_fn = Attr(str, req=True, help="test spec file: one lexp per line "
                   "(test_name=...,cmd=(...),err=...,needs=...,slow=0)")
    good_tr_dir = Attr(str, default="%(boda_test_dir)/../good_tr",
                       help="known-good archives (shipped: tests/good_tr)")
    run_slow = Attr(bool, default=False)
    update_failing = Attr(bool, default=False,
                          help="re-archive failing tests' outputs as known-good")
    filt = Attr(str, default="", help="only run tests whose name contains this")

    def main(self):
        n_run = n_pass = n_skip = 0
        fails: list[str] = []
        for line in Path(self.cmds_fn).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            spec = parse_lexp(line)
            # mark only the spec's own keys used — the cmd subtree's use
            # counts belong to the command's own unused-arg checking
            spec.use_cnt += 1
            for _n, v in spec.iter_kids():
                v.use_cnt += 1
            name = spec.get_kid("test_name").leaf_val
            if self.filt and self.filt not in name:
                continue
            if spec.get_kid("slow") and spec.get_kid("slow").leaf_val == "1" \
                    and not self.run_slow:
                n_skip += 1
                continue
            needs = spec.get_kid("needs")
            if needs is not None and not all(
                    is_feature_enabled(f) for f in needs.leaf_val.split(",")):
                n_skip += 1
                continue
            expect_err = spec.get_kid("err")
            cmd = spec.get_kid("cmd")
            out_dir = self.out_path(name)
            if out_dir.exists():
                shutil.rmtree(out_dir)
            out_dir.mkdir(parents=True)
            cmd.add_key_val("boda_output_dir", str(out_dir))
            n_run += 1
            got_err = None
            # cap_out=1: archive the command's stdout as a golden file too
            cap_out = spec.get_kid("cap_out")
            cap = cap_out is not None and cap_out.leaf_val == "1"
            try:
                if cap:
                    import contextlib
                    import io
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        create_and_run_has_main(cmd)
                    (out_dir / "__stdout__.txt").write_text(buf.getvalue())
                else:
                    create_and_run_has_main(cmd)
            except RtErr as e:
                got_err = str(e)
            except Exception as e:  # pragma: no cover
                got_err = f"UNEXPECTED {type(e).__name__}: {e}"
                traceback.print_exc()
            if expect_err is not None:
                if got_err is None:
                    fails.append(f"{name}: expected error '{expect_err.leaf_val}' "
                                 "but command succeeded")
                elif expect_err.leaf_val not in got_err:
                    fails.append(f"{name}: expected error '{expect_err.leaf_val}' "
                                 f"but got '{got_err}'")
                else:
                    n_pass += 1
                continue
            if got_err is not None:
                fails.append(f"{name}: unexpected error: {got_err}")
                continue
            ignore = spec.get_kid("ignore")
            ignore_pat = None
            if ignore is not None:
                # files matching this regex are existence-checked only
                # (timing-dependent content, e.g. measured-perf plot images)
                import re as _re
                ignore_pat = _re.compile(ignore.leaf_val)
            scrub = spec.get_kid("scrub")
            if scrub is not None:
                # normalize run-varying text (timings, rates) before
                # archiving/diffing — the reference's test_cmds filtered
                # timing output the same way (test_cmds.cc diff filters)
                import re as _re
                # MULTILINE: ^/$ anchor per line (raw-number lines in
                # wisdom files are timing records)
                pat = _re.compile(scrub.leaf_val, _re.MULTILINE)
                for f in out_dir.rglob("*"):
                    if not f.is_file():
                        continue
                    try:
                        txt = f.read_text()
                    except (UnicodeDecodeError, OSError):
                        continue
                    f.write_text(pat.sub("SCRUBBED", txt))
            good = Path(self.good_tr_dir) / name
            if not good.exists():
                if self.update_failing:
                    shutil.copytree(out_dir, good)
                    print(f"{name}: archived new known-good outputs")
                    n_pass += 1
                else:
                    fails.append(f"{name}: no known-good dir '{good}' "
                                 "(run with update_failing=1 to create)")
                continue
            errs = _dir_diff(out_dir, good, ignore_pat)
            if errs:
                if self.update_failing:
                    shutil.rmtree(good)
                    shutil.copytree(out_dir, good)
                    print(f"{name}: re-archived known-good outputs")
                    n_pass += 1
                else:
                    fails.append(f"{name}: " + "; ".join(errs))
            else:
                n_pass += 1
        print(f"test_cmds: {n_pass}/{n_run} passed, {n_skip} skipped, "
              f"{len(fails)} failed")
        for f in fails:
            print("FAIL " + f)
        if fails:
            raise RtErr(f"test_cmds: {len(fails)} test(s) failed")


@mode("test_compute_multi", help="multi-engine numerical comparison on one net")
class TestComputeMulti(_NetMode):
    engines = Attr(dict[str, ConvFwd], default=None,
                   help="named engines; default (ref=(engine=ref),"
                        "torch=(engine=torch,keep_all_nodes=1))")
    vars = Attr(list[str], default=None, help="nodes to compare (default: top)")
    all_vars = Attr(bool, default=False, help="compare every node")
    mrd_toler = Attr(float, default=5e-4)
    var_mrd_toler = Attr(dict[str, float], default=None)
    tpd = Attr(int, default=0, help="test-pattern mode for input")
    write_digests = Attr(bool, default=True)
    kg_digests_fn = Attr(str, default="", help="known-good digest stream to compare")

    def main(self):
        from ..engine.iface import make_engine
        from ..graph.modes import _load_pipe
        from ..ops.cuda.gen_data import gen_test_nda
        pipe = _load_pipe(self)
        engines = self.engines or {
            "ref": make_engine("ref"),
            "torch": make_engine("(engine=torch,keep_all_nodes=1)")}
        d = pipe.get_data_img_dims()
        blob = NDA(d, gen_test_nda(d, self.tpd, 0.1))
        data_node = pipe.data_img_node_names[0]
        if self.all_vars:
            to_get = [n for n, nd in pipe.nodes.items()
                      if nd.dims is not None and nd.top_for]
        else:
            to_get = list(self.vars) if self.vars else [pipe.get_single_top_node().name]
        results: dict[str, dict[str, NDA]] = {}
        for en, eng in engines.items():
            eng.init(pipe)
            results[en] = eng.run_fwd({data_node: blob}, to_get)
            if self.write_digests:
                write_digest_stream(self.out_path(f"digest-{en}.boda"),
                                    results[en], self_cmp_mrd=self.mrd_toler)
        names = sorted(results)
        base = names[0]
        all_errs = []
        for other in names[1:]:
            errs = comp_vars(results[base], results[other], self.mrd_toler,
                             self.var_mrd_toler, tag_a=base, tag_b=other)
            all_errs += errs
            print(f"comp {base} vs {other}: "
                  + ("PASS" if not errs else f"{len(errs)} mismatches"))
        if self.kg_digests_fn:
            kg = read_digest_stream(self.kg_digests_fn)
            for en in names:
                errs = comp_digests(results[en], kg, self.mrd_toler,
                                    ignore_missing=True)
                all_errs += [f"[kg:{en}] {e}" for e in errs]
                print(f"kg digests vs {en}: "
                      + ("PASS" if not errs else f"{len(errs)} mismatches"))
        for e in all_errs:
            print("MISMATCH " + e)
        if all_errs:
            raise RtErr(f"test_compute_multi: {len(all_errs)} mismatches")


@mode("test_dense", help="dense-vs-sliding-window feature equivalence")
class TestDense(_NetMode):
    conv_fwd = Attr(ConvFwd, default="(engine=torch,keep_all_nodes=1)")
    win_sz = Attr(int, default=0, help="window size (default: in_sz/2, stride-aligned)")
    mrd_toler = Attr(float, default=5e-5)
    tpd = Attr(int, default=2)
    out_node = Attr(str, default="", help="feature node to compare (default: top)")

    def main(self):
        from ..graph.modes import _load_pipe
        from ..graph.support import CM_VALID, in_box_to_out_box
        from ..io.img import make_test_pattern_img, img_to_chw
        pipe = _load_pipe(self)
        pipe.out_node_name = self.out_node
        out_node = pipe.get_single_top_node()
        if self.out_node:
            pipe = pipe.pruned_to(self.out_node)
            out_node = pipe.must_get_node(self.out_node)
        csi = out_node.csi
        if not csi.valid() or csi.support_sz.is_zeros():
            raise RtErr("test_dense: output node has no valid finite support "
                        "(global pooling/fc nets can't be dense-tested at the top; "
                        "use --out-node to pick a conv feature node)")
        d = pipe.get_data_img_dims()
        full_y, full_x = d["y"], d["x"]
        st = csi.support_stride
        win = self.win_sz or (full_y // 2)
        win -= win % st.y  # stride-align window size
        # window offset must be stride-aligned for translation covariance
        oy = ((full_y - win) // 2 // st.y) * st.y
        ox = ((full_x - win) // 2 // st.x) * st.x
        img = make_test_pattern_img(full_y, full_x, self.tpd)
        chw = img_to_chw(img)
        full_blob = NDA(d, np.broadcast_to(chw[None], d.shape).copy())
        win_dims = d.with_dim("y", win).with_dim("x", win)
        win_chw = chw[:, oy:oy + win, ox:ox + win]
        # full-image run
        eng = self.conv_fwd
        eng.init(pipe)
        data_node = pipe.data_img_node_names[0]
        full_out = eng.run_fwd({data_node: full_blob}, [out_node.name])[out_node.name]
        # window run: rebuild pipe at window size
        from ..graph.modes import _load_pipe as _lp
        self.in_dims = win_dims
        if self.model:
            from ..models.zoo import build_model
            wpipe = build_model(self.model, batch=d["img"], ysz=win, xsz=win)
            wpipe.op_params = pipe.op_params  # same weights
        else:
            wpipe = _lp(self)
        if self.out_node:
            wpipe = wpipe.pruned_to(self.out_node)
        win_blob = NDA(win_dims, np.broadcast_to(win_chw[None], win_dims.shape).copy())
        eng.init(wpipe)  # the same engine and tune on the window's net
        win_out = eng.run_fwd({data_node: win_blob}, [out_node.name])[out_node.name]
        # feature boxes computed ONLY from window pixels, in each coordinate frame
        in_box_full = Box(Pt(oy, ox), Pt(oy + win, ox + win))
        ob_full = in_box_to_out_box(in_box_full, CM_VALID, csi)
        ob_win = in_box_to_out_box(Box(Pt(0, 0), Pt(win, win)), CM_VALID,
                                   wpipe.must_get_node(out_node.name).csi)
        if not (ob_full.sz() == ob_win.sz()):
            raise RtErr(f"test_dense: box size mismatch {ob_full} vs {ob_win}")
        f = full_out.v[:, :, ob_full.p0.y:ob_full.p1.y, ob_full.p0.x:ob_full.p1.x]
        w = win_out.v[:, :, ob_win.p0.y:ob_win.p1.y, ob_win.p0.x:ob_win.p1.x]
        from ..testing.comp import mrd
        m = mrd(f, w)
        print(f"test_dense: win={win}@({oy},{ox}) out_box_full={ob_full} "
              f"out_box_win={ob_win} mrd={m:.3g}")
        if m > self.mrd_toler:
            raise RtErr(f"test_dense FAILED: mrd {m:.3g} > toler {self.mrd_toler:.3g}")
        print("test_dense PASSED")


@mode("test_upsamp", help="img-upsample vs filter-fold upsampled-net equivalence")
class TestUpsamp(_NetMode):
    """Reference: test_upsamp_t (test_dense.cc:145-200): features from the
    2x-upsampled-companion net on image I must match the original net run
    on 2x-upsampled I. With nearest-neighbor upsampling and even first-conv
    stride the folded-filter equivalence is exact up to fp accumulation, so
    the default tolerance here is tighter than the reference's 2e-4.

    Under an odd first-conv pad (ResNet's conv1: 7x7/2, pad 3) the
    companion's first conv is one output wider than the original's at the
    right and bottom (its symmetric pad reads one more zero), and that
    column and row reach every later node's border: the port then compares
    the outputs whose support lies inside the image (test_dense's valid
    box), where the equivalence is exact. Even pads compare as the JAX
    mode does."""

    conv_fwd = Attr(ConvFwd, default="(engine=torch,keep_all_nodes=1)",
                    help="engine for both nets (re-initialized between them)")
    mrd_toler = Attr(float, default=2e-4)
    tpd = Attr(int, default=2)
    out_node = Attr(str, default="", help="feature node to compare (default: top)")

    def main(self):
        from ..graph.modes import _load_pipe
        from ..io.img import img_to_chw, make_test_pattern_img
        from ..models.upsamp import make_upsamp_pipe, upsample_2x_nn
        pipe = _load_pipe(self)
        pipe.out_node_name = self.out_node
        if self.out_node:
            pipe = pipe.pruned_to(self.out_node)
        out_name = (self.out_node or pipe.get_single_top_node().name)
        d = pipe.get_data_img_dims()
        if d["y"] % 2 or d["x"] % 2:
            raise RtErr("test_upsamp: input size must be even")
        # companion net runs at full input size; original net runs the same
        # pixels at half size (companion(I) ~ original(upsample_2x(I)))
        half_y, half_x = d["y"] // 2, d["x"] // 2
        img_half = make_test_pattern_img(half_y, half_x, self.tpd)
        chw_half = img_to_chw(img_half)
        chw_up = upsample_2x_nn(chw_half)

        half_dims = d.with_dim("y", half_y).with_dim("x", half_x)
        upipe = make_upsamp_pipe(pipe, in_dims=half_dims)
        if self.out_node:
            upipe = upipe.pruned_to(self.out_node)
        ueng = self.conv_fwd
        ueng.init(upipe)
        data_node = pipe.data_img_node_names[0]
        ub = NDA(half_dims, np.broadcast_to(
            chw_half[None], half_dims.shape).copy())
        u_out = ueng.run_fwd({data_node: ub}, [out_name])[out_name]

        eng = self.conv_fwd  # the same engine, on the original net
        eng.init(pipe)
        fb = NDA(d, np.broadcast_to(chw_up[None], d.shape).copy())
        f_out = eng.run_fwd({data_node: fb}, [out_name])[out_name]

        from ..graph.support import CM_VALID, in_box_to_out_box
        from ..models.upsamp import first_conv_op
        from ..testing.comp import mrd
        ya = min(u_out.v.shape[2], f_out.v.shape[2])
        xa = min(u_out.v.shape[3], f_out.v.shape[3])
        y0 = x0 = 0
        pd = first_conv_op(pipe).in_pad()
        if pd.y % 2 or pd.x % 2:
            ob = in_box_to_out_box(Box(Pt(0, 0), Pt(d["y"], d["x"])),
                                   CM_VALID, pipe.must_get_node(out_name).csi)
            y0, x0 = ob.p0.y, ob.p0.x
            ya, xa = min(ya, ob.p1.y), min(xa, ob.p1.x)
            if ya <= y0 or xa <= x0:
                raise RtErr(f"test_upsamp: the first conv's pad {pd} is odd, "
                            f"so only outputs whose support lies inside the "
                            f"image compare, and node '{out_name}' has none "
                            f"at this input size")
        m = mrd(u_out.v[:, :, y0:ya, x0:xa], f_out.v[:, :, y0:ya, x0:xa])
        at = f" from ({y0},{x0})" if y0 or x0 else ""
        print(f"test_upsamp: node={out_name} up={u_out.dims.pretty()} "
              f"full={f_out.dims.pretty()} cmp=({ya - y0},{xa - x0}){at} "
              f"mrd={m:.3g}")
        if m > self.mrd_toler:
            raise RtErr(f"test_upsamp FAILED: mrd {m:.3g} > toler "
                        f"{self.mrd_toler:.3g}")
        print("test_upsamp PASSED")


@mode("test_all", help="run the full test suite list")
class TestAll(HasMain):
    cmds_fns = Attr(list[str], default=None,
                    help="test_cmds spec files (default: the shipped "
                         "tests/cmds/*.txt suites)")
    good_tr_dir = Attr(str, default="", help="goldens dir (default: shipped "
                                             "tests/good_tr)")
    run_slow = Attr(bool, default=True,
                    help="run slow=1 cmds too (default ON: test_all is the "
                         "full-coverage pass; the tight loop is pytest)")
    run_gen = Attr(bool, default=True,
                   help="also regenerate + run the generated suites "
                        "(gen_test_compute_tests, gen_ops_prof_tests) — the "
                        "reference test_all's two generated xmls "
                        "(test_nesi.cc:652-653)")
    update_failing = Attr(bool, default=False,
                          help="passed through to test_cmds")

    def main(self):
        fns = self.cmds_fns
        good = self.good_tr_dir
        if not fns:
            root = Path(__file__).resolve().parents[2]
            fns = sorted(str(p) for p in (root / "tests" / "cmds").glob("*.txt"))
            good = good or str(root / "tests" / "good_tr")
        # default run trees under <repo>/test_tr/ (gitignored) rather than
        # cwd, so `python -m boda_tpu_torch test_all` can't litter / commit its
        # per-test output dirs next to the source tree — anchored to the
        # repo root (matching the anchored .gitignore entry) so runs from a
        # subdirectory don't recreate the litter problem there.
        out_dir = self.boda_output_dir
        if out_dir == ".":
            out_dir = str(Path(__file__).resolve().parents[2] / "test_tr")
        if self.run_gen:
            # regenerate the generated suites into the run tree and append
            # them to the suite list (reference: test_all re-emits and runs
            # gen_test_compute_tests.xml / gen_ops_prof_tests.xml on the fly)
            for gen_mode in ("gen_test_compute_tests", "gen_ops_prof_tests"):
                create_and_run_has_main(
                    f"(mode={gen_mode},boda_output_dir={out_dir})")
                fns = fns + [str(Path(out_dir) / f"{gen_mode}.txt")]
        fails = []
        uf = f",update_failing={int(self.update_failing)}"
        for fn in fns:
            try:
                gtd = f",good_tr_dir={good}" if good else ""
                create_and_run_has_main(
                    f"(mode=test_cmds,cmds_fn={fn},run_slow={int(self.run_slow)}"
                    f"{gtd}{uf},boda_output_dir={out_dir})")
            except RtErr as e:
                fails.append(f"{fn}: {e}")
        if fails:
            raise RtErr("test_all: " + "; ".join(fails))
        print("test_all PASSED")


@mode("gen_test_compute_tests",
      help="generate a test_cmds spec: models x engines matrix")
class GenTestComputeTests(HasMain):
    """Reference: gen_test_compute_tests (test_compute.cc:216-276) — emit
    test_cmds entries running test_compute_multi over a model x engine x
    variant matrix; test_all regenerates and runs them."""

    out_fn = Attr(str, default="gen_test_compute_tests.txt")
    models = Attr(list[str], default="mini",
                  help="zoo models to cover (space-separated)")
    in_sz = Attr(int, default=64, help="input spatial size")

    def main(self):
        lines = []
        for m in self.models:
            sz = self.in_sz if m == "mini" else max(self.in_sz, 192)
            base = (f"mode=test_compute_multi,model={m},batch=1,"
                    f"in_dims=(dims=(img=1,chan=3,y={sz},x={sz}))")
            lines.append(f"(test_name=comp_{m},cap_out=1,cmd=({base}))")
            lines.append(
                f"(test_name=comp_{m}_engines,cap_out=1,cmd=({base},"
                f"engines=(ref=(engine=ref),fused=(engine=torch,fuse=1),"
                f"percall=(engine=torch,fuse=0))))")
        p = self.out_path(self.out_fn)
        p.write_text("\n".join(lines) + "\n")
        print(f"gen_test_compute_tests: {len(lines)} tests -> {self.out_fn}")


@mode("gen_ops_prof_tests",
      help="generate a test_cmds spec: ops_prof sweeps over op-sig files")
class GenOpsProfTests(HasMain):
    """Reference: gen_ops_prof_tests (rtc_prof.cc:460)."""

    out_fn = Attr(str, default="gen_ops_prof_tests.txt")
    ops_fns = Attr(list[str], default="%(boda_test_dir)/ops/sgemm-tiny.txt "
                                      "%(boda_test_dir)/ops/conv-tiny.txt")

    def main(self):
        lines = []
        for fn in self.ops_fns:
            name = Path(fn).stem.replace("-", "_")
            # measured rates/times are run-varying: scrub them so the golden
            # diff pins the op list + cross-check verdicts only
            lines.append(f"(test_name=ops_prof_{name},cap_out=1,"
                         f"scrub=secs=\\\\S+|GF/s=\\\\S+|^[0-9.e-]+$,"
                         f"cmd=(mode=ops_prof,ops_fn={fn},run_iter=2,"
                         f"rtcs=(interp=(be=interp))))")
        p = self.out_path(self.out_fn)
        p.write_text("\n".join(lines) + "\n")
        print(f"gen_ops_prof_tests: {len(lines)} tests -> {self.out_fn}")
