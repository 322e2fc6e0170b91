"""The JAX package's golden CLI suites through the port.

`python -m boda_tpu_torch test_all` runs test_cmds over the checked-in
suites (tests/cmds/base.txt and tests/cmds/modes.txt) and the two
generated ones (gen_test_compute_tests, gen_ops_prof_tests), in one process
on the CPU (BODA_TORCH_DEVICE=cpu: every engine spec that names no device would
otherwise ask for the card), and diffs each spec's outputs against the
unchanged archives in tests/good_tr. Every spec must pass the byte diff,
except those of one closed list, CLOSED, each with its class and reason
(class (a), a mode the port did not register yet, is empty since mh_test
and pp_test were ported):

  (b) the archive names a JAX engine by its JAX name (engine=rtc, the
      engine's digest file digest-rtc.boda): the spec's files are held to
      the archive's with the port's name put back (byte-equal text, digests
      by value);
  (c) an engine-numeric output whose bits differ between the JAX package's
      CPU run and the port's: the spec is not skipped, its files are held
      to the archive's by value — digests through testing/comp's
      Digest.comp, printed numbers token by token, trained weights
      (.caffemodel) blob by blob — at the tolerance schema's mrd: 5e-4
      for f32 (F32_MRD), 5e-3 for a bf16 tune (BF16_MRD), 5e-2 for
      weights after bf16 training steps (TRAIN_BF16_MRD), a printed
      number also within one unit of its last printed digit.

Each listed spec is asserted to still fail the byte diff (a spec that
starts to pass must leave the list), and every other spec to pass it. Two
archives name a path of the checkout they were written in (read from
lmdb_parse's archived stdout); run from another checkout, those two specs
are held byte-equal with this checkout's root read as that one.
Slow specs stay unrun (test_cmds' run_slow=0), as in tests/test_harness.py;
a spec gated on a feature this machine lacks (needs=pil, needs=video, and
matplotlib for the plot specs, whose needs=pil does not name it) is
skipped here as test_cmds skips it. The list and its checks are the ones
chip_smoke.py's `cli` phase holds the card's run to (check_suite).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import pytest

ROOT = Path(__file__).resolve().parents[1]
CMDS = ROOT / "tests" / "cmds"
GOOD = ROOT / "tests" / "good_tr"
F32_MRD, BF16_MRD = 5e-4, 5e-3
# trained weights after a few bf16 mixed-precision steps: each step's bf16
# gradient roundings (held to the JAX package's at 2e-2 by
# tests/test_torch_train.py) carry into every later step's weights
TRAIN_BF16_MRD = 5e-2
# the checked-in suites, then the generated ones (test_all's order)
CHECKED_IN = ("base", "modes")
GENERATED = ("gen_test_compute_tests", "gen_ops_prof_tests")
NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _archive_root() -> str:
    """The checkout the archives were written in, as lmdb_parse's archived
    stdout names it in front of tests/data/. An archive that names a path
    under it (gen_ops_prof_spec's spec file, lmdb_parse's stdout) differs
    from a run in another checkout by that path alone."""
    text = (GOOD / "lmdb_parse" / "__stdout__.txt").read_text()
    return re.search(r"(/\S*?)/tests/data/", text).group(1)


ARCHIVE_ROOT = _archive_root()
# specs whose modes plot through matplotlib, which their needs=pil does not
# name: where matplotlib is missing they skip as a needs= feature does
MATPLOTLIB_SPECS = {"wis_plot_tiny", "roofline_plot_tiny", "op_eff_plot_tiny"}


# ---- value comparisons ----

def _num_close(a: str, b: str, tol: float) -> bool:
    x, y = float(a), float(b)
    last = max(_ulp(a), _ulp(b))  # one unit of the last printed digit
    return abs(x - y) <= max(tol * max(abs(x), abs(y)), last)


def _ulp(s: str) -> float:
    mant, _, exp = s.lower().partition("e")
    frac = mant.split(".")[1] if "." in mant else ""
    return 10.0 ** (-len(frac) + (int(exp) if exp else 0))


def text_by_value(got: str, want: str, tol: float) -> list[str]:
    """Line by line: the text between numbers equal, each number within
    tol (relative) or one unit of its last printed digit."""
    gl, wl = got.splitlines(), want.splitlines()
    if len(gl) != len(wl):
        return [f"{len(gl)} lines != {len(wl)}"]
    errs = []
    for i, (g, w) in enumerate(zip(gl, wl)):
        if NUM.split(g) != NUM.split(w):
            errs.append(f"line {i + 1} text: {g!r} != {w!r}")
            continue
        bad = [(a, b) for a, b in zip(NUM.findall(g), NUM.findall(w))
               if not _num_close(a, b, tol)]
        if bad:
            errs.append(f"line {i + 1}: {bad} beyond mrd {tol:g}")
    return errs


def digests_by_value(got: Path, want: Path, tol: float) -> list[str]:
    from boda_tpu_torch.testing.comp import read_digest_stream
    g, w = read_digest_stream(got), read_digest_stream(want)
    if sorted(g) != sorted(w):
        return [f"digest names {sorted(g)} != {sorted(w)}"]
    return [f"{n}: {msg}" for n in sorted(w)
            if (msg := g[n].comp(w[n], tol))]


def caffemodel_by_value(got: Path, want: Path, tol: float) -> list[str]:
    """Every blob of every layer: the same layers, blobs and shapes, and
    each blob within tol of the archive's, relative to the largest
    magnitude in the archive's blob."""
    import numpy as np
    from boda_tpu_torch.graph.caffe_io import extract_layer_blobs, \
        read_binary_net_param
    g, w = (extract_layer_blobs(read_binary_net_param(p))
            for p in (got, want))
    if list(g) != list(w):
        return [f"layers {list(g)} != {list(w)}"]
    errs = []
    for layer in w:
        if len(g[layer]) != len(w[layer]):
            errs.append(f"{layer}: {len(g[layer])} blobs != "
                        f"{len(w[layer])}")
            continue
        for i, (a, b) in enumerate(zip(g[layer], w[layer])):
            a, b = (np.asarray(x.v, np.float64) for x in (a, b))
            if a.shape != b.shape:
                errs.append(f"{layer}[{i}]: shape {a.shape} != {b.shape}")
                continue
            rd = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            if rd > tol:
                errs.append(f"{layer}[{i}]: rel diff {rd:.3g} beyond "
                            f"mrd {tol:g}")
    return errs


def topk_by_value(got: str, want: str, tol: float) -> list[str]:
    """cnet_predict's `#r: label (class c) p=v` lines: every p within tol;
    each class equal where its p stands above the last printed p (the
    classes tied with the cut at the printed precision may be any of the
    tie)."""
    pat = re.compile(r"^#(\d+): (\S+) \(class (\d+)\) p=(\S+)$")
    gm = [pat.match(ln) for ln in got.splitlines()]
    wm = [pat.match(ln) for ln in want.splitlines()]
    if len(gm) != len(wm) or not all(gm) or not all(wm):
        return [f"top-k lines differ in form: {got!r} vs {want!r}"]
    errs = []
    cut = wm[-1][4]
    for g, w in zip(gm, wm):
        if not _num_close(g[4], w[4], tol):
            errs.append(f"rank {w[1]}: p={g[4]} != {w[4]}")
        elif not _num_close(w[4], cut, tol) and g[3] != w[3]:
            errs.append(f"rank {w[1]}: class {g[3]} != {w[3]}")
    return errs


def files_by_value(out: Path, good: Path, tol: float,
                   rename: dict[str, str] | None = None,
                   text_cmp: Callable | None = None,
                   weights_tol: float | None = None) -> list[str]:
    """Every file of the archive against the output of the same name (an
    output named with the port's engine name stands for the archive's JAX
    name under `rename`): digest streams (.boda) by value, weights
    (.caffemodel) blob by blob at weights_tol (default tol), other text by
    value (text_cmp, default text_by_value) after the names in `rename`
    are put back."""
    rename = rename or {}
    errs = []
    want = sorted(p.relative_to(good) for p in good.rglob("*") if p.is_file())
    got = {p.relative_to(out) for p in out.rglob("*") if p.is_file()}
    mapped = set()
    for rel in want:
        src = Path(str(rel))
        for port_name, jax_name in rename.items():
            src = Path(str(src).replace(jax_name, port_name))
        mapped.add(src)
        if src not in got:
            errs.append(f"missing output {src} (archive {rel})")
            continue
        g, w = out / src, good / rel
        if rel.suffix == ".boda":
            errs += [f"{rel}: {e}" for e in digests_by_value(g, w, tol)]
            continue
        if rel.suffix == ".caffemodel":
            wt = tol if weights_tol is None else weights_tol
            errs += [f"{rel}: {e}" for e in caffemodel_by_value(g, w, wt)]
            continue
        gt = g.read_text()
        for port_name, jax_name in rename.items():
            gt = gt.replace(port_name, jax_name)
        errs += [f"{rel}: {e}"
                 for e in (text_cmp or text_by_value)(gt, w.read_text(), tol)]
    errs += [f"extra output {p}" for p in sorted(got - mapped)]
    return errs


@dataclass(frozen=True)
class Closed:
    cls: str       # a, b or c
    reason: str
    check: Callable[[Path, Path, str], list[str]]  # (out, good, fail text)


def exact(got: str, want: str, tol: float) -> list[str]:
    return [] if got == want else [f"{got!r} != {want!r}"]


def _by_value(tol: float, **kw):
    def check(out: Path, good: Path, fail: str) -> list[str]:
        return files_by_value(out, good, tol, **kw)
    return check


# the closed list: spec name -> its class, its reason, and how it is held
CLOSED: dict[str, Closed] = {
    "gen_compute_spec": Closed(
        "b", "the generated spec names the port's engines (engine=torch) "
             "where the archive names the JAX package's (engine=rtc)",
        _by_value(0.0, rename={"engine=torch": "engine=rtc"},
                  text_cmp=exact)),
    "comp_mini": Closed(
        "b", "test_compute_multi's default engines are ref and torch: "
             "digest-torch.boda and 'ref vs torch' where the archive has "
             "the JAX engine rtc's; the digests held by value at f32",
        _by_value(F32_MRD, rename={"torch": "rtc"})),
    "comp_mini_engines": Closed(
        "c", "mini's prob through the fused and per-call engines: avg/rms "
             "in the last bits (f32)",
        _by_value(F32_MRD)),
    "conv_pyra_predict_mini": Closed(
        "c", "the packed pyramid's feature planes: avg/rms in the last bits "
             "(f32)",
        _by_value(F32_MRD)),
    "cnet_predict_mini": Closed(
        "c", "ranks 2-3 are classes tied at p=0.00000: which of the tie "
             "comes first depends on the last bits of the f32 softmax",
        _by_value(F32_MRD, text_cmp=topk_by_value)),
    "cnet_train_lmdb_mini": Closed(
        "c", "cnet_train's default tune is the bf16 headline tune: the "
             "bf16 roundings of its gradients (held to the JAX package's "
             "at 2e-2 by tests/test_torch_train.py) move the losses of "
             "steps 2-3 by 6e-4 and 1e-3, and the trained weights by up to "
             "2.5e-2 of a blob's largest value (conv1, after a step-2 loss "
             "of 39520). The losses held at the bf16 mrd, the weights blob "
             "by blob at TRAIN_BF16_MRD; the spec's f32 twin is held to the "
             "JAX package's at the f32 mrd "
             "(test_train_spec_f32_twin_matches_jax)",
        _by_value(BF16_MRD, weights_tol=TRAIN_BF16_MRD)),
}


# ---- running a suite ----

def _spec_lines(suite: str) -> list[str]:
    return [ln.strip() for ln in (CMDS / f"{suite}.txt").read_text()
            .splitlines() if ln.strip() and not ln.strip().startswith("#")]


def spec_names(suite: str, run_slow: bool = False) -> list[tuple[str, str]]:
    """(name, needs) of the checked-in suite's specs, slow ones left out
    unless run_slow."""
    out = []
    for ln in _spec_lines(suite):
        name = re.search(r"test_name=([^,)]+)", ln)[1]
        if "slow=1" in ln and not run_slow:
            continue
        needs = re.search(r"needs=([^,)]+)", ln)
        out.append((name, needs[1] if needs else ""))
    return out


def start_all(out_root: Path, cpu: bool = True) -> subprocess.Popen:
    """Start every suite in one process, as a user does: `python -m
    boda_tpu_torch test_all` over the checked-in suites with the generated
    ones made and appended (run_gen=1), slow specs left out; each spec's
    outputs land in out_root/<name>, the generated suites in out_root."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    if cpu:
        env["BODA_TORCH_DEVICE"] = "cpu"
    fns = " ".join(str(CMDS / f"{s}.txt") for s in CHECKED_IN)
    return subprocess.Popen([sys.executable, "-m", "boda_tpu_torch",
                             "test_all", f"--cmds_fns={fns}",
                             f"--good_tr_dir={GOOD}", "--run_slow=0",
                             "--run_gen=1", f"--boda_output_dir={out_root}"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_all(proc: subprocess.Popen, timeout: float = 900) -> str:
    """Wait for start_all's process; returns its stdout (test_all itself
    fails: the listed specs fail their byte diff)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    n = len(re.findall(r"^test_cmds: \d+/\d+ passed", out, re.M))
    if n != len(CHECKED_IN + GENERATED):
        raise AssertionError(f"test_all reported {n} suites: "
                             f"{out[-2000:]}{err[-3000:]}")
    return out


def run_all(out_root: Path, cpu: bool = True) -> str:
    """start_all, then finish_all."""
    return finish_all(start_all(out_root, cpu))


def suite_names(suite: str, out_root: Path) -> set[str]:
    """Every spec name of a suite, slow ones included."""
    if suite in GENERATED:
        text = (out_root / f"{suite}.txt").read_text()
        return set(re.findall(r"test_name=([^,)]+)", text))
    return {n for n, _ in spec_names(suite, run_slow=True)}


def failures(stdout: str) -> dict[str, str]:
    """test_cmds' FAIL lines: spec name -> what failed."""
    out = {}
    for block in re.split(r"^FAIL ", stdout, flags=re.M)[1:]:
        name, _, rest = block.partition(": ")
        out[name] = rest
    return out


def located(name: str) -> bool:
    """Whether the spec's archive names a path of the archiving checkout."""
    return any(ARCHIVE_ROOT.encode() in f.read_bytes()
               for f in (GOOD / name).rglob("*") if f.is_file())


def relocated_diff(name: str, out_root: Path) -> list[str]:
    """A located spec run in another checkout: its files byte-equal to the
    archive's once this checkout's root reads the archiving one's."""
    out, good = out_root / name, GOOD / name
    want = sorted(p.relative_to(good) for p in good.rglob("*") if p.is_file())
    got = sorted(p.relative_to(out) for p in out.rglob("*") if p.is_file())
    if got != want:
        return [f"{name}: files {got} != {want}"]
    here = str(ROOT).encode()
    return [f"{name}: {f} differs beyond the checkout's path" for f in want
            if (out / f).read_bytes().replace(here, ARCHIVE_ROOT.encode())
            != (good / f).read_bytes()]


def excuse_located(fails: dict[str, str], out_root: Path) -> list[str]:
    """Outside the archiving checkout, drop from `fails` the located specs
    whose only difference is the checkout's path; return the errors of
    those that differ beyond it."""
    if str(ROOT) == ARCHIVE_ROOT:
        return []
    errs = []
    for name in [n for n in fails if n not in CLOSED and located(n)]:
        e = relocated_diff(name, out_root)
        if e:
            errs += e
        else:
            del fails[name]
    return errs


def check_closed(fails: dict[str, str], out_root: Path) -> list[str]:
    """The listed specs among a run's failures, each held by its check."""
    errs = []
    for name, fail in fails.items():
        c = CLOSED.get(name)
        if c is None:
            continue
        errs += [f"{name} ({c.cls}): {e}" for e in
                 c.check(out_root / name, GOOD / name, fail)]
    return errs


def feature_skips(suite: str) -> dict[str, str]:
    """The specs of a suite this machine cannot run, each with how test_cmds
    reports it: '' where test_cmds skips it (a needs= feature is missing),
    else the error it fails with (a plot spec without matplotlib)."""
    from boda_tpu_torch.core.features import is_feature_enabled
    if suite in GENERATED:
        return {}
    out = {}
    for name, needs in spec_names(suite):
        if needs and not all(is_feature_enabled(f) for f in needs.split(",")):
            out[name] = ""
        elif name in MATPLOTLIB_SPECS and not is_feature_enabled("matplotlib"):
            out[name] = "plot modes require matplotlib"
    return out


def check_suite(suite: str, stdout: str, out_root: Path) -> list[str]:
    """Everything a suite's run must show: the failed specs are exactly the
    closed list's specs of this suite (less those this machine cannot run,
    feature_skips, each failing, if at all, with its missing feature's
    error), and each listed spec holds under its check."""
    names = suite_names(suite, out_root)
    fails = {n: f for n, f in failures(stdout).items() if n in names}
    errs = excuse_located(fails, out_root)
    skips = feature_skips(suite)
    for name, err in skips.items():
        if err and err not in fails.pop(name, ""):
            errs.append(f"{name} should fail with '{err}' here")
    if suite in GENERATED:
        listed = set(CLOSED) & names
    else:
        listed = {n for n, _ in spec_names(suite) if n in CLOSED} - set(skips)
    errs += [f"{n} fails the byte diff but is not in the closed list: "
             f"{fails[n][:300]}" for n in sorted(set(fails) - listed)]
    errs += [f"{n} is in the closed list but passed: take it out"
             for n in sorted(listed - set(fails))]
    return errs + check_closed(fails, out_root)


# ---- the tests ----

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(test_all's stdout, its output root): one run for the module."""
    root = tmp_path_factory.mktemp("golden")
    return run_all(root), root


CASES = [(s, n, needs) for s in CHECKED_IN for n, needs in spec_names(s)]


@pytest.mark.parametrize("suite,name,needs", CASES,
                         ids=[f"{s}:{n}" for s, n, _ in CASES])
def test_spec_through_the_port(suite, name, needs, run):
    """One spec of a checked-in suite: it passes the byte diff against its
    archive, or it is in the closed list, fails the byte diff, and holds
    under its class's check."""
    if name in feature_skips(suite):
        pytest.skip(f"{name}: a feature this machine lacks")
    stdout, root = run
    fails = failures(stdout)
    assert excuse_located(fails, root) == []
    if name in CLOSED:
        assert name in fails, f"{name} passes now: take it out of CLOSED"
        assert check_closed({name: fails[name]}, root) == []
    else:
        assert name not in fails, fails.get(name, "")[:3000]


@pytest.mark.parametrize("suite", CHECKED_IN + GENERATED)
def test_suite_fails_only_the_closed_list(suite, run):
    """The whole suite: its failures are exactly its listed specs, and
    every listed spec holds under its check."""
    stdout, root = run
    assert check_suite(suite, stdout, root) == [], stdout[-3000:]


def test_the_closed_list_is_closed():
    """Each entry names a spec of the suites (checked-in or generated, with
    an archive), carries a class of (a)-(c) and a reason; class (a), the
    modes not yet ported, holds none: the two mh_test specs pass."""
    checked_in = {n for s in CHECKED_IN for n, _ in spec_names(s, True)}
    for name, c in CLOSED.items():
        assert name in checked_in or (GOOD / name).is_dir(), name
        assert c.cls in ("a", "b", "c") and c.reason, name
    assert {n for n, c in CLOSED.items() if c.cls == "a"} == set()
    assert not {"err_mh_bad_rank", "err_mh_spawn_real_dev"} & set(CLOSED)


def test_value_checks_catch_a_change(tmp_path):
    """The class (c) checks are not vacuous: a digest moved beyond its
    tolerance, a printed number beyond it and a top-1 class swapped each
    fail."""
    good = GOOD / "conv_pyra_predict_mini"
    out = tmp_path / "o"
    out.mkdir()
    (out / "__stdout__.txt").write_text(
        (good / "__stdout__.txt").read_text())
    planes = (good / "planes.boda").read_text()
    (out / "planes.boda").write_text(planes.replace(
        "avg=4.1600165457154317", "avg=4.6600165457154317"))
    assert any("avg mismatch" in e
               for e in files_by_value(out, good, F32_MRD))
    (out / "planes.boda").write_text(planes)
    assert files_by_value(out, good, F32_MRD) == []
    want = (GOOD / "cnet_train_lmdb_mini" / "__stdout__.txt").read_text()
    assert text_by_value(want.replace("3.07097", "3.09097"), want,
                         BF16_MRD)
    assert text_by_value(want.replace("3.07097", "3.07413"), want,
                         BF16_MRD) == []
    # a trained blob moved by a tenth, and a layer's update left out
    # (its weights put back to the net's initial ones), each fail
    from boda_tpu_torch.core.dims import NDA
    from boda_tpu_torch.graph.caffe_io import (
        copy_matching_layer_blobs_to_pipe, extract_layer_blobs,
        read_binary_net_param, write_caffemodel)
    from boda_tpu_torch.models.zoo import build_model
    trained = GOOD / "cnet_train_lmdb_mini" / "trained.caffemodel"
    init = build_model("mini", batch=4, ysz=32, xsz=32)
    pipe = build_model("mini", batch=4, ysz=32, xsz=32)
    assert copy_matching_layer_blobs_to_pipe(
        pipe, extract_layer_blobs(read_binary_net_param(trained)),
        strict=True) == []
    write_caffemodel(pipe, tmp_path / "same.caffemodel")
    assert caffemodel_by_value(tmp_path / "same.caffemodel", trained,
                               0.0) == []
    for key, change in (("fc-conv_biases", lambda v, v0: v * 1.1),
                        ("conv2_filts", lambda v, v0: v0)):
        keep = pipe.op_params[key]
        pipe.op_params[key] = NDA(keep.dims, change(
            keep.v, init.op_params[key].v))
        write_caffemodel(pipe, tmp_path / "changed.caffemodel")
        pipe.op_params[key] = keep
        errs = caffemodel_by_value(tmp_path / "changed.caffemodel", trained,
                                   TRAIN_BF16_MRD)
        layer, i = key.rsplit("_", 1)[0], int(key.endswith("biases"))
        assert len(errs) == 1 and errs[0].startswith(f"{layer}[{i}]:"), errs
    top = (GOOD / "cnet_predict_mini" / "__stdout__.txt").read_text()
    assert topk_by_value(top.replace("class_9 (class 9)", "class_6 (class 6)"),
                         top, F32_MRD) == []
    assert topk_by_value(top.replace("class_8 (class 8)", "class_6 (class 6)"),
                         top, F32_MRD)


def test_train_spec_f32_twin_matches_jax(tmp_path, monkeypatch, capsys):
    """cnet_train_lmdb_mini's spec under the f32 tune (op_tune=
    (use_culibs=1)) through both packages: every trained blob within the
    f32 mrd of the JAX package's, and the same printed losses within it."""
    import boda_tpu.modes  # noqa: F401
    from boda_tpu.core.has_main import create_and_run_has_main as jrun
    from boda_tpu_torch.core.has_main import create_and_run_has_main
    spec = next(ln for ln in _spec_lines("modes")
                if "test_name=cnet_train_lmdb_mini," in ln)
    cmd = spec[spec.index("cmd=(") + 4:-1]
    assert cmd.startswith("(mode=cnet_train,") and cmd.endswith(")")
    monkeypatch.setenv("BODA_TORCH_DEVICE", "cpu")
    outs = {}
    for pkg, run in (("jax", jrun), ("torch", create_and_run_has_main)):
        out = tmp_path / pkg
        run(f"{cmd[:-1]},op_tune=(use_culibs=1),boda_output_dir={out})")
        outs[pkg] = (out, capsys.readouterr().out)
    (pt, pt_out), (jx, jx_out) = outs["torch"], outs["jax"]
    assert caffemodel_by_value(pt / "trained.caffemodel",
                               jx / "trained.caffemodel", F32_MRD) == []
    assert text_by_value(pt_out, jx_out, F32_MRD) == []
    assert text_by_value((pt / "loss.txt").read_text(),
                         (jx / "loss.txt").read_text(), F32_MRD) == []
