"""The port's harness modes (testing/modes.py) against the JAX package's.

test_dense and test_upsamp run on `mini` (and test_dense on NiN, as
tests/test_harness.py does) through both packages on the CPU: the same
windows, boxes and compared regions, the same verdict, and an mrd within
the mode's tolerance on each side. The port repairs the upsampled
companion of a first conv with an odd pad (ROADMAP C7): on ResNet-50
(conv1 7x7/2, pad 3) the JAX package's test_upsamp fails (mrd 0.78 at
conv1) where the port's holds at the mode's 2e-4. test_cmds and test_all
keep the JAX modes' flow (golden diff, expected errors, gating,
update_failing into a scratch archive).
"""

from __future__ import annotations

import re

import pytest

import boda_tpu.modes  # noqa: F401  (register the JAX modes)
import boda_tpu_torch.modes  # noqa: F401  (register the port's)
from boda_tpu.core.error import RtErr as JRtErr
from boda_tpu.core.has_main import create_and_run_has_main as jrun
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.has_main import create_and_run_has_main as prun

MRD = re.compile(r"mrd=(\S+)")


@pytest.fixture(autouse=True)
def cpu_ask(monkeypatch):
    """The port's engines on the CPU: its modes name no device."""
    monkeypatch.setenv("BODA_TORCH_DEVICE", "cpu")


def _line(run, spec, capsys):
    run(spec, global_vars={})
    out = capsys.readouterr().out.strip().splitlines()
    return out[0], out[-1]


DENSE = {
    "mini_conv2": "(mode=test_dense,model=mini,out_node=conv2,"
                  "in_dims=(dims=(img=1,chan=3,y=48,x=48)))",
    "mini_conv1": "(mode=test_dense,model=mini,out_node=conv1,"
                  "in_dims=(dims=(img=1,chan=3,y=64,x=64)),win_sz=32)",
    "nin_conv2": "(mode=test_dense,model=nin_imagenet_nopad,batch=1,"
                 "in_dims=(dims=(img=1,chan=3,y=128,x=128)),out_node=conv2,"
                 "win_sz=64)",
}
UPSAMP = {
    "upsamp_mini_prob": "(mode=test_upsamp,model=mini,"
                        "in_dims=(dims=(img=1,y=64,x=64)))",
    "upsamp_mini_conv2": "(mode=test_upsamp,model=mini,out_node=conv2,"
                         "in_dims=(dims=(img=1,chan=3,y=64,x=64)))",
}


@pytest.mark.parametrize("name", sorted(DENSE) + sorted(UPSAMP))
def test_dense_and_upsamp_match_jax(name, capsys):
    spec = DENSE.get(name) or UPSAMP[name]
    j, jv = _line(jrun, spec, capsys)
    p, pv = _line(prun, spec, capsys)
    assert MRD.sub("", p) == MRD.sub("", j)  # windows, boxes, regions
    assert pv == jv and pv.endswith("PASSED")
    toler = 5e-5 if "test_dense" in spec else 2e-4
    assert float(MRD.search(p)[1]) <= toler


def test_dense_rejects_a_global_top_like_jax():
    spec = "(mode=test_dense,model=nin_imagenet_nopad,batch=1)"
    with pytest.raises(JRtErr, match="no valid finite support"):
        jrun(spec, global_vars={})
    with pytest.raises(RtErr, match="no valid finite support"):
        prun(spec, global_vars={})


def test_dense_runs_the_conv_fwd_tune(capsys):
    """The window runs through the same engine and tune as the whole
    image: under bf16 NHWC the two agree at the bf16 mrd."""
    prun("(mode=test_dense,model=mini,out_node=conv2,"
         "in_dims=(dims=(img=1,chan=3,y=48,x=48)),mrd_toler=5e-3,"
         "conv_fwd=(engine=torch,device=cpu,keep_all_nodes=1,"
         "op_tune=(prec=bf16,layout=nhwc)))", global_vars={})
    assert "test_dense PASSED" in capsys.readouterr().out


@pytest.mark.parametrize("node", ["conv1", "pool1", "res2a_branch2c"])
def test_upsamp_odd_pad_first_conv_repaired(node, capsys):
    """ROADMAP C7: ResNet-50's conv1 (7x7/2, pad 3). The JAX fold puts tap
    y into y>>1 and misses by half a pixel; the port's folds by the pad's
    parity and compares where the companion's one-wider border cannot
    reach."""
    spec = (f"(mode=test_upsamp,model=resnet-50,out_node={node},"
            f"in_dims=(dims=(img=1,chan=3,y=64,x=64)))")
    with pytest.raises(JRtErr, match="test_upsamp FAILED"):
        jrun(spec, global_vars={})
    capsys.readouterr()
    prun(spec, global_vars={})
    out = capsys.readouterr().out
    assert "test_upsamp PASSED" in out
    assert float(MRD.search(out)[1]) < 1e-5
    assert re.search(r"cmp=\(\d+,\d+\) from \(\d+,\d+\)", out)


def test_fold_filters_2x_by_pad_parity():
    """The folded first conv on an image equals the original conv on the
    image's nearest-neighbour 2x upsampling, for an even and an odd pad."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from boda_tpu_torch.models.upsamp import fold_filters_2x, upsample_2x_nn
    rng = np.random.RandomState(0)
    x = rng.randn(1, 3, 16, 16)
    w = rng.randn(4, 3, 7, 7)
    for pad in (2, 3):
        par = pad % 2
        ref = F.conv2d(torch.from_numpy(upsample_2x_nn(x)), torch.from_numpy(w),
                       stride=2, padding=pad)
        got = F.conv2d(torch.from_numpy(x),
                       torch.from_numpy(fold_filters_2x(w, par, par)),
                       stride=1, padding=(pad + 1) // 2)
        n = ref.shape[-1]
        np.testing.assert_allclose(got[..., :n, :n].numpy(), ref.numpy(),
                                   rtol=1e-10, atol=1e-10)


def _cmds(*lines):
    return "\n".join(lines) + "\n"


# specs over the port's own host modes (no helper mode is registered: the
# registry tests hold the port's modes to the JAX package's)
OK = "(test_name=ok,cap_out=1,cmd=(mode=test_velo_crc))"
BAD = "cmd=(mode=test_velo_crc,hex_crc=941122)"


def test_test_cmds_flow(tmp_path, capsys):
    """As tests/test_harness.py's flow: update_failing archives into a
    scratch tree (never tests/good_tr), expected errors match, needs= and
    slow= gate, and a changed output is a golden diff failure."""
    spec = tmp_path / "cmds.txt"
    good = tmp_path / "good_tr"
    spec.write_text(_cmds(
        OK,
        f"(test_name=expected_err,{BAD},err=must be exactly 2 bytes)",
        f"(test_name=err_text_changed,{BAD},err=some other error)",
        "(test_name=gated,needs=no_such_feature,cmd=(mode=test_velo_crc))",
        "(test_name=slow_one,slow=1,cmd=(mode=test_velo_crc))"))
    with pytest.raises(RtErr, match="1 test"):
        prun(f"(mode=test_cmds,cmds_fn={spec},good_tr_dir={good},"
             f"update_failing=1,boda_output_dir={tmp_path}/out)",
             global_vars={})
    out = capsys.readouterr().out
    assert "archived new known-good" in out
    assert "expected error 'some other error' but got" in out
    spec.write_text(_cmds(
        OK, "(test_name=gated,needs=no_such_feature,cmd=(mode=test_velo_crc))",
        "(test_name=slow_one,slow=1,cmd=(mode=test_velo_crc))"))
    prun(f"(mode=test_cmds,cmds_fn={spec},good_tr_dir={good},"
         f"boda_output_dir={tmp_path}/out)", global_vars={})
    assert "1/1 passed, 2 skipped, 0 failed" in capsys.readouterr().out
    spec.write_text(_cmds(
        "(test_name=ok,cap_out=1,cmd=(mode=blf_pack,in_sz=(y=64,x=48),"
        "bin_sz=(y=128,x=128)))"))
    with pytest.raises(RtErr):
        prun(f"(mode=test_cmds,cmds_fn={spec},good_tr_dir={good},"
             f"boda_output_dir={tmp_path}/out)", global_vars={})
    out = capsys.readouterr().out
    assert "DIFFERING output file" in out and "-test_velo_crc: calc" in out


def test_test_all_runs_suites_and_generators(tmp_path, capsys):
    good = tmp_path / "good_tr"
    spec = tmp_path / "s.txt"
    spec.write_text(_cmds(OK))
    prun(f"(mode=test_cmds,cmds_fn={spec},good_tr_dir={good},"
         f"update_failing=1,boda_output_dir={tmp_path}/a)", global_vars={})
    capsys.readouterr()
    prun(f"(mode=test_all,cmds_fns={spec},good_tr_dir={good},run_gen=0,"
         f"boda_output_dir={tmp_path}/b)", global_vars={})
    assert "test_all PASSED" in capsys.readouterr().out


@pytest.mark.parametrize("gen", ["gen_test_compute_tests",
                                 "gen_ops_prof_tests"])
def test_generators_name_the_port_engines(gen, tmp_path, capsys):
    """The generated suites are the JAX generators' with the port's engine
    names: text-equal after engine=torch reads engine=rtc."""
    jrun(f"(mode={gen},boda_output_dir={tmp_path}/j)")
    prun(f"(mode={gen},boda_output_dir={tmp_path}/p)")
    j = (tmp_path / "j" / f"{gen}.txt").read_text()
    p = (tmp_path / "p" / f"{gen}.txt").read_text()
    assert "engine=rtc" not in p
    assert p.replace("engine=torch", "engine=rtc") == j
