"""The port's plot modes (tune/plots.py) on the CPU, as tests/test_plots.py
runs the JAX package's: each writes its PNG; roofline_plot's bound-only
points (arithmetic intensity and roof per op) and wis_plot's series print
the same text as the JAX modes; the roof defaults to the card's peaks
(core/machine), so without a card or without peaks for the device the mode
refuses. Rendering details are not golden-diffed."""

import contextlib
import io

import pytest

pytest.importorskip("matplotlib")

from boda_tpu.core.has_main import create_and_run_has_main as jrun  # noqa: E402
from boda_tpu_torch.backend.torch_be import TorchBackend  # noqa: E402
from boda_tpu_torch.core.error import RtErr  # noqa: E402
from boda_tpu_torch.core.has_main import create_and_run_has_main  # noqa: E402

OPS = "tests/data/ops"
CPU = "rtc=(be=torch,device=cpu)"


def _out(run, spec: str) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(spec)
    return buf.getvalue()


@pytest.mark.parametrize("tune", ["()", "(prec=bf16,layout=nhwc)"])
@pytest.mark.parametrize("ops", ["conv-tiny.txt", "resnet50-convs.txt"])
def test_roofline_bound_points_as_the_jax_mode(ops, tune, tmp_path):
    outs = []
    for name, run in (("port", create_and_run_has_main), ("jax", jrun)):
        d = tmp_path / name
        outs.append(_out(run, f"(mode=roofline_plot,ops_fn={OPS}/{ops},"
                              f"out_fn=roof.png,op_tune={tune},"
                              f"peak_flops=1e12,hbm_gbps=100,"
                              f"boda_output_dir={d})"))
        assert (d / "roof.png").stat().st_size > 1000
    assert outs[0] == outs[1]
    assert "knee AI=10.00 FLOP/B" in outs[0]
    assert len([ln for ln in outs[0].splitlines()
                if " bound=" in ln]) == len(open(f"{OPS}/{ops}").readlines())


@pytest.mark.parametrize("tune,knee", [("()", "20.00"),
                                       ("(prec=bf16)", "295.22"),
                                       ("(prec=int8)", "590.75")])
def test_roofline_roof_is_the_cards(tune, knee, tmp_path, monkeypatch):
    # the CPU backend, reporting an H100 SXM as its card: the roof is its
    # peak in the tune's precision over its HBM rate (3.35 TB/s)
    monkeypatch.setattr(TorchBackend, "device_kind",
                        lambda self: "NVIDIA H100 80GB HBM3")
    out = _out(create_and_run_has_main,
               f"(mode=roofline_plot,ops_fn={OPS}/conv-tiny.txt,"
               f"out_fn=roof.png,op_tune={tune},{CPU},"
               f"boda_output_dir={tmp_path})")
    assert f"(knee AI={knee} FLOP/B)" in out


def test_roofline_refuses_without_peaks(tmp_path):
    spec = (f"(mode=roofline_plot,ops_fn={OPS}/conv-tiny.txt,out_fn=r.png,"
            f"boda_output_dir={tmp_path}")
    with pytest.raises(RtErr, match="device 'cuda' requested but CUDA is "
                                    "not available"):
        create_and_run_has_main(spec + ")")
    with pytest.raises(RtErr, match="no peaks known for device 'cpu'"):
        create_and_run_has_main(spec + f",{CPU})")


def test_roofline_measured_points(tmp_path):
    out = _out(create_and_run_has_main,
               f"(mode=roofline_plot,ops_fn={OPS}/conv-tiny.txt,"
               f"out_fn=roof.png,run=1,run_iter=1,peak_flops=1e12,"
               f"hbm_gbps=100,{CPU},boda_output_dir={tmp_path})")
    assert out.count(" meas=") == 2 and "(measured)" not in out
    assert (tmp_path / "roof.png").stat().st_size > 1000


def test_wis_plot_as_the_jax_mode(tmp_path):
    outs = []
    for name, run in (("port", create_and_run_has_main), ("jax", jrun)):
        d = tmp_path / name
        outs.append(_out(run, f"(mode=wis_plot,"
                              f"wis_fn=tests/data/wisdom-resnet50-b32.wis,"
                              f"out_fn=wis.png,boda_output_dir={d})"))
        assert (d / "wis.png").stat().st_size > 1000
    assert outs[0] == outs[1] and "21 ops" in outs[0]


def test_op_eff_plot(tmp_path):
    out = _out(create_and_run_has_main,
               f"(mode=op_eff_plot,ops_fn={OPS}/conv-tiny.txt,out_fn=eff.png,"
               f"peak_flops=1e12,run_iter=1,{CPU},boda_output_dir={tmp_path})")
    assert "op_eff_plot: 2 ops -> eff.png" in out
    assert (tmp_path / "eff.png").stat().st_size > 1000
    with pytest.raises(RtErr, match="device 'cuda' requested"):
        create_and_run_has_main(f"(mode=op_eff_plot,ops_fn={OPS}/"
                                f"conv-tiny.txt,out_fn=e.png,"
                                f"boda_output_dir={tmp_path})")
