"""The configuration resnext101_64x4d and kernel B8's three metrics: the
plain reference against the zoo builder's blobs and the paper's count; the
least time kern.b8_roofline divides, which sums the 33 grouped 3x3s alone;
and the readers on synthetic traces and spans (kern.b8_ms sums B8's kernel
by name, tmpl.b8_step_share reads the route of the grouped conv steps), each
finding nothing where the program has no B8 (the parent of the change that
added them) or, for the share, without a device trace."""

import json
import sys
import types

import pytest

from benchmark import roofline, spans, spec
from benchmark.reference import net_of
from benchmark.reference.graph import total_flops
from benchmark.run import Run
from benchmark.trace import Trace

CELL = "resnext101-bf16-b128"
H100 = roofline.card_peaks("NVIDIA H100 80GB HBM3")
B8 = "void (anonymous namespace)::gconv_kernel<16>(__nv_bfloat16 const*)"
B7 = "void (anonymous namespace)::bconv_kernel<128, 1>(__nv_bfloat16 const*)"
CUDNN = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"


def _cfg():
    return json.loads((spec.ROOT / "benchmark" / "configs" /
                       "resnext101_64x4d.json").read_text())


def test_the_cell_loads_its_configuration_and_metrics():
    c = spec.load_cell(CELL)
    assert c.config["name"] == "resnext101_64x4d"
    assert c.config["zoo_builder"] == "resnext-101-64x4d"
    assert c.traffic["batch"] == 128 and c.limits == {"logit_err": 0.42,
                                                       "mean_logit_err": 0.1}
    names = {m["name"] for m in c.per_layer}
    assert {"kern.b8_ms", "kern.b8_roofline", "tmpl.b8_step_share",
            "kern.b7_ms", "kern.forward_roofline"} <= names
    assert "kern.b6_ms" not in names


def test_the_reference_names_the_zoo_builders_blobs():
    """The check Program.__init__ makes, at the configuration's own size:
    the zoo's net and the reference agree on every weight's name and
    shape."""
    from boda_tpu_torch.models.zoo import build_model
    cfg = _cfg()
    _c, h, w = cfg["input_chw"]
    pipe = build_model(cfg["zoo_builder"], batch=1, ysz=h, xsz=w,
                       num_classes=cfg["num_classes"])
    have = {n: tuple(v.dims.shape) for n, v in pipe.op_params.items()}
    want = {n: tuple(s) for n, s, _f in net_of(cfg).weight_shapes()}
    assert have == want and len(want) == 210


def test_the_reference_is_the_papers_count():
    net = net_of(_cfg())
    assert total_flops(net) == 30920540160
    assert net.shapes["res5c"] == (2048, 7, 7)
    grouped = [L for L in net.convs() if L.p.get("groups", 1) > 1]
    assert len(grouped) == 33 and all(L.p["groups"] == 64 for L in grouped)
    assert [L.name for L in grouped if L.p["stride"] == 2] == \
        ["res3a_branch2b", "res4a_branch2b", "res5a_branch2b"]


def _roofline_module():
    return spec.metric_reader("kern.b8_roofline").__globals__


def test_b8_roofline_least_time_sums_the_grouped_layers_alone():
    net = net_of(_cfg())
    prec = spec.load_cell(CELL).traffic["precision"]
    least = _roofline_module()["grouped_least_seconds"](net, prec, H100, 128)
    assert least == pytest.approx(1.5293e-3, rel=1e-4)
    assert least < roofline.least_seconds(net, prec, H100, 128) / 3
    # ResNet-50 has no grouped conv: nothing to divide
    r50 = net_of(spec.load_cell("resnet50-bf16-b128").config)
    assert _roofline_module()["grouped_least_seconds"](
        r50, prec, H100, 128) == 0.0


def _trace(n, kernels):
    t = Trace(n, 1.0)
    t.device = [(0.01 * i, 0.01 * i + d, "kernel", name)
                for i, (name, d) in enumerate(kernels)]
    return t


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_b8_ms_and_roofline_read_b8s_kernel_per_request():
    t = _trace(2, [(B8, 0.003), (B7, 0.004), (CUDNN, 0.002), (B8, 0.004)])
    run = types.SimpleNamespace(trace=t, device_kind="NVIDIA H100 80GB HBM3",
                                net=net_of(_cfg()), batch=128,
                                cell=spec.load_cell(CELL))
    assert _read("kern.b8_ms", run) == pytest.approx(1e3 * 0.007 / 2)
    assert _read("kern.b8_roofline", run) == pytest.approx(
        100.0 * 1.5293e-3 / 0.0035, rel=1e-4)
    run.device_kind = "Some Other GPU"
    assert _read("kern.b8_roofline", run) is None


@pytest.mark.parametrize("name", ["kern.b8_ms", "kern.b8_roofline",
                                  "tmpl.b8_step_share"])
def test_b8_readers_find_nothing_without_b8(name):
    cell = spec.load_cell(CELL)
    run = types.SimpleNamespace(trace=_trace(3, [(B7, 0.002), (CUDNN, 0.004)]),
                                device_kind="NVIDIA H100 80GB HBM3",
                                net=net_of(_cfg()), batch=128, cell=cell)
    assert _read(name, run) is None
    assert _read(name, Run(cell, None, 128, "cpu")) is None


def _spans_module(requests):
    """The timers module's stand-in: one request span per entry of
    `requests`, each holding a `fwd.step` span per (route, groups)."""
    log, t0 = [], 1_000_000_000
    for steps in requests:
        root = len(log)
        log.append(("run_fwd", t0, t0 + 1000, root, root, None))
        for i, (r, g) in enumerate(steps):
            attrs = {"call_tag": f"s{i}", "func_name": "xla_conv"}
            if r is not None:
                attrs["route"] = r
            if g > 1:
                attrs["groups"] = g
            log.append(("fwd.step", t0 + i, t0 + i + 1, root, root, attrs))
        t0 += 10_000
    return types.SimpleNamespace(
        global_timer_log=types.SimpleNamespace(spans=log))


@pytest.mark.parametrize("requests,want", [
    ([[("b7", 1)] * 71 + [("b8", 64)] * 33] * 3, 100.0),
    ([[("b8", 64), ("vendor", 64), ("b7", 1), ("vendor", 1)]], 50.0),
    ([[("vendor", 64)] * 4], 0.0)])
def test_b8_step_share_reads_the_grouped_steps(monkeypatch, requests, want):
    monkeypatch.setitem(sys.modules, spans.TIMERS_MODULE,
                        _spans_module(requests))
    run = types.SimpleNamespace(trace=_trace(len(requests), [(B8, 0.001)]))
    assert _read("tmpl.b8_step_share", run) == pytest.approx(want)
    run.trace.device = []   # a CPU run: the route ran the plain version
    assert _read("tmpl.b8_step_share", run) is None


def test_b8_step_share_finds_nothing_without_groups(monkeypatch):
    # the parent's spans carry routes but no groups
    monkeypatch.setitem(sys.modules, spans.TIMERS_MODULE,
                        _spans_module([[("b7", 1)] * 5] * 2))
    run = types.SimpleNamespace(trace=_trace(2, [(B7, 0.001)]))
    assert _read("tmpl.b8_step_share", run) is None
