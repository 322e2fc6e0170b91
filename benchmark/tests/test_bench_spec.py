"""BENCHMARK.json and the files it names: each configuration, traffic mix,
cell and metric loads by its name, and every name, unit and line keeps to
the contract's characters and lengths."""

import json
import re

import pytest

from benchmark import spec
from benchmark.run import Run

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"[^\t\n\r]{1,200}")


def names(kind):
    return [e["name"] for e in BENCH[kind]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert all(LINE.fullmatch(w) for w in BENCH["command"])
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_allowed(kind):
    ns = names(kind)
    assert len(ns) == len(set(ns))
    for n in ns:
        spec.check_name(n, kind)


def test_units_better_sources():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT_RE.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    assert "setup_s" in names("end_to_end")


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = set(names("workloads"))
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.fullmatch(m["layer"])
        for w in m.get("workloads", cells):
            assert w in cells
            assert spec.metric_applies(e2e[m["moves"]], w)


@pytest.mark.parametrize("w", names("workloads"))
def test_cells_load_by_name(w):
    c = spec.load_cell(w)
    entry = next(e for e in BENCH["workloads"] if e["name"] == w)
    assert LINE.fullmatch(entry["why"]) and entry["chips"] == 1
    spec.check_name(entry["traffic"], "traffic")
    assert c.config["name"] == entry["config"]
    assert set(c.limits) == {"logit_err", "mean_logit_err"}
    assert all(v > 0 for v in c.limits.values())
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_config_entries():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert used == set(names("configs")) and len(pairs) == len(set(pairs))
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"] and LINE.fullmatch(c["why"])


@pytest.mark.parametrize("m", names("end_to_end") + names("per_layer"))
def test_metric_readers_load_and_read_nothing_from_an_empty_run(m):
    read = spec.metric_reader(m)
    c = spec.load_cell(names("workloads")[0])
    v = read(Run(c, None, 128, "cpu"))
    assert v is None or m == "setup_s"


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.check_name("has space", "metric")
    with pytest.raises(spec.SpecError):
        spec.metric_reader("no.such.metric")


@pytest.mark.parametrize("key,value", [("loop", "open"), ("clients", 4)])
def test_a_load_the_harness_cannot_offer_is_refused(monkeypatch, key, value):
    real = spec.load_json

    def load_json(path, what):
        d = real(path, what)
        return dict(d, **{key: value}) if what == "traffic" else d
    monkeypatch.setattr(spec, "load_json", load_json)
    with pytest.raises(spec.SpecError, match=key):
        spec.load_cell(names("workloads")[0])


def test_every_reader_has_a_metric():
    """Each reader in benchmark/metrics/ reads a metric BENCHMARK.json
    names: a retired metric takes its reader with it."""
    readers = {f.stem for f in (spec.ROOT / "benchmark" / "metrics")
               .glob("*.py")}
    assert readers == set(names("end_to_end") + names("per_layer"))
