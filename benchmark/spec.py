"""What a run is made of, found by name: `BENCHMARK.json` at the root of the
checkout, and under `benchmark/` one file per configuration
(`configs/<config>.json`), traffic mix (`traffic/<traffic>.json`), cell
(`cells/<workload>.json`: the limits that decide `correct`) and metric
(`metrics/<metric>.py`, whose `read(run)` returns the value or None).

Adding a model, a mix, a cell or a metric adds files and entries; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
# the load the harness can offer, which a traffic file states: one client in a
# closed loop (an open loop or more clients is a new harness, not new data)
LOOPS = {"loop": "closed", "clients": 1}


class SpecError(ValueError):
    pass


def check_name(s: str, what: str) -> str:
    if not isinstance(s, str) or not NAME_RE.fullmatch(s):
        raise SpecError(f"{what} '{s}' is not a name (at most 64 of "
                        f"A-Z a-z 0-9 _ . -, not starting with . or -)")
    return s


def load_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"no {what} file {path}")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload with everything it names, loaded."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def metric_applies(m: dict, cell: str) -> bool:
    return "workloads" not in m or cell in m["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload `name` of root/BENCHMARK.json with its configuration,
    traffic, limits and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json", "benchmark")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SpecError(f"unknown workload '{name}' (have: "
                        f"{', '.join(sorted(work))})")
    w = work[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    centry = cfgs[check_name(w["config"], "config")]
    config = load_json(root / centry["file"], "configuration")
    if config.get("name") != centry["name"]:
        raise SpecError(f"{centry['file']} names '{config.get('name')}', "
                        f"not '{centry['name']}'")
    tname = check_name(w["traffic"], "traffic")
    traffic = load_json(HERE / "traffic" / f"{tname}.json", "traffic")
    for key, can in LOOPS.items():
        if traffic.get(key) != can:
            raise SpecError(f"traffic '{tname}' asks for {key} "
                            f"{traffic.get(key)!r}; the harness runs only "
                            f"{key} {can!r}")
    cname = check_name(name, "workload")
    limits = load_json(HERE / "cells" / f"{cname}.json", "cell")["limits"]
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if metric_applies(m, name)],
                [m for m in bench["per_layer"] if metric_applies(m, name)])


def metric_reader(name: str):
    """`read` of metrics/<name>.py."""
    fn = HERE / "metrics" / f"{check_name(name, 'metric')}.py"
    if not fn.is_file():
        raise SpecError(f"no reader {fn} for metric '{name}'")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + re.sub(r"\W", "_", name), fn)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
