"""The yardstick's arithmetic: the card's peaks, each site's declared
precision, and a forward's operations, bytes and least time, all from the
reference's layer shapes.

The peaks are NVIDIA's data-sheet rates, dense, at the part's full power
limit (a copy of the port's `core/machine.py` table): a share of them is stated
with the card's power limit beside it. A card this table does not know has no
peaks, and a metric that needs them reports nothing.

A site's precision is what the cell declares, not what a kernel runs inside:
every conv at the traffic's `default` precision, the convs whose names match
an `int8_sites` pattern in int8. Activations cross each edge at `edges`.
"""

from __future__ import annotations

import re

from .reference.graph import Net, conv_flops, numel

PEAKS = {
    # part: (f32 FFMA, bf16, int8, HBM bytes/s)
    "H100 SXM5": {"f32": 67e12, "bf16": 989e12, "int8": 1979e12,
                  "hbm": 3.35e12},
    "H100 PCIe": {"f32": 51e12, "bf16": 756e12, "int8": 1513e12,
                  "hbm": 2.0e12},
}
BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def card_peaks(device_kind: str):
    """The peaks of the card named device_kind (torch.cuda.get_device_name),
    or None for a card not in the table."""
    if "H100" in device_kind:
        if "PCIe" in device_kind:
            return PEAKS["H100 PCIe"]
        if "HBM3" in device_kind or "SXM" in device_kind:
            return PEAKS["H100 SXM5"]
    return None


def site_precisions(net: Net, precision: dict) -> dict:
    """{conv name: declared precision}."""
    rxs = [re.compile(p) for p in precision.get("int8_sites", [])]
    return {L.name: "int8" if any(r.fullmatch(L.name) for r in rxs)
            else precision["default"] for L in net.convs()}


def flop_seconds(net: Net, precision: dict, peaks: dict,
                 batch: int) -> float:
    """Seconds the convs' operations of one batch take at the peak of each
    site's declared precision."""
    prec = site_precisions(net, precision)
    return batch * sum(conv_flops(net, L) / peaks[prec[L.name]]
                       for L in net.convs())


def least_seconds(net: Net, precision: dict, peaks: dict,
                  batch: int) -> float:
    """The least time of one batch's forward: per conv (the classifier is
    one) and per pool, the larger of its operations over the peak of its
    declared precision and its bytes over the HBM rate, summed. Each
    input, filter and output is counted once: an activation at the edge
    precision (at the site's, where that is narrower), a filter at the
    site's, a bias at 4 bytes."""
    prec = site_precisions(net, precision)
    edge = BYTES[precision["edges"]]
    total = 0.0
    for L in net.layers:
        if L.kind == "conv":
            p = prec[L.name]
            a = min(edge, BYTES[p])
            cin = net.shapes[L.ins[0]][0]
            w = L.p["out"] * cin * L.p["k"] ** 2
            nbytes = batch * (numel(net.shapes[L.ins[0]]) * a
                              + numel(net.shapes[L.out]) * edge) \
                + w * BYTES[p] + L.p["out"] * 4
            total += max(batch * conv_flops(net, L) / peaks[p],
                         nbytes / peaks["hbm"])
        elif L.kind in ("maxpool", "avgpool_global"):
            nbytes = batch * edge * (numel(net.shapes[L.ins[0]])
                                     + numel(net.shapes[L.out]))
            total += nbytes / peaks["hbm"]
    return total
