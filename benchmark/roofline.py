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

from .reference.graph import Layer, Net, conv_flops, groups, numel

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


def layer_least_seconds(net: Net, L: Layer, site: str, edges: str,
                        peaks: dict, batch: int) -> float:
    """The least time of one layer of one batch's forward: for a conv (the
    classifier is one), the larger of its operations over the peak of its
    declared precision `site` and its bytes over the HBM rate; for a pool,
    its bytes over the HBM rate; 0 for any other layer. Each input, filter
    and output is counted once: an activation at the edge precision `edges`
    (at the site's, where that is narrower), a filter (out, cin / groups,
    k, k) at the site's, a bias at 4 bytes. site is unused for a pool."""
    edge = BYTES[edges]
    if L.kind == "conv":
        a = min(edge, BYTES[site])
        cin = net.shapes[L.ins[0]][0] // groups(L)
        w = L.p["out"] * cin * L.p["k"] ** 2
        nbytes = batch * (numel(net.shapes[L.ins[0]]) * a
                          + numel(net.shapes[L.out]) * edge) \
            + w * BYTES[site] + L.p["out"] * 4
        return max(batch * conv_flops(net, L) / peaks[site],
                   nbytes / peaks["hbm"])
    if L.kind in ("maxpool", "avgpool_global"):
        nbytes = batch * edge * (numel(net.shapes[L.ins[0]])
                                 + numel(net.shapes[L.out]))
        return nbytes / peaks["hbm"]
    return 0.0


def least_seconds(net: Net, precision: dict, peaks: dict,
                  batch: int) -> float:
    """The least time of one batch's forward: `layer_least_seconds` of
    every layer at its site's declared precision, added one by one in
    layer order (not by `sum`, which compensates float rounding since
    Python 3.12 and so reads other digits)."""
    prec = site_precisions(net, precision)
    total = 0.0
    for L in net.layers:
        total += layer_least_seconds(net, L, prec.get(L.name),
                                     precision["edges"], peaks, batch)
    return total
