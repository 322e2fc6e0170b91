"""kern.b8_roofline (%, device trace): the grouped convs' least time over
kernel B8's device time (`gconv_kernel`), per request. The least time is
benchmark/roofline.py's `layer_least_seconds` summed over the reference's
convs in more than one group, each at the precision the cell declares for it:
the same work whatever computes it. Nothing where the trace holds no B8
kernel or the card has no known peaks."""

from benchmark import roofline
from benchmark.reference.graph import groups
from benchmark.trace import kernel_kind


def grouped_least_seconds(net, precision: dict, peaks: dict,
                          batch: int) -> float:
    """The least time of one batch's grouped convs, added in layer order."""
    prec = roofline.site_precisions(net, precision)
    total = 0.0
    for L in net.convs():
        if groups(L) > 1:
            total += roofline.layer_least_seconds(
                net, L, prec[L.name], precision["edges"], peaks, batch)
    return total


def read(run):
    t = run.trace
    peaks = roofline.card_peaks(run.device_kind)
    if t is None or peaks is None:
        return None
    s = t.seconds(lambda n: kernel_kind(n).split("::")[-1] == "gconv_kernel")
    if s <= 0:
        return None
    least = grouped_least_seconds(run.net, run.cell.traffic["precision"],
                                  peaks, run.batch)
    return 100.0 * least / (s / t.n)
