"""kern.forward_roofline (%, device trace): the forward's least time over
the card's busy time per request. The least time is benchmark/roofline.py's:
per conv and pool of the reference's shapes, the larger of its operations at
the peak of the precision the cell declares for it and its bytes at the HBM
rate. Nothing on a card without known peaks."""

from benchmark import roofline


def read(run):
    t = run.trace
    peaks = roofline.card_peaks(run.device_kind)
    if t is None or peaks is None or not t.device:
        return None
    least = roofline.least_seconds(run.net, run.cell.traffic["precision"],
                                   peaks, run.batch)
    return 100.0 * least / (t.busy_s() / t.n)
