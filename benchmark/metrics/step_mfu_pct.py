"""step_mfu_pct (%, host clock): the forward's operations at the peak of the
precision the cell declares at each site (benchmark/roofline.py), over the
window's wall time per request: the whole step's share of the card's peak.
Read in the traced run from its untraced window. Nothing on a card without
known peaks."""

from benchmark import roofline


def read(run):
    peaks = roofline.card_peaks(run.device_kind)
    if peaks is None or run.answered == 0 or run.trace is None:
        return None
    fs = roofline.flop_seconds(run.net, run.cell.traffic["precision"], peaks,
                               run.batch)
    return 100.0 * fs / (run.window_s / run.answered)
