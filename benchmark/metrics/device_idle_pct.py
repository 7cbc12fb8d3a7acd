"""device_idle_pct: the share of the traced window in which no device
operation ran on a card, the mean over the cell's cards."""

from benchmark import trace


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    lo, hi = tr.window
    idle = [1.0 - trace.union(tr.device.get(c, []), lo, hi) / (hi - lo)
            for c in run.cards]
    return 100.0 * sum(idle) / len(idle)
