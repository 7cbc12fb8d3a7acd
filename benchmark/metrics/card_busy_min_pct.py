"""card_busy_min_pct: the busy share of the traced window of the least
busy of the cell's cards (a cell of several cards only)."""

from benchmark import trace


def read(run):
    tr = run.trace
    if tr is None or len(run.cards) < 2 or not tr.device:
        return None
    lo, hi = tr.window
    return 100.0 * min(trace.union(tr.device.get(c, []), lo, hi)
                       for c in run.cards) / (hi - lo)
