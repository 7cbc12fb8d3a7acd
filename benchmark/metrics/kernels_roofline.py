"""kernels_roofline: the least card time the window's sampler launches
need (the larger of their int32 operations and state bytes over the
card's peaks, ``work/<family>.py`` and ``peaks.py``), as a share
of the time any device operation ran in the traced window, both summed
over the cell's cards.  Init, exchange and copy kernels count against
it."""

from benchmark import trace


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = sum(trace.union(tr.device.get(c, []), *tr.window)
               for c in run.cards) * 1e-6
    if busy <= 0:
        return None
    return 100.0 * run.least_s / busy
