"""The cards' idle time under the program's own spans, in a traced run.

The program records its layers as host events of its main thread, on the
profiler's clock (``mcqueens_torch.utils.profiling.span``): ``mcq.search``
around each search call, ``mcq.init``, ``mcq.round`` and ``mcq.drain``
one after another inside it, and below them ``mcq.launch``, ``mcq.read``,
``mcq.mesh.shard``, ``mcq.mesh.gather`` and others.  A card is idle where
none of its device operations runs (:func:`benchmark.trace.gaps`).  This
module measures the part of each card's idle stretches in the window that
lies under a set of those spans.  A program without spans has no
``mcq.search`` span, and then :func:`searches` is 0 and every reader of
these metrics returns None.
"""

from __future__ import annotations

from benchmark import trace

SEARCH, INIT, ROUND, DRAIN = "mcq.search", "mcq.init", "mcq.round", "mcq.drain"
LAUNCH, MESH = "mcq.launch", "mcq.mesh."


def _matches(name: str, names) -> bool:
    """``name`` is one of ``names``; a name ending in ``.`` matches every
    span below it (``mcq.mesh.`` matches ``mcq.mesh.shard``)."""
    return any(name == n or (n.endswith(".") and name.startswith(n))
               for n in names)


def spans(tr, names):
    """The (start, end) of the main thread's spans named by ``names`` that
    start in the window, in order."""
    lo, hi = tr.window
    return [(s, e) for s, e, name in tr.host
            if lo <= s < hi and _matches(name, names)]


def count(tr, names) -> int:
    """How many spans named by ``names`` start in the window."""
    return len(spans(tr, names))


def _merged(intervals, lo: float, hi: float):
    """Sorted disjoint [start, end] covering ``intervals`` clipped to
    [lo, hi] (spans nest, so they may overlap)."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """Microseconds in which two sorted lists of disjoint intervals
    overlap."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(tr, cards):
    """Microseconds each card of ``cards`` is idle in the window."""
    lo, hi = tr.window
    return [sum(e - s for s, e in trace.gaps(tr.device.get(c, []), lo, hi))
            for c in cards]


def idle_under(tr, cards, names):
    """Microseconds of each card's idle time in the window that lie under
    a span named by ``names``."""
    lo, hi = tr.window
    under = _merged(spans(tr, names), lo, hi)
    return [_overlap(trace.gaps(tr.device.get(c, []), lo, hi), under)
            for c in cards]


def searches(run) -> int:
    """The ``mcq.search`` spans of a traced run with device events: 0
    without a trace, without device events or without spans."""
    tr = run.trace
    if tr is None or not tr.device:
        return 0
    return count(tr, (SEARCH,))


def per_search_ms(run, names):
    """Card idle time under ``names`` in ms a search, the mean over the
    run's cards; None where :func:`searches` is 0 or no such span ran."""
    n = searches(run)
    if not n or not count(run.trace, names):
        return None
    under = idle_under(run.trace, run.cards, names)
    return sum(under) / len(under) / n * 1e-3
