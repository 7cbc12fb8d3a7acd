"""drain_ms: from the end of a search's last sampler kernel on any card to
the return of the search call, the mean over searches: the host's reads
of the final carry, the history's concatenation and the result."""

from benchmark import trace


def read(run):
    tr = run.trace
    if tr is None:
        return None
    drains = []
    for lo, hi in tr.searches:
        ends = [iv[1] for c in run.cards
                for iv in trace.matching(
                    trace.within(tr.device.get(c, []), lo, hi),
                    run.sampler)]
        if ends:
            drains.append(hi - max(ends))
    if not drains:
        return None
    return sum(drains) / len(drains) * 1e-3
