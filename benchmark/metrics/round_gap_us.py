"""round_gap_us: the card's idle time between a search's first and last
sampler kernel, over the sampler launches less one, summed over every
search and card: the host's time between launches (segment reads, the
state's transposes, exchanges) that the card waits out."""

from benchmark import trace


def read(run):
    tr = run.trace
    if tr is None:
        return None
    idle, gaps = 0.0, 0
    for lo, hi in tr.searches:
        for c in run.cards:
            ivs = trace.within(tr.device.get(c, []), lo, hi)
            ours = trace.matching(ivs, run.sampler)
            if len(ours) < 2:
                continue
            a, b = ours[0][0], max(iv[1] for iv in ours)
            idle += (b - a) - trace.union(ivs, a, b)
            gaps += len(ours) - 1
    if not gaps:
        return None
    return idle / gaps
