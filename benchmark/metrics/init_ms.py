"""init_ms: from the start of a search call (the harness's span) to the
start of its first sampler kernel on any card, the mean over searches:
initial states and energies, carries, the shards' copies."""

from benchmark import trace


def read(run):
    tr = run.trace
    if tr is None:
        return None
    firsts = []
    for lo, hi in tr.searches:
        starts = [iv[0] for c in run.cards
                  for iv in trace.matching(
                      trace.within(tr.device.get(c, []), lo, hi),
                      run.sampler)]
        if starts:
            firsts.append(min(starts) - lo)
    if not firsts:
        return None
    return sum(firsts) / len(firsts) * 1e-3
