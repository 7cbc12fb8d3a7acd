"""loop_idle_us: the cards' idle time under the program's ``mcq.round``
spans (the launches' betas and enqueues, the transposes, the reads, the
exchanges), summed over the cell's cards, over its ``mcq.launch`` spans."""

from benchmark import spans


def read(run):
    if not spans.searches(run):
        return None
    launches = spans.count(run.trace, (spans.LAUNCH,))
    if not launches:
        return None
    return sum(spans.idle_under(run.trace, run.cards,
                                (spans.ROUND,))) / launches
