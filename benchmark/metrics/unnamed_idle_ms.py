"""unnamed_idle_ms: the card's idle time in the window under none of the
program's ``mcq.init``, ``mcq.round`` and ``mcq.drain`` spans (a search
span's own time, the time between searches), in ms a search, the mean over
the cell's cards."""

from benchmark import spans


def read(run):
    n = spans.searches(run)
    if not n:
        return None
    tr, cards = run.trace, run.cards
    named = spans.idle_under(tr, cards, (spans.INIT, spans.ROUND, spans.DRAIN))
    rest = [a - b for a, b in zip(spans.idle(tr, cards), named)]
    return sum(rest) / len(rest) / n * 1e-3
