"""drain_idle_ms: the card's idle time under the program's ``mcq.drain``
spans (the wait for every card, the result's reads and assembly), in ms a
search, the mean over the cell's cards."""

from benchmark import spans


def read(run):
    return spans.per_search_ms(run, (spans.DRAIN,))
