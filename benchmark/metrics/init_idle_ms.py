"""init_idle_ms: the card's idle time under the program's ``mcq.init``
spans (the carry's build, the first energies' read, the shards' copies),
in ms a search, the mean over the cell's cards."""

from benchmark import spans


def read(run):
    return spans.per_search_ms(run, (spans.INIT,))
