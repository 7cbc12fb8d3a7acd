"""checkpoint_idle_ms: the card's idle time under the program's
``mcq.checkpoint`` spans (a save: the carry's gather to the host and its
files), in ms a search, the mean over the cell's cards."""

from benchmark import spans

CHECKPOINT = "mcq.checkpoint"


def read(run):
    return spans.per_search_ms(run, (CHECKPOINT,))
