"""mesh_idle_ms: the card's idle time under the program's ``mcq.mesh.*``
spans (each shard's enqueue, the gathers between cards), in ms a search,
the mean over the cell's cards."""

from benchmark import spans


def read(run):
    return spans.per_search_ms(run, (spans.MESH,))
