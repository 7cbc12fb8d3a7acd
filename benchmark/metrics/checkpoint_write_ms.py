"""checkpoint_write_ms: the host's time under the program's
``mcq.checkpoint.write`` spans (each file a save writes: a history chunk
or the main npz), in ms a search.  A program without the span reads
nothing."""

from benchmark import spans

WRITE = "mcq.checkpoint.write"


def read(run):
    n = spans.searches(run)
    writes = spans.spans(run.trace, (WRITE,)) if n else []
    if not writes:
        return None
    return sum(e - s for s, e in writes) / n * 1e-3
