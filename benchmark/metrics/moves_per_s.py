"""moves_per_s: proposed moves of every search the window ran (chains x
steps, from the configuration), over the window's time on the host clock,
from the first call to the last return, all of the cell's cards together."""


def read(run):
    return run.proposals / run.window_s
