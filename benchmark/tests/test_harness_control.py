"""The check's control: the reference itself in the program's place, with
the accept test in bfloat16 instead of the float32 the configuration
states, is found wrong; the float32 reference matches the program."""

import random

import pytest

from benchmark import check, searches
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["tiny_board.anneal", "tiny_3d.floors"])
def test_bfloat16_control_fails_the_replay(tmp_path, cell):
    from benchmark import run as run_mod

    root = tiny.checkout(tmp_path)
    _, c = run_mod.load_cell(root, cell)
    spec = c.spec()
    searcher = searches.Searcher(c, "cpu")
    for seed in (11, 2 ** 31 + 3, 987654321):
        base = searches.base_seed(seed, 0, spec.chains)
        result = searcher(base)
        chains = check.draw_chains(spec, random.Random(seed), 64)
        assert check.replay(spec, base, result, chains) == []
        control = check.replay(spec, base, result, chains,
                               precision="bfloat16")
        assert len(control) >= 1, (seed, chains)
