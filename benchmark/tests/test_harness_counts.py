"""The frozen work counts agree with the operation counts the port's
kernel table gives for the same shapes."""

import json
import math

from benchmark import peaks
from benchmark.searches import load_module
from benchmark.tests import tiny


def _work(family):
    return load_module(tiny.BENCH / "work" / f"{family}.py")


def _config(name):
    return json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())


def test_board_count():
    ops, _ = _work("board_shared").launch(_config("board_n16"), 4096, 2048)
    assert math.isclose(ops, 5.2387e9, rel_tol=1e-4)


def test_full3d_count_at_hold_8():
    work = _work("full3d_shared")
    assert work.HOLD == 8
    ops, _ = work.launch(_config("full3d_n15q225"), 65536, 44)
    assert math.isclose(ops, 1.6220e10, rel_tol=1e-4)


def test_peaks():
    assert math.isclose(peaks.INT32_OPS_PER_S, 3.3454e13, rel_tol=1e-4)
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    # A full-3D floors launch is bound by its operations: 681.8 ms.
    t = peaks.least_seconds(*_work("full3d_shared").launch(
        _config("full3d_n15q225"), 65536, 62500))
    assert math.isclose(t, 0.6818, rel_tol=1e-3)


def test_count_follows_the_configuration():
    # A configuration of a known family needs only its JSON: its own N and
    # Q size the count.
    board = _work("board_shared")
    ops6, _ = board.launch({"N": 6}, 4096, 128)
    assert math.isclose(ops6, 4096 * 128 * (12 * board.line_cells(6) + 32))
    assert ops6 < board.launch({"N": 16}, 4096, 128)[0]
    full3d = _work("full3d_shared")
    assert full3d.launch({"N": 5, "Q": 20}, 4096, 1000)[0] == (
        4096 * (1000 + 125) * 20 * full3d.OPS_PER_PAIR)
