"""Re-verify exported best-board files with a brute-force oracle (PyTorch
port of ``python -m tools.verify_board``).

Reads ``best_heights_{N}_*.txt`` files (the competition CLI's ``i,j,k``
export: a board's N^2 columns or a full-3D state's Q queens) or Q_max
certificates, and recomputes each energy with a straight loop over the
textual attack relations of every queen pair.  The oracle is this module's
own and shares no code with :mod:`mcqueens_torch.core.energy`.  Prints one
JSON line per file:

    {"file": ..., "N": ..., "queens": ..., "mode": "board"|"full_3d",
     "distinct_cells": true, "oracle_energy": E}

    python -m mcqueens_torch.tools.verify_board FILE [FILE ...]

Pure Python on the host; a board file may lie anywhere (it is a board, not
a measurement).
"""

from __future__ import annotations

import json
import os
import re
import sys


def pair_attacks(p1, p2, board_mode=False) -> bool:
    """Whether two queens at cells ``p1``, ``p2`` attack: the 7 relations
    written out one by one (``board_mode`` drops same_ij, which a board's
    one-queen-a-column layout cannot have)."""
    (i1, j1, k1), (i2, j2, k2) = p1, p2
    di, dj, dk = abs(i1 - i2), abs(j1 - j2), abs(k1 - k2)
    rels = [
        i1 == i2 and k1 == k2,              # same_ik
        j1 == j2 and k1 == k2,              # same_jk
        k1 == k2 and di == dj,              # plane_k_diag
        j1 == j2 and di == dk,              # plane_j_diag
        i1 == i2 and dj == dk,              # plane_i_diag
        di == dj and dj == dk,              # space_diag
    ]
    if not board_mode:
        rels.append(i1 == i2 and j1 == j2)  # same_ij
    return any(rels)


def energy(queens) -> int:
    """Attacking pairs among ``queens`` ((i, j, k) rows), all 7 relations."""
    qs = [tuple(int(x) for x in q) for q in queens]
    return sum(pair_attacks(qs[a], qs[b])
               for a in range(len(qs)) for b in range(a + 1, len(qs)))


def read_queens(path) -> list[tuple[int, int, int]]:
    """The ``i,j,k`` rows of an exported board or certificate."""
    queens = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                i, j, k = (int(x) for x in line.split(","))
                queens.append((i, j, k))
    return queens


def verify(path: str) -> dict:
    queens = read_queens(path)
    m = re.search(r"best_heights_(\d+)_", os.path.basename(path))
    n = int(m.group(1)) if m else 1 + max(c for q in queens for c in q)
    # A file whose (i, j) columns are each used exactly once is a board
    # state; same_ij then cannot fire, so board and full_3d scoring agree.
    board_like = len({(i, j) for i, j, _ in queens}) == len(queens)
    return {
        "file": str(path),
        "N": n,
        "queens": len(queens),
        "mode": "board" if board_like else "full_3d",
        "distinct_cells": len(set(queens)) == len(queens),
        "oracle_energy": energy(queens),
    }


def main(argv=None) -> int:
    paths = argv if argv is not None else sys.argv[1:]
    if not paths:
        print(__doc__)
        return 2
    for path in paths:
        print(json.dumps(verify(path)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
