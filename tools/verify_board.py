#!/usr/bin/env python
"""Re-verify exported best-board files with the independent brute-force oracle.

Reads one or more ``best_heights_{N}_*.txt`` files (the competition CLI's
``i,j,k`` export format, ``/root/reference/competition.py:181-187``; covers
both the board and full_3d variants) and recomputes each board's energy with
the test suite's straight-loop NumPy oracle (``tests/_oracle.py`` — shares no
code with the framework).  Prints one JSON line per file:

    {"file": ..., "N": ..., "queens": ..., "mode": "board"|"full_3d",
     "distinct_cells": true, "oracle_energy": E}

Usage:  python -m tools.verify_board artifacts/competition_results/*.txt

Pure CPU/NumPy — safe to run while a device job is active.
"""

from __future__ import annotations

import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests._oracle import pair_attacks  # noqa: E402


def verify(path: str) -> dict:
    queens = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                i, j, k = (int(x) for x in line.split(","))
                queens.append((i, j, k))
    m = re.search(r"best_heights_(\d+)_", os.path.basename(path))
    n = int(m.group(1)) if m else 1 + max(c for q in queens for c in q)

    distinct_cells = len(set(queens)) == len(queens)
    # A file whose (i, j) columns are each used exactly once is a board
    # state; same_ij then cannot fire, so board/full_3d scoring agree.
    board_like = len({(i, j) for i, j, _ in queens}) == len(queens)
    e = 0
    for a in range(len(queens)):
        qa = queens[a]
        for b in range(a + 1, len(queens)):
            if pair_attacks(qa, queens[b], board_mode=False):
                e += 1
    return {
        "file": path,
        "N": n,
        "queens": len(queens),
        "mode": "board" if board_like else "full_3d",
        "distinct_cells": distinct_cells,
        "oracle_energy": e,
    }


def main(argv=None) -> int:
    paths = (argv if argv is not None else sys.argv[1:])
    if not paths:
        print(__doc__)
        return 2
    for path in paths:
        print(json.dumps(verify(path)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
