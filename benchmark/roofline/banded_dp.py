"""The banded DP's operations and bytes, as the algorithm needs them.

The forward pass fills, for every valid candidate, a band of ``w_b``
cells on each row of its query span; the number of cells is the port's
``MappingMetrics`` counter ``cells``, the query span times the band of
every valid candidate.  These counts are the same whatever implements
the DP: a dense rerun, a padded row or a cell word that a kernel stores
for its traceback counts nothing.

Operations per cell, the plain recurrence's arithmetic (additions and
minima, float32) in each mode:

* distance (three states, linear gap costs)::

      M = sub + min(M', I', D')         2 minima, 1 addition
      I = min(M^ + open, I^ + ext)      2 additions, 1 minimum
      D = min(B< + open, D< + ext)      2 additions, 1 minimum
      B = min(M, I)                     1 minimum

  10 operations (' the diagonal, ^ the vertical, < the horizontal
  neighbour);
* qv (``--useQuality``): the same ten, the costs read from the read's
  QV tracks and the tags instead of constants;
* hp (``--affineAlign``): the distance ten, a fourth state
  ``H = min(M^ + hp_open, H^ + hp_ext)`` (3) that joins M's minimum (1)
  and B's (1): 15.

Bytes: each read base in (1 byte) and each target base of its window in
(1 byte; the band spans about as many target bases as query rows), the
path out at one 2-bit step per row and per column crossed (at most two
steps a row: 0.5 byte a row), and in qv mode the two packed 32-bit QV
words of every read base (8 bytes).  A query row of a candidate is
``cells / w_b``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

OPS_PER_CELL = {"distance": 10, "qv": 10, "hp": 15}
# bytes per query row of a candidate: read base, window base, path
BYTES_PER_ROW = {"distance": 2.5, "qv": 10.5, "hp": 2.5}

PEAKS = json.loads((Path(__file__).resolve().parent.parent
                    / "peaks.json").read_text())


def ops(cells: int, mode: str) -> float:
    return float(cells) * OPS_PER_CELL[mode]


def nbytes(cells: int, mode: str, w_b: int = 128) -> float:
    return float(cells) / w_b * BYTES_PER_ROW[mode]


def peaks(device_name: str) -> Optional[dict]:
    """The published peaks of the card of this name (``peaks.json``), or
    None for a card the table does not hold."""
    return PEAKS.get(device_name)


def least_time(cells: int, mode: str, peak: dict, w_b: int = 128):
    """(seconds, "operations" or "bytes"): the larger of the operations
    over the float32 peak (outside the tensor cores) and the bytes over
    the memory bandwidth, and which of the two sets it."""
    t_ops = ops(cells, mode) / peak["fp32_flops_per_s"]
    t_bytes = nbytes(cells, mode, w_b) / peak["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def roofline_pct(cells: int, mode: str, seconds: float, peak: dict,
                 w_b: int = 128) -> Optional[float]:
    """The share of the chip's roofline that ``seconds`` of DP time
    reached on ``cells``, in percent; None without cells or time."""
    if cells <= 0 or seconds <= 0:
        return None
    return 100.0 * least_time(cells, mode, peak, w_b)[0] / seconds
