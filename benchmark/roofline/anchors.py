"""The anchor search's bytes (K5), as the algorithm needs them.

For every valid k-mer of a read (both strands; the port's
``MappingMetrics`` counter ``anchor_seeds``) the search looks its
occurrence range up (one 32-byte sector: the LUT row pair) and reads the
read's base (1 byte); for each occurrence it examines,
``min(nocc, occ_per_pos)`` a seed (``anchor_examined``), it reads the
occurrence's position and the 32 bases after the k-mer that extend it
(one 32-byte sector); it writes each anchor it keeps (``anchor_kept``:
the valid ones of the top A of a strand row) as its read position,
genome position, length and significance, four 32-bit words.

These are the same counts whatever lays the index out: the 24-byte
records (one row a slot) and the separate arrays (position, previous
base, packed words) count alike, as do the slots a kernel gathers past
``nocc`` and the invalid anchors it pads a row with.  No operation is
counted: the search compares and shifts a few words a slot, far below
what the bytes take at the card's rates.
"""

from __future__ import annotations

from typing import Optional

SECTOR = 32
ANCHOR_BYTES = 16


def nbytes(counters: dict) -> Optional[float]:
    """The bytes of the anchor search over the seeds that ``counters``
    (``MappingMetrics.counters``) count, or None where it counts none."""
    seeds = counters.get("anchor_seeds", 0)
    if seeds <= 0:
        return None
    return float(SECTOR * seeds + seeds
                 + SECTOR * counters.get("anchor_examined", 0)
                 + ANCHOR_BYTES * counters.get("anchor_kept", 0))


def roofline_pct(counters: dict, seconds: float, peak: dict
                 ) -> Optional[float]:
    """The share of the card's memory bandwidth that ``seconds`` of the
    anchors stage reached on those bytes, in percent; None without
    seeds or time."""
    b = nbytes(counters)
    if b is None or seconds <= 0:
        return None
    return 100.0 * b / peak["hbm_bytes_per_s"] / seconds
