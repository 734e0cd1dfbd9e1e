# Frozen copy of blasr_tpu_torch/io/fasta.py: the plain PyTorch path only,
# imports pointed inside benchmark/reference (see __init__.py).
"""FASTA/FASTQ host-side I/O.

Capability parity with the reference's FASTAReader usage
(``Blasr.cpp:1021-1065``: whole-genome read into one concatenated sequence
plus a sequence index database) — re-implemented on NumPy byte arrays, not a
port.  Encoding: A=0 C=1 G=2 T=3, anything else (incl. N)=4; lowercase
accepted.  gzip-compressed files are handled transparently.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

# byte -> code lookup (A/C/G/T upper+lower -> 0..3, everything else 4)
_CODE = np.full(256, 4, dtype=np.int8)
for i, c in enumerate("ACGT"):
    _CODE[ord(c)] = i
    _CODE[ord(c.lower())] = i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement in code space: A<->T, C<->G, N->N
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


@dataclass
class FastaRecord:
    title: str          # full header line after '>'
    seq: np.ndarray     # int8 codes 0..4
    qual: Optional[np.ndarray] = None  # phred ints, FASTQ only
    # optional named QV tracks (PacBio iq/dq/sq BAM tags, HDF QV datasets),
    # forward-read orientation
    tracks: Optional[dict] = None

    @property
    def name(self) -> str:
        return self.title.split()[0] if self.title else ""

    def __len__(self) -> int:
        return len(self.seq)


def encode(seq: str | bytes) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    return _CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return _DECODE[np.asarray(codes, dtype=np.int8)].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(codes, dtype=np.int8)][::-1]


def md5_of_seq(codes: np.ndarray) -> str:
    """MD5 of the uppercase sequence text, as used for SAM @SQ M5 tags."""
    return hashlib.md5(_DECODE[np.asarray(codes, dtype=np.int8)].tobytes()).hexdigest()
