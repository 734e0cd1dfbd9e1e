# Copied from blasr_tpu/io/fasta.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""FASTA/FASTQ host-side I/O.

Capability parity with the reference's FASTAReader usage
(``Blasr.cpp:1021-1065``: whole-genome read into one concatenated sequence
plus a sequence index database) — re-implemented on NumPy byte arrays, not a
port.  Encoding: A=0 C=1 G=2 T=3, anything else (incl. N)=4; lowercase
accepted.  gzip-compressed files are handled transparently.
"""

from __future__ import annotations

import gzip
import hashlib
from dataclasses import dataclass
from typing import Iterator, List, Optional

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


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def iter_fasta(path: str) -> Iterator[FastaRecord]:
    title = None
    chunks: List[bytes] = []
    with _open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                if title is not None:
                    yield FastaRecord(title, encode(b"".join(chunks)))
                title = line[1:].decode()
                chunks = []
            else:
                chunks.append(line)
        if title is not None:
            yield FastaRecord(title, encode(b"".join(chunks)))


def iter_fastq(path: str) -> Iterator[FastaRecord]:
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            h = h.rstrip()
            if not h:
                continue
            if not h.startswith(b"@"):
                raise ValueError(f"bad FASTQ header: {h!r}")
            seq = f.readline().rstrip()
            plus = f.readline()
            qual = f.readline().rstrip()
            if not plus.startswith(b"+"):
                raise ValueError("bad FASTQ separator")
            q = np.frombuffer(qual, dtype=np.uint8).astype(np.int32) - 33
            yield FastaRecord(h[1:].decode(), encode(seq), q)


def read_fasta(path: str) -> List[FastaRecord]:
    return list(iter_fasta(path))


def read_fastq(path: str) -> List[FastaRecord]:
    return list(iter_fastq(path))


def sniff_format(path: str) -> str:
    """FileType detection by extension then content
    (files/BaseSequenceIO usage, MappingParameters.h:406-415)."""
    lower = path.lower()
    for ext, kind in (
        (".fasta", "fasta"), (".fa", "fasta"), (".fsta", "fasta"), (".fna", "fasta"),
        (".fastq", "fastq"), (".fq", "fastq"),
        (".bam", "bam"), (".sam", "sam"), (".fofn", "fofn"), (".xml", "dataset"),
        (".h5", "hdf"),
    ):
        if lower.endswith(ext) or lower.endswith(ext + ".gz"):
            return kind
    with _open(path) as f:
        first = f.read(8)
    if first == b"\x89HDF\r\n\x1a\n":
        return "hdf"
    return {b">": "fasta", b"@": "fastq"}.get(first[:1], "unknown")


def read_sequences(path: str) -> List[FastaRecord]:
    kind = sniff_format(path)
    if kind == "fasta":
        return read_fasta(path)
    if kind == "fastq":
        return read_fastq(path)
    if kind == "fofn":
        from blasr_tpu_torch.io.fofn import expand_fofn
        out: List[FastaRecord] = []
        for sub in expand_fofn(path):
            out.extend(read_sequences(sub))
        return out
    if kind == "bam" or kind == "sam":
        from blasr_tpu_torch.io.bam import read_bam_records
        return read_bam_records(path)
    if kind == "hdf":
        from blasr_tpu_torch.io.hdf import BaxReader
        rdr = BaxReader(path)
        try:
            return rdr.subreads()
        finally:
            rdr.close()
    if kind == "dataset":
        from blasr_tpu_torch.io.dataset import read_dataset
        return read_dataset(path)
    raise ValueError(f"unsupported input format for {path}")


def write_fasta(path: str, records: List[FastaRecord], width: int = 60) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(f">{r.title}\n")
            s = decode(r.seq)
            for i in range(0, len(s), width):
                f.write(s[i:i + width] + "\n")


def md5_of_seq(codes: np.ndarray) -> str:
    """MD5 of the uppercase sequence text, as used for SAM @SQ M5 tags."""
    return hashlib.md5(_DECODE[np.asarray(codes, dtype=np.int8)].tobytes()).hexdigest()
