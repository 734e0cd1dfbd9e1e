# Copied from blasr_tpu/cli/bwt2sa.py: contigs_from_concat only (the --bwt
# input path of the mapper); the bwt2sa tool itself is not part of the port.
"""Helpers of the bwt2sa tool that the mapper's ``--bwt`` input needs."""

from __future__ import annotations

import numpy as np

from blasr_tpu_torch.io.fasta import FastaRecord


def contigs_from_concat(genome: np.ndarray, names, lengths):
    """Split a concatenated (N-spaced) genome back into contig records."""
    out, off = [], 0
    for name, ln in zip(names, lengths):
        out.append(FastaRecord(name, np.asarray(genome[off:off + ln],
                                                dtype=np.int8)))
        off += ln + 1  # single-N spacer
    return out
