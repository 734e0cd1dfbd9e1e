# Copied from blasr_tpu/io/samparse.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""SAM parsing back into Alignment records.

Reference: SAMReader + SAMToAlignmentCandidateAdapter (used by samtom4,
samtoh5, samFilter — utils/SamToM4.cpp:25-28, utils/SamFilter.cpp:41-46).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, TextIO, Tuple

from blasr_tpu_torch.io.fasta import encode, revcomp
from blasr_tpu_torch.pipeline.map_read import Alignment

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar(s: str) -> List[Tuple[str, int]]:
    if s == "*":
        return []
    return [(op, int(n)) for n, op in _CIGAR_RE.findall(s)]


def cigar_query_span(cigar) -> Tuple[int, int, int]:
    """(leading clip, aligned query length, trailing clip)."""
    lead = trail = 0
    runs = list(cigar)
    if runs and runs[0][0] in "SH":
        lead = runs[0][1]
        runs = runs[1:]
    if runs and runs[-1][0] in "SH":
        trail = runs[-1][1]
        runs = runs[:-1]
    qlen = sum(n for op, n in runs if op in "MIS=X")
    return lead, qlen, trail


def iter_sam(f: TextIO, ref_lengths: Optional[Dict[str, int]] = None
             ) -> Iterator[Alignment]:
    """Yield Alignment records from a SAM stream (header lines update
    ref_lengths if given a dict)."""
    lengths: Dict[str, int] = {} if ref_lengths is None else ref_lengths
    for line in f:
        line = line.rstrip("\n")
        if not line:
            continue
        if line.startswith("@"):
            if line.startswith("@SQ"):
                d = dict(kv.split(":", 1) for kv in line.split("\t")[1:]
                         if ":" in kv)
                if "SN" in d and "LN" in d:
                    lengths[d["SN"]] = int(d["LN"])
            continue
        fields = line.split("\t")
        if len(fields) < 11:
            continue
        qname, flag, rname, pos, mapq, cigar_s = fields[:6]
        seq = fields[9]
        flag = int(flag)
        if flag & 4 or rname == "*":
            continue
        cigar = parse_cigar(cigar_s)
        lead, q_aln, trail = cigar_query_span(cigar)
        strand = 1 if flag & 16 else 0
        qlen = lead + q_aln + trail
        # strand-local -> forward-read coordinates
        if strand == 0:
            qstart, qend = lead, lead + q_aln
        else:
            qstart, qend = trail, trail + q_aln
        n_match = n_mismatch = n_ins = n_del = 0
        tspan = 0
        for op, n in cigar:
            if op in "M=":
                n_match += n
                tspan += n
            elif op == "X":
                n_mismatch += n
                tspan += n
            elif op == "I":
                n_ins += n
            elif op in "DN":
                n_del += n
                tspan += n
        tags = {}
        for t in fields[11:]:
            parts = t.split(":", 2)
            if len(parts) == 3:
                tags[parts[0]] = parts[2]
        score = float(tags.get("AS", -(n_match * 5)))
        core = [(op, n) for op, n in cigar if op not in "SH"]
        read_codes = None
        if seq != "*":
            oriented = encode(seq)
            read_codes = oriented if strand == 0 else revcomp(oriented)
            if cigar_s != "*" and ("H" in cigar_s):
                read_codes = None  # hard-clipped: full read unavailable
        yield Alignment(
            qname=qname, qlen=qlen, qstart=qstart, qend=qend, strand=strand,
            tindex=0, tname=rname, tlen=lengths.get(rname, 0),
            tstart=int(pos) - 1, tend=int(pos) - 1 + tspan,
            score=score, n_match=n_match, n_mismatch=n_mismatch,
            n_ins=n_ins, n_del=n_del, map_qv=int(mapq),
            cigar=core, read=read_codes,
        )


def read_sam(path: str) -> Tuple[List[str], List[Alignment]]:
    header: List[str] = []
    alns: List[Alignment] = []
    lengths: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                header.append(line.rstrip("\n"))
        f.seek(0)
        alns = list(iter_sam(f, lengths))
    return header, alns
