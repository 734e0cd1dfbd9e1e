# Copied from blasr_tpu/io/formats.py; only the imports differ.
"""Output format printers: SAM and m0..m5.

Re-derivations of the reference's printer family (``format/*Printer``:
StickAlignmentPrinter m0, SummaryPrinter m1, XMLPrinter m2, VulgarPrinter m3,
IntervalPrinter m4, CompareSequencesPrinter m5, SAMPrinter — usage at
iblasr/BlasrUtilsImpl.hpp:950-1082).  Conventions preserved:

  * scores are negative-better; m4/m5 report target coordinates on the
    *reverse-complement strand* when tstrand == 1 (BLASR's historical m4
    quirk), while SAM always uses forward-reference coordinates with
    FLAG 16.
  * CIGAR never contains adjacent I/D ops unless allowAdjacentIndels
    (merged upstream); '=' / 'X' ops only with cigarUseSeqMatch.
  * clipping modes: none (aligned portion only, qname gains /start_end),
    soft, hard, subread (SAMOutput::Clipping, MappingParameters.h:565-580).
"""

from __future__ import annotations

from typing import List, Optional, TextIO

import numpy as np

from blasr_tpu_torch.index.genome import GenomeIndex
from blasr_tpu_torch.io.fasta import decode, revcomp
from blasr_tpu_torch.pipeline.map_read import Alignment

VERSION = "0.1.0"


def _oriented_read(a: Alignment) -> np.ndarray:
    """Read codes in the orientation that aligns to the forward target."""
    return a.read if a.strand == 0 else revcomp(a.read)


def _strand_local_q(a: Alignment):
    """(qa, qb) in the oriented-read coordinate system."""
    if a.strand == 0:
        return a.qstart, a.qend
    return a.qlen - a.qend, a.qlen - a.qstart


def aligned_strings(a: Alignment, gi: GenomeIndex):
    """(qString, matchString, tString) reconstructed from the CIGAR."""
    qa, qb = _strand_local_q(a)
    q = _oriented_read(a)[qa:qb]
    gstart = gi.seqdb.chrom_to_genome(a.tindex, a.tstart)
    gend = gi.seqdb.chrom_to_genome(a.tindex, a.tend)
    t = gi.genome[gstart:gend]
    qs, ms, ts = [], [], []
    qi = ti = 0
    for op, n in a.cigar or []:
        if op in "M=X":
            for _ in range(n):
                qc, tc = decode(q[qi:qi + 1]), decode(t[ti:ti + 1])
                qs.append(qc)
                ts.append(tc)
                ms.append("|" if qc == tc else " ")
                qi += 1
                ti += 1
        elif op == "I":
            qs.append(decode(q[qi:qi + n]))
            ts.append("-" * n)
            ms.append(" " * n)
            qi += n
        elif op in "DN":
            qs.append("-" * n)
            ts.append(decode(t[ti:ti + n]))
            ms.append(" " * n)
            ti += n
    return "".join(qs), "".join(ms), "".join(ts)


def _m4_target_coords(a: Alignment):
    """m4/m5 report reverse-strand hits in RC target coordinates."""
    if a.strand == 0:
        return a.tstart, a.tend
    return a.tlen - a.tend, a.tlen - a.tstart


def _qname(a: Alignment, preserve: bool, subread_title: bool = True) -> str:
    if preserve:
        return a.qname
    if not subread_title:
        # --noPrintSubreadTitle: strip the /qstart_qend suffix
        if "/" in a.qname and a.qname.rsplit("/", 1)[-1].count("_") == 1:
            return a.qname.rsplit("/", 1)[0]
        return a.qname
    # blasr subread convention: movie/zmw/qstart_qend; for plain FASTA
    # it appends /0_len
    if "/" in a.qname and a.qname.rsplit("/", 1)[-1].count("_") == 1:
        return a.qname
    return f"{a.qname}/0_{a.qlen}"


# ---------------------------------------------------------------------- m0
def _qn(a: Alignment, params=None) -> str:
    if params is None:
        return _qname(a, False)
    return _qname(a, getattr(params, "preserve_read_title", False),
                  getattr(params, "print_subread_title", True))


def write_m0(f: TextIO, a: Alignment, gi: GenomeIndex, width: int = 50,
             params=None):
    qstr, mstr, tstr = aligned_strings(a, gi)
    ts, te = _m4_target_coords(a)
    f.write(f"qName: {_qn(a, params)}\n")
    f.write(f"tName: {a.tname}\n")
    f.write(f"qStrand: 0\ntStrand: {a.strand}\n")
    f.write(f"score: {int(a.score)}\n")
    f.write(f"pctSimilarity: {a.pct_similarity:.2f}\n")
    f.write(f"qStart: {a.qstart}\nqEnd: {a.qend}\nqLength: {a.qlen}\n")
    f.write(f"tStart: {ts}\ntEnd: {te}\ntLength: {a.tlen}\n")
    f.write(f"mapQV: {a.map_qv}\n\n")
    for i in range(0, len(qstr), width):
        f.write(f"  q: {qstr[i:i+width]}\n")
        f.write(f"     {mstr[i:i+width]}\n")
        f.write(f"  t: {tstr[i:i+width]}\n\n")


# ---------------------------------------------------------------------- m1
def write_m1(f: TextIO, a: Alignment, params=None):
    ts, te = _m4_target_coords(a)
    f.write(" ".join(map(str, [
        _qn(a, params), a.tname, 0, a.strand, int(a.score),
        f"{a.pct_similarity:.4f}", ts, te, a.tlen,
        a.qstart, a.qend, a.qlen, a.n_cells])) + "\n")


# ---------------------------------------------------------------------- m2
def write_m2(f: TextIO, a: Alignment, gi: GenomeIndex, params=None):
    qstr, _, tstr = aligned_strings(a, gi)
    ts, te = _m4_target_coords(a)
    f.write(f'<hit name="{_qn(a, params)}" unalignedLength="{a.qlen}" '
            f'start="{a.qstart}" end="{a.qend}" strand="0" '
            f'targetStart="{ts}" targetEnd="{te}" targetStrand="{a.strand}" '
            f'score="{int(a.score)}">\n')
    f.write(f"  <zAlignment query=\"{qstr}\" target=\"{tstr}\"/>\n</hit>\n")


# ---------------------------------------------------------------------- m3
def write_m3(f: TextIO, a: Alignment, params=None):
    """Vulgar format: label triplets M/I/D with lengths."""
    ts, te = _m4_target_coords(a)
    trip = []
    for op, n in a.cigar or []:
        if op in "M=X":
            trip.append(f"M {n} {n}")
        elif op == "I":
            trip.append(f"I {n} 0")
        elif op == "D":
            trip.append(f"D 0 {n}")
    f.write(" ".join(map(str, [
        _qn(a, params), a.qstart, a.qend, 0, a.tname, ts, te, a.strand,
        int(a.score)])) + " " + " ".join(trip) + "\n")


# ---------------------------------------------------------------------- m4
def write_m4(f: TextIO, a: Alignment, params=None):
    ts, te = _m4_target_coords(a)
    f.write(" ".join(map(str, [
        _qn(a, params), a.tname, int(a.score),
        f"{a.pct_similarity:.4f}", 0, a.qstart, a.qend, a.qlen,
        a.strand, ts, te, a.tlen, a.map_qv])) + "\n")


M4_HEADER = ("qname tname score pctsimilarity qstrand qstart qend qseqlength "
             "tstrand tstart tend tseqlength mapqv\n")


# ---------------------------------------------------------------------- m5
def write_m5(f: TextIO, a: Alignment, gi: GenomeIndex, params=None):
    qstr, mstr, tstr = aligned_strings(a, gi)
    ts, te = _m4_target_coords(a)
    f.write(" ".join(map(str, [
        _qn(a, params), a.qlen, a.qstart, a.qend, 0,
        a.tname, a.tlen, ts, te, a.strand,
        int(a.score), a.n_match, a.n_mismatch, a.n_ins, a.n_del,
        a.map_qv, qstr, mstr, tstr])) + "\n")


# ---------------------------------------------------------------------- SAM
def sam_header(gi: GenomeIndex, cmdline: str = "",
               read_groups: Optional[List[str]] = None) -> str:
    lines = ["@HD\tVN:1.5\tSO:UNKNOWN\tpb:3.0.1"]
    for name, length, md5 in zip(gi.seqdb.names, gi.seqdb.lengths,
                                 gi.seqdb.md5s):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(length)}\tM5:{md5}")
    for rg in read_groups or []:
        lines.append(rg)
    lines.append(f"@PG\tID:blasr_tpu\tPN:blasr_tpu\tVN:{VERSION}\tCL:{cmdline}")
    return "\n".join(lines) + "\n"


def _cigar_string(cigar: List, use_seq_match: bool) -> str:
    out: List = []
    for op, n in cigar:
        o = op
        if not use_seq_match and op in "=X":
            o = "M"
        if out and out[-1][0] == o:
            out[-1] = (o, out[-1][1] + n)
        else:
            out.append((o, n))
    return "".join(f"{n}{o}" for o, n in out)


# --printSAMQV: the SAMPrinter's PacBio QV tags (RegisterBlasrOptions.h
# samqv option; tags as in cli/bax2bam.py TAG_OF_TRACK)
_SAMQV_TAGS = [("iq", "InsertionQV"), ("dq", "DeletionQV"),
               ("sq", "SubstitutionQV"), ("mq", "MergeQV"),
               ("dt", "DeletionTag"), ("st", "SubstitutionTag")]
_COMP = {65: "T", 67: "G", 71: "C", 84: "A", 78: "N"}


def _samqv_values(a: Alignment, qa: int, qb: int, whole: bool,
                  names=()):
    """[(tag, string)] for the tracks present, oriented with the record
    (QVs reversed, tag bases complemented on the reverse strand) and
    clipped like the SEQ field.  names: --samQV track subset (empty =
    every present track, SupplementalQVList.SetDefaultQV)."""
    t = a.tracks or {}
    out = []
    for tag, name in _SAMQV_TAGS:
        if names and name not in names and tag not in names:
            continue
        v = t.get(name)
        if v is None:
            continue
        if name.endswith("Tag"):
            if a.strand:
                s = [_COMP.get(int(x), "N") for x in v[::-1]]
            else:
                s = [chr(int(x)) for x in v]
            s = s if whole else s[qa:qb]
            out.append((tag, "".join(s)))
        else:
            q = v[::-1] if a.strand else v
            q = q if whole else q[qa:qb]
            out.append((tag, "".join(chr(min(93, int(x)) + 33)
                                     for x in q)))
    return out


def write_sam(f: TextIO, a: Alignment, params=None,
              rnext: str = "*", pnext: int = 0):
    clipping = getattr(params, "clipping", "none") if params else "none"
    use_eq = getattr(params, "cigar_use_seq_match", False) if params else False
    oread = _oriented_read(a)
    qa, qb = _strand_local_q(a)
    flag = 16 if a.strand else 0
    cigar = list(a.cigar or [])
    if clipping in ("soft", "subread"):
        lead, trail = qa, a.qlen - qb
        if lead:
            cigar = [("S", lead)] + cigar
        if trail:
            cigar = cigar + [("S", trail)]
        seq = oread
        qname = _qname(a, True) if "/" in a.qname else _qname(a, False)
    elif clipping == "hard":
        lead, trail = qa, a.qlen - qb
        if lead:
            cigar = [("H", lead)] + cigar
        if trail:
            cigar = cigar + [("H", trail)]
        seq = oread[qa:qb]
        qname = _qname(a, False)
    else:  # none: aligned portion only, coordinates in the qname
        seq = oread[qa:qb]
        base = a.qname.split("/")[0] if "/" not in a.qname else a.qname.rsplit("/", 1)[0]
        qname = f"{base}/{a.qstart}_{a.qend}"
    qualstr = "*"
    if a.qual is not None:
        q = a.qual if a.strand == 0 else a.qual[::-1]
        if clipping in ("soft", "subread"):
            qualstr = "".join(chr(min(93, int(x)) + 33) for x in q)
        else:
            qualstr = "".join(chr(min(93, int(x)) + 33) for x in q[qa:qb])
    edit_dist = a.n_mismatch + a.n_ins + a.n_del
    fields = [
        qname, str(flag), a.tname, str(a.tstart + 1), str(a.map_qv),
        _cigar_string(cigar, use_eq),
        rnext, str(pnext + 1 if rnext != "*" else 0), "0",
        decode(seq), qualstr,
        f"AS:i:{int(a.score)}", f"NM:i:{edit_dist}",
    ]
    if params is not None and getattr(params, "print_sam_qv", False):
        fields += [f"{tag}:Z:{val}" for tag, val in _samqv_values(
            a, qa, qb, clipping in ("soft", "subread"),
            getattr(params, "sam_qv_list", ()))]
    f.write("\t".join(fields) + "\n")


def to_bam_record(a: Alignment, params=None, ref_ids: Optional[dict] = None):
    """Alignment -> BamRecord, mirroring write_sam's clipping semantics."""
    from blasr_tpu_torch.io.bam import BamRecord
    clipping = getattr(params, "clipping", "none") if params else "none"
    use_eq = getattr(params, "cigar_use_seq_match", False) if params else False
    oread = _oriented_read(a)
    qa, qb = _strand_local_q(a)
    cigar = list(a.cigar or [])
    if not use_eq:
        merged: List = []
        for op, n in cigar:
            o = "M" if op in "=X" else op
            if merged and merged[-1][0] == o:
                merged[-1] = (o, merged[-1][1] + n)
            else:
                merged.append((o, n))
        cigar = merged
    if clipping in ("soft", "subread"):
        if qa:
            cigar = [("S", qa)] + cigar
        if a.qlen - qb:
            cigar = cigar + [("S", a.qlen - qb)]
        seq = oread
        qual = a.qual if a.strand == 0 else (
            a.qual[::-1] if a.qual is not None else None)
        qname = _qname(a, True) if "/" in a.qname else _qname(a, False)
    elif clipping == "hard":
        if qa:
            cigar = [("H", qa)] + cigar
        if a.qlen - qb:
            cigar = cigar + [("H", a.qlen - qb)]
        seq = oread[qa:qb]
        qual = None
        qname = _qname(a, False)
    else:
        seq = oread[qa:qb]
        q = a.qual if a.strand == 0 else (
            a.qual[::-1] if a.qual is not None else None)
        qual = q[qa:qb] if q is not None else None
        base = a.qname if "/" not in a.qname else a.qname.rsplit("/", 1)[0]
        qname = f"{base}/{a.qstart}_{a.qend}"
    tags = {"AS": int(a.score), "NM": a.n_mismatch + a.n_ins + a.n_del,
            "RG": "default"}
    if params is not None and getattr(params, "print_sam_qv", False):
        tags.update(_samqv_values(a, qa, qb,
                                  clipping in ("soft", "subread"),
                                  getattr(params, "sam_qv_list", ())))
    return BamRecord(
        qname=qname, flag=16 if a.strand else 0,
        ref_id=(ref_ids or {}).get(a.tname, a.tindex),
        pos=a.tstart, mapq=min(a.map_qv, 254), cigar=cigar, seq=seq,
        qual=qual, tags=tags,
    )


def write_unaligned(f: TextIO, qname: str, seq: Optional[np.ndarray],
                    no_seqs: bool = False):
    """Unaligned-read listing (PrintUnaligned, BlasrUtilsImpl.hpp:1098-1114)."""
    if no_seqs or seq is None:
        f.write(f"{qname}\n")
    else:
        f.write(f">{qname}\n{decode(seq)}\n")
