# Copied from blasr_tpu/cli/small_tools.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""Small companion tools (SURVEY.md §2.7 / extrautils family).

Each ``run_*`` mirrors one reference tool's interface and observable
behavior; console entry points live in the package ``__main__``-style
wrappers below.

  * toAfg           — reads -> AMOS afg (utils/ToAfg.cpp)
  * printTupleCountTable — genome k-mer count table
                      (extrautils/PrintTupleCountTable.cpp; ctab artifact
                      loadable via ``blasr_tpu_torch --ctab``)
  * sals            — index introspection (extrautils/SALS.cpp)
  * samodify        — rebuild index lookup table with a new prefix length
                      (extrautils/SAModify.cpp: 'samodify in.sa genome.fasta
                      out.sa -blt p')
  * evolve          — mutate a genome, emit GFF of variants
                      (extrautils/Evolve.cpp)
  * exciseRepeats   — cut RepeatMasker .out regions from a sequence
                      (extrautils/ExciseRepeats.cpp)
  * simpleShredder  — sample uniform reads from a genome
                      (extrautils/SimpleShredder.cpp)
  * bsdb            — sequence index database (extrautils/BuildSequenceDB.cpp)
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from blasr_tpu_torch.io.fasta import (FastaRecord, decode, read_fasta,
                                read_sequences, write_fasta)
from blasr_tpu_torch.io.fofn import expand_file_name_list


# ------------------------------------------------------------------ toAfg
def run_to_afg(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="toAfg",
        description="Print reads stored in a file (pls|fasta|fastq) as an afg.")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-minSubreadLength", type=int, default=0)
    ap.add_argument("-regionTable", default=None)
    ap.add_argument("-noSplitSubreads", action="store_true")
    ap.add_argument("-useccsdenovo", action="store_true")
    ap.add_argument("-uniformQV", type=int, default=None)
    args = ap.parse_args(argv)
    recs = []
    for path in expand_file_name_list([args.input]):
        recs.extend(read_sequences(path))
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        iid = 0
        for r in recs:
            if len(r.seq) < args.minSubreadLength:
                continue
            iid += 1
            if args.uniformQV is not None:
                q = np.full(len(r.seq), args.uniformQV, int)
            elif r.qual is not None:
                q = r.qual
            else:
                q = np.full(len(r.seq), 20, int)
            out.write("{RED\n")
            out.write(f"iid:{iid}\n")
            out.write(f"eid:{r.title}\n")
            out.write("seq:\n")
            s = decode(r.seq)
            for i in range(0, len(s), 60):
                out.write(s[i:i + 60] + "\n")
            out.write(".\n")
            out.write("qlt:\n")
            qs = "".join(chr(min(int(x), 60) + 48) for x in q)
            for i in range(0, len(qs), 60):
                out.write(qs[i:i + 60] + "\n")
            out.write(".\n}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


# ----------------------------------------------------- printTupleCountTable
def run_print_tuple_count_table(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="printTupleCountTable",
        description="Count the number of occurrences of every k-mer.")
    ap.add_argument("table", help="output table (.ctab.npz)")
    ap.add_argument("reads", nargs="*", help="sequence files")
    ap.add_argument("-wordsize", type=int, default=8)
    args = ap.parse_args(argv)
    table, reads = args.table, list(args.reads)
    if not reads:
        # single-arg form: 'printTupleCountTable f.fasta' -> f.fasta.ctab
        reads = [table]
        table = table + ".ctab"
    from blasr_tpu_torch.index.genome import build_ctab
    counts = np.zeros(4 ** args.wordsize, np.int64)
    for path in expand_file_name_list(reads):
        for rec in read_sequences(path):
            counts += build_ctab(rec.seq, args.wordsize).astype(np.int64)
    if table.endswith(".npz"):
        np.savez_compressed(table[:-4], k=np.int32(args.wordsize),
                            counts=counts.astype(np.int32))
    else:
        # reference binary layout (TupleCountTable::Write; the reference's
        # default single-arg form names it f.fasta.ctab)
        from blasr_tpu_torch.io.refbin import write_ref_ctab
        write_ref_ctab(table, args.wordsize, counts.astype(np.int32))
    sys.stderr.write(f"wrote {table} ({int(counts.sum())} tuples)\n")
    return 0


def load_ctab(path: str):
    """Reference binary .ctab (Blasr.cpp:1136-1147 ct.Read) or our .npz."""
    from blasr_tpu_torch.io.refbin import load_any_ctab
    return load_any_ctab(path)


# ------------------------------------------------------------------- sals
def run_sals(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="sals", description="checks index components (SA, lookup table)")
    ap.add_argument("sa", help="index .npz or reference binary .sa")
    args = ap.parse_args(argv)
    from blasr_tpu_torch.io.refsa import is_ref_sa, read_ref_sa
    if is_ref_sa(args.sa):
        try:
            sa, p, table = read_ref_sa(args.sa)
        except ValueError:
            print("The file is not in a sa format.")
            return 1
        print(" * has a suffix array." if sa is not None
              else " * does not contain a suffix array.")
        print(f" * has a lookup table for word size. {p}"
              if table is not None else " * does not have a lookup table.")
        return 0
    from blasr_tpu_torch.index.genome import GenomeIndex
    try:
        gi = GenomeIndex.load(args.sa)
    except Exception:
        print("The file is not in a sa format.")
        return 1
    if gi.suffix_array is not None:
        print(" * has a suffix array.")
    else:
        print(" * does not contain a suffix array.")
    if gi.bucket_starts is not None:
        print(f" * has a lookup table for word size. {gi.k}")
    else:
        print(" * does not have a lookup table.")
    print(f" * k-mer table entries: {len(gi.pos_sorted)}")
    print(f" * tuple count table word size: {gi.ctab_k}")
    return 0


# --------------------------------------------------------------- samodify
def run_samodify(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="samodify",
        description="changes word size of input index lookup table")
    ap.add_argument("in_sa")
    ap.add_argument("genome")
    ap.add_argument("out_sa")
    ap.add_argument("-blt", type=int, default=8)
    args = ap.parse_args(argv)
    from blasr_tpu_torch.index.genome import GenomeIndex, build_genome_index
    from blasr_tpu_torch.io.refsa import (is_ref_sa, lookup_table_from_sa,
                                    read_ref_sa, write_ref_sa)
    contigs = read_fasta(args.genome)
    if is_ref_sa(args.in_sa):
        # reference binary layout: keep the stored SA, rebuild the lookup
        # table at the new prefix length (SAModify.cpp:58-74)
        sa, _, _ = read_ref_sa(args.in_sa)
        if sa is None:
            sys.stderr.write("samodify: input has no suffix array\n")
            return 1
        from blasr_tpu_torch.index.genome import concat_contigs
        genome, _ = concat_contigs(contigs)
        table = lookup_table_from_sa(genome, sa, args.blt)
        write_ref_sa(args.out_sa, sa, args.blt, table)
        sys.stderr.write(f"wrote {args.out_sa} (reference .sa layout, "
                         f"blt={args.blt})\n")
        return 0
    gi = GenomeIndex.load(args.in_sa)
    gi2 = build_genome_index(
        contigs, k=args.blt, ctab_k=gi.ctab_k,
        with_suffix_array=gi.suffix_array is not None)
    out = args.out_sa[:-4] if args.out_sa.endswith(".npz") else args.out_sa
    gi2.save(out)
    sys.stderr.write(f"wrote {out}.npz (k={args.blt})\n")
    return 0


# ----------------------------------------------------------------- evolve
def run_evolve(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="evolve", description="mutate a genome, emitting variant GFF")
    ap.add_argument("refGenome")
    ap.add_argument("mutGenome")
    ap.add_argument("-sub", type=float, default=0.0)
    ap.add_argument("-ins", type=float, default=0.0)
    ap.add_argument("-del", dest="dele", type=float, default=0.0)
    ap.add_argument("-lower", action="store_true")
    ap.add_argument("-gff", default=None)
    ap.add_argument("-seed", type=int, default=0)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    contigs = read_fasta(args.refGenome)
    gff = open(args.gff, "w") if args.gff else None
    out_recs = []
    bases = "ACGT"
    for ci, c in enumerate(contigs):
        seq = c.seq
        u = rng.random(len(seq))
        out: List[np.ndarray] = []
        for i in range(len(seq)):
            b = seq[i]
            if u[i] < args.sub:
                nb = (int(b) + 1 + int(rng.integers(0, 3))) % 4
                out.append(np.asarray([nb], np.int8))
                if gff:
                    gff.write(
                        f"ref{ci + 1:06d}\t.\tSNV\t{i + 1}\t{i + 1}\t0.00\t.\t.\t"
                        f"reference={bases[int(b) % 4]};confidence=0;"
                        f"Name={i + 1}{bases[int(b) % 4]}>{bases[nb]};"
                        f"coverage=0;variantseq={bases[nb]}\n")
            elif u[i] < args.sub + args.dele:
                if gff:
                    gff.write(
                        f"ref{ci + 1:06d}\t.\tdeletion\t{i + 1}\t{i + 1}\t0.00\t.\t.\t"
                        f"reference={bases[int(b) % 4]};length=1;confidence=0;"
                        f"coverage=0;Name={i}del{bases[int(b) % 4]}\n")
                continue
            elif u[i] < args.sub + args.dele + args.ins:
                nb = int(rng.integers(0, 4))
                out.append(np.asarray([nb, b], np.int8))
                if gff:
                    gff.write(
                        f"ref{ci + 1:06d}\t.\tinsertion\t{i + 1}\t{i + 1}\t0.00\t.\t.\t"
                        f"confidence=0;Name={i}_{i + 1}ins{bases[nb]};"
                        f"reference=.;length=1;coverage=0;"
                        f"variantseq={bases[nb]}\n")
            else:
                out.append(np.asarray([b], np.int8))
        out_recs.append(FastaRecord(c.title, np.concatenate(out)))
    if gff:
        gff.close()
    write_fasta(args.mutGenome, out_recs)
    return 0


# ---------------------------------------------------------- exciseRepeats
def run_excise_repeats(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if len(argv) < 3:
        sys.stderr.write("usage: exciseRepeats inName repMaskOutFile outName\n")
        return 1
    in_name, dot_out, out_name = argv[0], argv[1], argv[2]
    recs = read_fasta(in_name)
    seq = recs[0].seq.copy()
    keep = np.ones(len(seq), bool)
    with open(dot_out) as f:
        lines = f.read().splitlines()
    for line in lines[3:]:   # RepeatMasker .out: 3 header lines
        parts = line.split()
        if len(parts) < 7:
            continue
        a, b = int(parts[5]), int(parts[6])
        keep[a:b] = False
    out_seq = seq[keep]
    write_fasta(out_name, [FastaRecord(recs[0].title, out_seq)])
    return 0


# --------------------------------------------------------- simpleShredder
def run_simple_shredder(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="simpleShredder", description="sample reads from a genome")
    ap.add_argument("inFile")
    ap.add_argument("-readsFile", required=True)
    ap.add_argument("-readLength", type=int, default=1000)
    ap.add_argument("-coverage", type=float, default=0.0)
    ap.add_argument("-nReads", type=int, default=-1)
    ap.add_argument("-stratify", type=int, default=0)
    ap.add_argument("-fastq", action="store_true")
    ap.add_argument("-quality", type=int, default=20)
    ap.add_argument("-nonRandInit", action="store_true")
    ap.add_argument("-titleType", default="pacbio",
                    choices=["pacbio", "illumina"])
    args = ap.parse_args(argv)
    contigs = read_fasta(args.inFile)
    genome = np.concatenate([c.seq for c in contigs])
    n = len(genome)
    L = min(args.readLength, n)
    rng = np.random.default_rng(0 if args.nonRandInit else None)
    if args.stratify:
        starts = list(range(0, max(n - L, 1), args.stratify))
    else:
        if args.nReads > 0:
            count = args.nReads
        elif args.coverage > 0:
            count = int(args.coverage * n / max(L, 1))
        else:
            sys.stderr.write(
                "ERROR, you must specify either coverage, nReads, "
                "or stratify.\n")
            return 1
        starts = rng.integers(0, max(n - L, 1), count).tolist()
    with open(args.readsFile, "w") as out:
        for i, s in enumerate(starts):
            sub = genome[s:s + L]
            if args.titleType == "pacbio":
                title = f"shred/{i}/0_{len(sub)}"
            else:
                title = f"SHRED_{i}"
            if args.fastq:
                out.write(f"@{title}\n{decode(sub)}\n+\n")
                out.write(chr(args.quality + 33) * len(sub) + "\n")
            else:
                out.write(f">{title}\n{decode(sub)}\n")
    return 0


# ------------------------------------------------------------------- bsdb
def run_bsdb(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="bsdb", description="Build an index database on sequences.")
    ap.add_argument("fasta")
    ap.add_argument("index")
    args = ap.parse_args(argv)
    from blasr_tpu_torch.index.genome import concat_contigs
    recs = []
    for path in expand_file_name_list([args.fasta]):
        recs.extend(read_fasta(path))
    _, seqdb = concat_contigs(recs)
    out = args.index[:-4] if args.index.endswith(".npz") else args.index
    np.savez_compressed(
        out, names=np.array(seqdb.names), starts=seqdb.starts,
        lengths=seqdb.lengths, md5s=np.array(seqdb.md5s))
    sys.stderr.write(f"wrote {out}.npz ({len(recs)} sequences)\n")
    return 0
