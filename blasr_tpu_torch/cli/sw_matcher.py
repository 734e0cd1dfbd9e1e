# Copied from blasr_tpu/cli/sw_matcher.py; only the imports differ.
"""swMatcher equivalent: full Smith-Waterman pairwise tool.

Reference: extrautils/SWMatcher.cpp — aligns query[i] x target[i] FASTA
pairs with the full DP, modes global/local/queryfit/overlap, prints a
``qlen tlen score`` header then per pair two lines:
``qlen tlen score`` and ``qPos qEnd tPos tEnd`` (SWMatcher.cpp:150-168).
Flags mirrored: -insertion/-deletion/-indel, -local/-queryfit/-overlap,
-type X, -match, -mismatch, -fixedtarget, -fixedquery, -showalign.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from blasr_tpu_torch.io.fasta import read_fasta
from blasr_tpu_torch.kernels.sw import stick_print, sw_align


def run(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        sys.stderr.write(
            "usage: swMatcher query target [-indel i] [-local] [-showalign]\n"
            "       [-type queryfit|overlap|global] [-match m] [-mismatch m]\n"
            "    or [-local] [-queryfit] [-overlap] [-fixedtarget] "
            "[-fixedquery]\n")
        return 1
    query_name, target_name = argv[0], argv[1]
    insertion, deletion = 4, 5
    match_d, mismatch_d = 0, 0
    align_type = "global"
    show_align = fixed_target = fixed_query = False
    i = 2
    while i < len(argv):
        a = argv[i]
        if a == "-insertion":
            i += 1
            insertion = int(argv[i])
        elif a == "-deletion":
            i += 1
            deletion = int(argv[i])
        elif a == "-indel":
            i += 1
            insertion = deletion = int(argv[i])
        elif a == "-local":
            align_type = "local"
        elif a == "-queryfit":
            align_type = "queryfit"
        elif a == "-overlap":
            align_type = "overlap"
        elif a == "-type":
            i += 1
            align_type = argv[i]
            if align_type not in ("queryfit", "overlap", "global", "local"):
                sys.stderr.write(
                    " ERROR, aligntype must be one of queryfit, overlap, "
                    "or global\n")
                return 1
        elif a == "-match":
            i += 1
            match_d = int(argv[i])
        elif a == "-mismatch":
            i += 1
            mismatch_d = int(argv[i])
        elif a == "-showalign":
            show_align = True
        elif a == "-fixedtarget":
            fixed_target = True
        elif a == "-fixedquery":
            fixed_query = True
        else:
            sys.stderr.write(f"Bad option: {a}\n")
            return 1
        i += 1

    queries = read_fasta(query_name)
    targets = read_fasta(target_name)
    if fixed_target:
        pairs = [(q, targets[0]) for q in queries]
    elif fixed_query:
        pairs = [(queries[0], t) for t in targets]
    else:
        pairs = list(zip(queries, targets))

    out = sys.stdout
    out.write("qlen tlen score\n")
    for q, t in pairs:
        if len(q.seq) == 0 or len(t.seq) == 0:
            continue
        aln = sw_align(q.seq, t.seq, match=-5 + match_d,
                       mismatch=6 + mismatch_d,
                       ins=insertion, delete=deletion,
                       align_type=align_type)
        if show_align:
            stick_print(aln, q.seq, t.seq, out)
        out.write(f"{len(q.seq)} {len(t.seq)} {aln.score}\n")
        out.write(f"{aln.q_start} {aln.q_end} {aln.t_start} {aln.t_end}\n")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
