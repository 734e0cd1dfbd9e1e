"""sdpMatcher equivalent: standalone pairwise SDP aligner.

Reference: utils/SDPMatcher.cpp — aligns query[i] x target[i] FASTA pairs
(or every query against one fixed target) with SDPAlign, prints a CSV
header ``qid,tid,qstart,qend,qlen,tstart,tend,tlen,score`` and one row per
pair (utils/SDPMatcher.cpp:127-173).  Flags mirrored: k positional,
-indelRate, -indel, -match, -local, -noRefine, -showalign, -printsw,
-fixedtarget, -printSimilarity.

The port of ``blasr_tpu/cli/sdp_matcher.py``, with one more flag,
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions;
``cuda`` without a card is an error).  On the card the SDP skeleton runs
the fragment match in PyTorch and the chain on K3 and K7
(``kernels/sdp.py``); the refinement is the guided banded DP on K1
(``banded_align_cuda``: the two-valued form for the default matrix, the
GEN form for any other), its band offsets on K6 and its traceback on K2
at ``t_max = Lq + Lt``.  -printsw uses the full NumPy SW.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np


def run(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3:
        sys.stderr.write(
            "usage: sdpMatcher query target k [-indelRate delta] "
            "[-showalign] [-printsw] [-noRefine] [-indel i] [ -local ] "
            "[-match m] [-fixedtarget] [-printSimilarity] "
            "[--device cuda|cpu]\n")
        return 1
    query_name, target_name, k = argv[0], argv[1], int(argv[2])
    indel = 3
    match = 0
    indel_rate = 0.25
    local = False
    refine = True
    showalign = printsw = fixed_target = print_similarity = False
    device = "cuda"
    i = 3
    while i < len(argv):
        a = argv[i]
        if a == "-indelRate":
            i += 1
            indel_rate = float(argv[i])
        elif a == "-indel":
            i += 1
            indel = int(argv[i])
        elif a == "-match":
            i += 1
            match = int(argv[i])
        elif a in ("-sdpIndel", "-sdpIns", "-sdpDel"):
            i += 1  # accepted, unused (same as the reference)
        elif a == "-local":
            local = True
        elif a == "-noRefine":
            refine = False
        elif a == "-showalign":
            showalign = True
        elif a == "-printsw":
            printsw = True
        elif a == "-fixedtarget":
            fixed_target = True
        elif a == "-printSimilarity":
            print_similarity = True
        elif a == "--device":
            i += 1
            device = argv[i]
        else:
            sys.stderr.write(f"Bad option: {a}\n")
            return 1
        i += 1

    import torch

    from blasr_tpu_torch.io.fasta import read_fasta
    from blasr_tpu_torch.kernels.banded import banded_traceback
    from blasr_tpu_torch.kernels.pallas_banded import banded_align_cuda
    from blasr_tpu_torch.kernels.sdp import sdp_align
    from blasr_tpu_torch.kernels.sw import SWAlignment, stick_print, sw_align
    from blasr_tpu_torch.params import default_score_matrix, round_up
    from blasr_tpu_torch.pipeline.map_read import (_band_offsets,
                                                   pairs_to_cigar)

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (pass --device cpu "
            "to run the plain PyTorch path)")
    queries = read_fasta(query_name)
    targets = read_fasta(target_name)
    pairs = ([(q, targets[0]) for q in queries] if fixed_target
             else list(zip(queries, targets)))
    pairs = [(q, t) for q, t in pairs if len(q.seq) and len(t.seq)]

    out = sys.stdout
    hdr = "qid,tid,qstart,qend,qlen,tstart,tend,tlen,score"
    if print_similarity:
        hdr += ",pctSimilarity"
    out.write(hdr + "\n")
    if not pairs:
        return 0

    Lq = round_up(max(len(q.seq) for q, _ in pairs), 64)
    Lt = round_up(max(len(t.seq) for _, t in pairs) + 129, 128)
    N = len(pairs)
    qarr = np.full((N, Lq), 4, np.int8)
    tarr = np.full((N, Lt), 4, np.int8)
    qlen = np.zeros(N, np.int32)
    tlen = np.zeros(N, np.int32)
    for n, (q, t) in enumerate(pairs):
        qarr[n, : len(q.seq)] = q.seq
        # target shifted by 1: the banded DP boundary cell needs ta >= 1
        tarr[n, 1: 1 + len(t.seq)] = t.seq
        qlen[n] = len(q.seq)
        tlen[n] = len(t.seq) + 1

    def up(a):
        return torch.from_numpy(a).to(dev)

    qarr_d, tarr_d = up(qarr), up(tarr)
    res = sdp_align(qarr_d, up(qlen), tarr_d, up(tlen), k=k,
                    global_align=not local)

    qa = res.q_start.cpu().numpy().astype(np.int32)
    qb = np.maximum(res.q_end.cpu().numpy(), qa + 1).astype(np.int32)
    ta = np.maximum(res.t_start.cpu().numpy(), 1).astype(np.int32)
    tb = np.maximum(np.minimum(res.t_end.cpu().numpy(), tlen),
                    ta + 1).astype(np.int32)
    okdp = stats = pairs_np = scores = None
    if refine:
        mat = default_score_matrix(match, 0)
        submat = np.asarray(mat, np.float32).reshape(25)
        offs = _band_offsets(res.mq, res.mt,
                             torch.zeros(N, dtype=torch.int64, device=dev),
                             Lq, Lt, 128).to(torch.int32)
        ranges = tuple(up(x) for x in (qa, qb, ta, tb))
        g = float(indel)
        aln = banded_align_cuda(qarr_d, tarr_d, offs, *ranges, submat,
                                g, g, g, g, w_b=128)
        tbk = banded_traceback(aln, offs, *ranges, t_max=Lq + Lt, w_b=128)
        scores = aln.score.cpu().numpy()
        okdp = aln.valid.cpu().numpy()
        stats = tuple(x.cpu().numpy() for x in
                      (tbk.n_match, tbk.n_mismatch, tbk.n_ins, tbk.n_del))
        pairs_np = tbk.pairs.cpu().numpy()

    valid = res.valid.cpu().numpy()
    chain_bases = res.score.cpu().numpy()
    for n, (q, t) in enumerate(pairs):
        if not valid[n]:
            row = [q.name, t.name, 0, 0, len(q.seq), 0, 0, len(t.seq), 0]
            if print_similarity:
                row.append("0.00")
            out.write(",".join(map(str, row)) + "\n")
            continue
        if refine and okdp[n]:
            score = int(scores[n])
            nm, nx, ni, nd = (int(s[n]) for s in stats)
            pct = 100.0 * nm / max(nm + nx + ni + nd, 1)
        else:
            # -noRefine: score the chained fragment bases as matches
            bases = int(chain_bases[n])
            score = bases * (match if match else -5)
            pct = 100.0
        score = min(score, 0)  # reference clamps rare positive SDP scores
        row = [q.name, t.name, int(qa[n]), int(qb[n]), len(q.seq),
               int(ta[n]) - 1, int(tb[n]) - 1, len(t.seq), score]
        if print_similarity:
            row.append(f"{pct:.2f}")
        out.write(",".join(map(str, row)) + "\n")
        if showalign and refine and okdp[n]:
            cigar = pairs_to_cigar(pairs_np[n])
            sa = SWAlignment(score=score, q_start=int(qa[n]),
                             q_end=int(qb[n]), t_start=int(ta[n]),
                             t_end=int(tb[n]), cigar=cigar)
            stick_print(sa, qarr[n], tarr[n], out)
        if printsw:
            sw = sw_align(q.seq, t.seq, match=(match if match else -5),
                          ins=indel, delete=indel,
                          align_type="local" if local else "global")
            stick_print(sw, q.seq, t.seq, out)
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
