"""The mapQV's likelihood rescore per alignment rescored: the program's
span ``emit.rescore`` in ``store_map_qvs`` (``_log10_likelihood`` over
each overlap group of more than one alignment: a revcomp, the CIGAR
expanded, ``log10_prob_alignment``), its seconds over its count of
alignments, in the StageTimer half of the window."""

UNIT = "us"
LAYER = "CLI output (cli/blasr.py::emit, pipeline/select.py, io/formats.py)"
MOVES = "device_s_per_gbase"
SPAN = "emit.rescore"


def read(ctx):
    st = ctx.get("staged")
    if not st or not st["counters"].get(SPAN):
        return None
    return 1e6 * st["clocks"][SPAN] / st["counters"][SPAN]
