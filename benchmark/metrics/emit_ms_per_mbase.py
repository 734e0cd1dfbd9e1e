"""The CLI's output of a call's alignments (``cli/blasr.py::emit``:
``store_map_qvs``, each read's mapQVs from its overlapping placements
rescored by likelihood, ``select_alignments``, the hit policy, and the
m1 lines written) per million read bases, by the benchmark's host clock
around it, in the StageTimer half of the window."""

UNIT = "ms/Mbase"
LAYER = "CLI output (cli/blasr.py::emit, pipeline/select.py, io/formats.py)"
MOVES = "device_s_per_gbase"


def read(ctx):
    st = ctx.get("staged")
    if not st or not st["bases"] or "emit_s" not in st:
        return None
    return 1e3 * st["emit_s"] / (st["bases"] / 1e6)
