"""The anchor search's share of its roofline: the least time the card
could take for K5's bytes (``roofline/anchors.py``: a 32-byte sector for
each valid seed's lookup and for each occurrence it examines, its read
base, and the anchors kept, from the port's ``MappingMetrics`` counters
``anchor_seeds``, ``anchor_examined`` and ``anchor_kept``) over 3.35
TB/s, against the ``anchors`` stage's device time, both over the
StageTimer half of the window."""

from benchmark.roofline import anchors

UNIT = "%"
LAYER = "anchors (K5, kernels/anchor.py)"
MOVES = "device_s_per_gbase"


def read(ctx):
    st, peak = ctx.get("staged"), ctx.get("peaks")
    if not st or peak is None:
        return None
    ms = st["stages_ms"].get("anchors", 0.0)
    return anchors.roofline_pct(st["counters"], ms / 1e3, peak)
