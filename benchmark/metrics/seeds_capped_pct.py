"""The share of the valid read seeds (k-mers) whose occurrences outnumber
``occ_per_pos``, so that the anchor search samples them (the port's
``MappingMetrics`` counters ``anchor_capped`` over ``anchor_seeds``,
each reduced on the card into the batch's result), in the StageTimer
half of the window."""

UNIT = "%"
LAYER = "anchors (K5, kernels/anchor.py)"
MOVES = "device_s_per_gbase"


def read(ctx):
    st = ctx.get("staged")
    if not st or not st["counters"].get("anchor_seeds"):
        return None
    c = st["counters"]
    return 100.0 * c.get("anchor_capped", 0) / c["anchor_seeds"]
