"""The query rows the banded DP's valid items need (``MappingMetrics``
counter ``dp_rows_used``: the sum of qb - qa over each batch's valid DP
items, reduced on the card into the batch's result) over the rows K1
stores and steps through (``dp_rows_stored``: n_dp x L a pass, from the
graph's static shape), in the StageTimer half of the window: the ceiling
of what storing only the needed rows could save."""

UNIT = "%"
LAYER = "banded DP (K1 family, kernels/banded.py, kernels/cuda_ops.py)"
MOVES = "device_s_per_gbase"


def read(ctx):
    st = ctx.get("staged")
    if not st or not st["counters"].get("dp_rows_stored"):
        return None
    c = st["counters"]
    return 100.0 * c.get("dp_rows_used", 0) / c["dp_rows_stored"]
