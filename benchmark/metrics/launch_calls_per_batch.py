"""CUDA runtime calls the host made in the profiled half of the window
(kernel and graph launches, copies, memsets: ``devtrace.RUNTIME_CALLS``)
over the map_batch passes it dispatched (``graphs.DISPATCHES`` batches
plus dense reruns)."""

UNIT = "calls/batch"
LAYER = "graphs (pipeline/graphs.py)"
MOVES = "device_s_per_gbase"


def read(ctx):
    tr, prof = ctx.get("trace"), ctx.get("profiled")
    if tr is None or prof is None or tr.runtime_calls == 0:
        return None
    d = prof["dispatches"]
    passes = d["batches"] + d["dense_reruns"]
    return tr.runtime_calls / passes if passes else None
