"""The share of the map_batch passes whose result the host collected
before its copy to the host had ended (``graphs.DISPATCHES["waited"]``,
counted by ``unpack_batch``) over the passes (batches plus dense reruns),
in the profiled half of the window, where no StageTimer makes a replay
wait: near 0, the lookahead of four dispatches never lets the card pace
the host."""

UNIT = "%"
LAYER = "Mapper (pipeline/map_read.py::Mapper, pipeline/select.py)"
MOVES = "device_s_per_gbase"


def read(ctx):
    prof = ctx.get("profiled")
    if not prof or "waited" not in prof["dispatches"]:
        return None
    d = prof["dispatches"]
    passes = d["batches"] + d["dense_reruns"]
    return 100.0 * d["waited"] / passes if passes else None
