"""The share of the profiled half of the window in which no kernel, copy
or memset ran on the card (torch.profiler's trace: one minus the union
of the device intervals over the window span)."""

UNIT = "%"
LAYER = "device"
MOVES = "device_s_per_gbase"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
