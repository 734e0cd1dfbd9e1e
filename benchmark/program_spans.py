"""What the readers of the program's own spans share: a host span (a
``MappingMetrics`` clock of the port) or a ``StageTimer`` part (device
time) per million read bases mapped in the StageTimer half of the
window, or None where the run has no such span or part (a program
without it)."""

from __future__ import annotations

from typing import Optional


def span_ms_per_mbase(ctx: dict, span: str) -> Optional[float]:
    st = ctx.get("staged")
    if not st or not st["bases"] or span not in st["clocks"]:
        return None
    return 1e3 * st["clocks"][span] / (st["bases"] / 1e6)


def part_ms_per_mbase(ctx: dict, part: str) -> Optional[float]:
    st = ctx.get("staged")
    if not st or not st["bases"] or not st["stages_ms"].get(part):
        return None
    return st["stages_ms"][part] / (st["bases"] / 1e6)
