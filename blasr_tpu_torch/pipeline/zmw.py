# Copied from blasr_tpu/pipeline/zmw.py (zmw_key, subread_interval and
# group_by_zmw only); concordant and CCS mapping are not ported.
"""ZMW / subread grouping helpers used by the CLI's output pass."""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from blasr_tpu_torch.io.fasta import FastaRecord

_SUBREAD_RE = re.compile(r"^(.+)/(\d+)/(\d+)_(\d+)$")
_ZMW_RE = re.compile(r"^(.+)/(\d+)$")


def zmw_key(qname: str) -> str:
    """movie/holeNumber prefix identifying the ZMW, or the full name."""
    if qname.endswith("/ccs"):           # CCS read naming convention
        qname = qname[: -len("/ccs")]
    m = _SUBREAD_RE.match(qname)
    if m:
        return f"{m.group(1)}/{m.group(2)}"
    m = _ZMW_RE.match(qname)
    if m:
        return f"{m.group(1)}/{m.group(2)}"
    return qname


def subread_interval(qname: str) -> Optional[Tuple[int, int]]:
    m = _SUBREAD_RE.match(qname)
    if m:
        return int(m.group(3)), int(m.group(4))
    return None


def group_by_zmw(recs: Sequence[FastaRecord]) -> List[List[int]]:
    """Indices grouped by ZMW, preserving input order."""
    groups: Dict[str, List[int]] = {}
    order: List[str] = []
    for i, r in enumerate(recs):
        k = zmw_key(r.name)
        if k not in groups:
            order.append(k)
            groups[k] = []
        groups[k].append(i)
    return [groups[k] for k in order]
