# Copied from blasr_tpu/io/fofn.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""File-of-file-names expansion (reference FileOfFileNames::ExpandFileNameList,
used by MappingParameters::MakeSane)."""

from __future__ import annotations

import os
from typing import List


def expand_fofn(path: str) -> List[str]:
    out: List[str] = []
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if not os.path.isabs(line):
                line = os.path.join(base, line)
            out.append(line)
    return out


def expand_file_name_list(names: List[str]) -> List[str]:
    out: List[str] = []
    for n in names:
        if n.lower().endswith(".fofn"):
            out.extend(expand_fofn(n))
        else:
            out.append(n)
    return out
