# Copied from blasr_tpu/io/dataset.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""PacBio DataSet XML input (PBDATASET file type).

Reference parity: BLASR accepts dataset XMLs whose ExternalResources point
at BAM/movie files and whose Filters restrict records
(FileType PBDATASET, MappingParameters.h:406-415; filter honoring tested
by ctest/dataset.t).  Supported filter properties: ``zm`` (hole number),
``length``/``qlen``, ``rq`` (read quality), ``qname`` — with operators
==, !=, <, <=, >, >=, and bracketed zm set/range values like
``[0,1,2]`` / ``[0-7]``.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from blasr_tpu_torch.io.fasta import FastaRecord


@dataclass
class DatasetFilter:
    name: str
    op: str
    value: str

    def predicate(self) -> Callable[[FastaRecord], bool]:
        name, op, raw = self.name, self.op, self.value

        def hole(rec: FastaRecord) -> Optional[int]:
            parts = rec.name.split("/")
            return int(parts[1]) if len(parts) >= 2 and parts[1].isdigit() \
                else None

        def field(rec: FastaRecord):
            if name == "zm":
                return hole(rec)
            if name in ("length", "qlen"):
                return len(rec.seq)
            if name == "rq":
                if rec.qual is None or not len(rec.qual):
                    return None
                return 1.0 - 10.0 ** (-float(np.mean(rec.qual)) / 10.0)
            if name == "qname":
                return rec.name
            return None

        if raw.startswith("["):
            items = re.split(r"[,;]", raw.strip("[]"))
            values: List[int] = []
            ranges: List[tuple] = []
            for it in items:
                it = it.strip()
                if "-" in it and not it.startswith("-"):
                    a, b = it.split("-", 1)
                    ranges.append((int(a), int(b)))
                elif it:
                    values.append(int(it))

            def pred(rec: FastaRecord) -> bool:
                v = field(rec)
                if v is None:
                    return False
                return v in values or any(a <= v <= b for a, b in ranges)
            return pred

        def pred(rec: FastaRecord) -> bool:
            v = field(rec)
            if v is None:
                return False
            try:
                w = type(v)(raw) if not isinstance(v, str) else raw
            except ValueError:
                return False
            return {"==": v == w, "=": v == w, "!=": v != w,
                    "<": v < w, "<=": v <= w,
                    ">": v > w, ">=": v >= w}.get(op, False)
        return pred


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_dataset(path: str):
    """(resource_paths, filters) from a dataset XML."""
    tree = ET.parse(path)
    root = tree.getroot()
    base = os.path.dirname(os.path.abspath(path))
    resources: List[str] = []
    filters: List[DatasetFilter] = []
    for el in root.iter():
        tag = _local(el.tag)
        if tag == "ExternalResource":
            rid = el.attrib.get("ResourceId", "")
            if rid and not rid.endswith((".pbi", ".xml")):
                p = rid if os.path.isabs(rid) else os.path.join(base, rid)
                resources.append(p)
        elif tag == "Property":
            name = el.attrib.get("Name", "").lower()
            op = el.attrib.get("Operator", "==").strip()
            val = el.attrib.get("Value", "")
            if name:
                filters.append(DatasetFilter(name, op, val))
    return resources, filters


def read_dataset(path: str) -> List[FastaRecord]:
    """Read all records of a dataset XML, honoring its filters."""
    from blasr_tpu_torch.io.fasta import read_sequences
    resources, filters = parse_dataset(path)
    preds = [f.predicate() for f in filters]
    out: List[FastaRecord] = []
    for res in resources:
        for rec in read_sequences(res):
            if all(p(rec) for p in preds):
                out.append(rec)
    return out
