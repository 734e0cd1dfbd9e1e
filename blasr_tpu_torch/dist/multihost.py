# Copied from blasr_tpu/dist/multihost.py (shard_reads and shard_path
# only); the JAX multi-host launcher is not ported.
"""Read sharding across hosts (round-robin, composed with --start/--stride)."""

from __future__ import annotations

from typing import List


def shard_reads(n_reads: int, host_id: int, n_hosts: int,
                start: int = 0, stride: int = 1) -> List[int]:
    """Read indices this host maps: the --start/--stride slice composed
    with round-robin host sharding (deterministic, balanced for the
    length-sorted streams PacBio movies produce)."""
    mine = range(start, n_reads, max(1, stride))
    return [i for k, i in enumerate(mine) if k % n_hosts == host_id]


def shard_path(out_path: str, host_id: int, n_hosts: int) -> str:
    """Per-host output file name (reference --outputByThread analog,
    Blasr.cpp:1476-1483)."""
    if n_hosts == 1:
        return out_path
    return f"{out_path}.host{host_id:04d}"
