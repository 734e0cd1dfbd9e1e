# Copied from blasr_tpu/dist/multihost.py; init_distributed reads the
# torch.distributed launcher's variables where the original starts
# jax.distributed, and run_sharded runs the port's CLI.
"""Multi-host orchestration: input sharding, deterministic merge.

Replacement for the reference's cross-node story (SURVEY.md §2.9):
``--start/--stride`` independent processes (RegisterBlasrOptions.h:93-94)
become per-host read shards, and the semaphore-serialized single output
stream (BlasrUtilsImpl.hpp:1020-1026) becomes per-host output files plus a
deterministic merge keyed by input order — byte-identical regardless of
host count, the property the reference's determinism tests check
(ctest/hitpolicy.t, ctest/deterministic.t).

Works in three modes:
  * single process (world = 1): passthrough;
  * a torch.distributed launch (``torchrun`` and the like):
    ``init_distributed()`` reads its ``WORLD_SIZE`` / ``RANK``;
  * any launcher that sets BLASR_TPU_NUM_HOSTS / BLASR_TPU_HOST_ID
    (including plain multi-process CPU runs, used by the tests).
No process group is needed: hosts meet at sentinel files.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple


def _use_launcher_card() -> None:
    """Make ``cuda`` the card a torch.distributed launcher gave this
    process (``LOCAL_RANK``: one process a card, as ``torchrun
    --nproc_per_node`` starts them), where the host has CUDA."""
    import torch
    local = os.environ.get("LOCAL_RANK")
    if local is not None and torch.cuda.is_available():
        torch.cuda.set_device(int(local))


def init_distributed() -> Tuple[int, int]:
    """(host_id, n_hosts): the BLASR_TPU_* overrides, else the rank and
    world size a torch.distributed launcher set (``WORLD_SIZE``, ``RANK``
    beside ``MASTER_ADDR``; its ``LOCAL_RANK`` then picks this process's
    card) or an initialised default process group holds, else (0, 1).
    Starts no process group."""
    if "BLASR_TPU_NUM_HOSTS" in os.environ:
        return (int(os.environ.get("BLASR_TPU_HOST_ID", "0")),
                int(os.environ["BLASR_TPU_NUM_HOSTS"]))
    if all(v in os.environ for v in ("WORLD_SIZE", "MASTER_ADDR")):
        _use_launcher_card()
        return int(os.environ.get("RANK", "0")), int(os.environ["WORLD_SIZE"])
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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


def merge_outputs(out_path: str, n_hosts: int,
                  keys_per_host: Sequence[Sequence[int]],
                  remove_parts: bool = True) -> None:
    """Merge per-host outputs into out_path, ordered by original read
    index.  Each host's file must contain one *record group* per mapped
    read, prefixed by '#@<read_index>' marker lines written by
    emit_with_markers (stripped on merge)."""
    groups = {}
    header = ""
    for h in range(n_hosts):
        part = shard_path(out_path, h, n_hosts)
        cur: Optional[int] = None
        buf: List[str] = []
        pre: List[str] = []
        with open(part) as f:
            for line in f:
                if line.startswith("#@"):
                    if cur is not None:
                        groups[cur] = "".join(buf)
                    cur = int(line[2:].strip())
                    buf = []
                elif cur is None:
                    pre.append(line)     # header lines before any marker
                else:
                    buf.append(line)
            if cur is not None:
                groups[cur] = "".join(buf)
        if h == 0:
            header = "".join(pre)
        if remove_parts:
            os.remove(part)
    with open(out_path, "w") as out:
        out.write(header)
        for idx in sorted(groups):
            out.write(groups[idx])


def _out_path_of(argv: Sequence[str]) -> Optional[str]:
    for i, a in enumerate(argv):
        if a in ("--out", "-o") and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--out="):
            return a.split("=", 1)[1]
    return None


def run_sharded(argv: List[str], barrier_timeout: float = 3600.0) -> int:
    """Entry point used by each host of a multi-host launch: run the
    port's CLI on this host's read shard; after all hosts finish
    (sentinel-file barrier, which needs no process group), host 0 merges
    the part files into the final output."""
    import time

    host_id, n_hosts = init_distributed()
    os.environ["BLASR_TPU_HOST_ID"] = str(host_id)
    os.environ["BLASR_TPU_NUM_HOSTS"] = str(n_hosts)
    from blasr_tpu_torch.cli.blasr import run
    rc = run(argv)
    out_path = _out_path_of(argv)
    if n_hosts <= 1 or out_path in (None, "-"):
        return rc
    if any(f in argv for f in ("--bam",)):
        return rc  # BAM parts are left per-host (binary merge is external)
    done = shard_path(out_path, host_id, n_hosts) + ".done"
    with open(done, "w") as f:
        f.write(str(rc))
    if host_id != 0:
        return rc
    # host 0: wait for every host's sentinel, then merge + clean up
    deadline = time.time() + barrier_timeout
    sentinels = [shard_path(out_path, h, n_hosts) + ".done"
                 for h in range(n_hosts)]
    while not all(os.path.exists(s) for s in sentinels):
        if time.time() > deadline:
            raise TimeoutError(
                f"run_sharded: hosts not finished after {barrier_timeout}s")
        time.sleep(0.2)
    merge_outputs(out_path, n_hosts, [])
    for s in sentinels:
        os.remove(s)
    return rc
