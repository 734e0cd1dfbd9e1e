"""Spawned ranks of the port's multi-device mapping (``dist/mesh.py``), for
tests/test_torch_dist.py (CPU, against JAX) and tests/test_torch_cuda.py
(the card against the CPU).

    python tests/torch_dist_rank.py JOB.json RANK

Joins a gloo process group of ``JOB["world"]`` ranks at
``tcp://localhost:JOB["port"]`` and runs each case of ``JOB["cases"]`` in
order, on the case's ``device`` (default ``JOB["device"]``): ``"ref"``
calls ``map_batch_ref_sharded`` on a ``(n_data, n_ref)`` mesh over the
world's genome, ``"data"`` calls ``map_batch_data_parallel`` against the
replicated index.  The world is rebuilt from its seeds
(``random_genome(glen, seed=gseed)``, k = 12); the reads, lengths, matrix
and gap costs come from the case's ``.npz``.  Each case's output goes to
``<out>/<name>.rank<RANK>.npz``: ``ints``, ``ops``, ``clusters``, ``flat``,
``launches`` (the case's kernel launches, ``cuda_ops.LAUNCHES`` as JSON)
and, for ``"ref"``, ``offs`` and ``n_dp``.  A rank imports neither JAX
nor the JAX package; :func:`start_ranks` and :func:`finish_ranks` spawn
and collect the ranks.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from torch_shared import TORCH_THREADS

HERE = os.path.dirname(os.path.abspath(__file__))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(tmp, cases, world=2, device="cpu"):
    """Start ``cases`` in ``world`` ranks; :func:`finish_ranks` waits."""
    job = dict(world=world, port=free_port(), device=device, out=str(tmp),
               cases=cases)
    path = os.path.join(tmp, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS=str(TORCH_THREADS))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), path, str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(world)], job


def finish_ranks(started, timeout=600):
    """{case name: [rank 0's outputs, rank 1's, ...]} once every rank
    ended with 0; a rank still running at ``timeout`` is killed."""
    procs, job = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {c["name"]: [dict(np.load(os.path.join(
        job["out"], f"{c['name']}.rank{r}.npz"))) for r in range(len(procs))]
        for c in job["cases"]}


def main(job_path: str, rank: int) -> int:
    import torch
    import torch.distributed as dist
    from blasr_tpu_torch.dist.mesh import (
        make_mesh, map_batch_data_parallel, map_batch_ref_sharded)
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.kernels import cuda_ops
    from blasr_tpu_torch.pipeline.map_read import DeviceIndex
    from blasr_tpu_torch.sim import random_genome

    torch.set_num_threads(TORCH_THREADS)
    with open(job_path) as f:
        job = json.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{job['port']}", rank=rank,
                            world_size=job["world"])
    try:
        worlds = {}
        for case in job["cases"]:
            key = (case["glen"], case["gseed"])
            if key not in worlds:
                worlds[key] = build_genome_index(
                    random_genome(case["glen"], seed=case["gseed"]), k=12)
            gi = worlds[key]
            device = case.get("device", job["device"])
            inp = np.load(case["inputs"])
            mesh = make_mesh(case["n_data"], case["n_ref"], device=device)
            args = (inp["reads"], inp["lens"], inp["submat"], inp["gaps"])
            cuda_ops.reset_launch_counts()
            extra = {}
            if case["kind"] == "ref":
                out, offs, n_dp = map_batch_ref_sharded(
                    mesh, gi, *args, **case["static"])
                extra = dict(offs=offs, n_dp=np.int64(n_dp))
            else:
                index = DeviceIndex.from_host(gi, device)
                out = map_batch_data_parallel(mesh, index, *args,
                                              **case["static"])
            np.savez(os.path.join(job["out"], f"{case['name']}.rank{rank}"),
                     ints=out.ints.cpu().numpy(), ops=out.ops.cpu().numpy(),
                     clusters=out.clusters.cpu().numpy(),
                     flat=out.flat.cpu().numpy(),
                     launches=np.asarray(json.dumps(cuda_ops.LAUNCHES)),
                     **extra)
    finally:
        dist.destroy_process_group()
    assert "jax" not in sys.modules or sys.modules["jax"] is None
    assert not [m for m in sys.modules if m.startswith("blasr_tpu.")]
    return 0


if __name__ == "__main__":
    sys.modules["jax"] = None
    sys.modules["blasr_tpu"] = None
    sys.path.insert(0, os.path.dirname(HERE))
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
