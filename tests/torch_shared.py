"""A test world built once per pytest run, whatever the distribution.

Under ``pytest-xdist``'s ``--dist load`` the items of one test file land
on several workers, and a ``scope="module"`` fixture then builds its world
once on every worker that runs one of them.  :func:`shared` builds it once
per run instead, as xdist documents for a fixture run once a session: the
world lives in a directory under ``tmp_path_factory.getbasetemp().parent``,
which every worker of one run shares; a lock (``fcntl.flock``) guards the
build; the first worker to ask builds the world, pickles what it returns
and renames the pickle into place; the others wait on the lock, then read
it.  Without xdist the run's own base directory holds it, so a second call
in the same process reads it back too.

A world is keyed by its test file and its name, so two worlds never share
a directory.

``TORCH_THREADS`` is the intra-op thread count of every port test process
(each file that runs the plain PyTorch kernels sets it, and so do the
processes the tests spawn): the tier-1 command runs six xdist workers,
each beside XLA's own threads, so one thread a worker keeps a machine of
a few cores from oversubscribing."""

import fcntl
import os
import pickle
import shutil
from pathlib import Path

TORCH_THREADS = 1


def _root(tmp_path_factory) -> Path:
    base = tmp_path_factory.getbasetemp()
    # an xdist worker's base is <the run's directory>/popen-gw<N>
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    root = root / "torch_shared"
    root.mkdir(exist_ok=True)
    return root


def shared(tmp_path_factory, test_file: str, name: str, build):
    """``build(directory)``'s value, built once per run: the first caller
    builds it into a fresh directory of its own (which stays, for the
    files a world writes) and pickles the value; every other caller, on
    any worker, unpickles it.  ``name`` tells a file's worlds apart (a
    golden world's own name, say).  A build that raises writes no pickle,
    so the next caller builds again (and fails the same way)."""
    root = _root(tmp_path_factory)
    key = f"{Path(test_file).stem}.{name}"
    pkl = root / f"{key}.pkl"
    with open(root / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not pkl.exists():
                d = root / key
                shutil.rmtree(d, ignore_errors=True)
                d.mkdir()
                value = build(d)
                tmp = root / f"{key}.pkl.tmp"
                with open(tmp, "wb") as f:
                    pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
                os.replace(tmp, pkl)
                return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with open(pkl, "rb") as f:
        return pickle.load(f)
