"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded through ``ctypes`` (no PyTorch headers, so the build
takes seconds).  The library is built at first use, from the package's
own sources, into ``build/blasr_tpu_torch/`` beside the package; its file
name carries a hash of the sources and flags, so an edited source
rebuilds.

Every wrapper checks device, dtype, shape and contiguity, launches on
``torch.cuda.current_stream()``, raises if ``cudaGetLastError()`` is not 0
and counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from blasr_tpu_torch.kernels.banded import (BandedResult, TracebackResult,
                                            pair_capacity)

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
SOURCES = ("banded_dp.cu", "banded_traceback.cu")
BUILD_DIR = _PKG_DIR.parent / "build" / "blasr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches since the last reset, one entry per wrapper
LAUNCHES = {"banded_dp": 0, "banded_dp_qv": 0, "banded_traceback": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "blasr_tpu_torch are built with the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libblasr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing; return its path.  The compiler's register/spill report is kept
    next to it as ``<lib>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(SRC_DIR / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    Path(str(lib) + ".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    p = Path(str(library_path()) + ".log")
    return p.read_text() if p.exists() else ""


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.blasr_banded_dp.restype = I
            lib.blasr_banded_dp.argtypes = (
                [P] * 7 + [I] * 3 + [F] * 6 + [P] * 4 + [P])
            lib.blasr_banded_dp_qv.restype = I
            lib.blasr_banded_dp_qv.argtypes = (
                [P] * 9 + [I] * 3 + [F] + [P] * 4 + [P])
            lib.blasr_banded_traceback.restype = I
            lib.blasr_banded_traceback.argtypes = (
                [P] * 8 + [I] * 3 + [P] * 7 + [P])
            _lib = lib
        return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launched(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def banded_dp_launch(reads, windows, offsets, qa, qb, ta, tb, *,
                     match: float, mismatch: float, ins_open: float,
                     ins_ext: float, del_open: float, del_ext: float,
                     qv1=None, qv2=None) -> BandedResult:
    """K1 on CUDA tensors: reads/windows int8 [N, L]/[N, W], offsets int32
    [N, L] (slope 0..2 per active row), qa..tb int32 [N].  With qv1/qv2
    (int32 [N, L] packed QV tracks) it launches K1-QV, which takes its
    costs from the tracks and only ``match`` from the arguments."""
    dev = reads.device
    if dev.type != "cuda":
        raise ValueError("banded_dp_launch needs CUDA tensors")
    N, L = reads.shape
    W = windows.shape[1]
    _check(reads, "reads", torch.int8, (N, L), dev)
    _check(windows, "windows", torch.int8, (N, W), dev)
    _check(offsets, "offsets", torch.int32, (N, L), dev)
    for name, x in (("qa", qa), ("qb", qb), ("ta", ta), ("tb", tb)):
        _check(x, name, torch.int32, (N,), dev)
    use_qv = qv1 is not None or qv2 is not None
    if use_qv:
        if qv1 is None or qv2 is None:
            raise ValueError("K1-QV needs both qv1 and qv2")
        _check(qv1, "qv1", torch.int32, (N, L), dev)
        _check(qv2, "qv2", torch.int32, (N, L), dev)
    score = torch.empty(N, dtype=torch.float32, device=dev)
    tbbits = torch.empty((N, L, 128), dtype=torch.int32, device=dev)
    state = torch.empty(N, dtype=torch.int32, device=dev)
    valid = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return BandedResult(score, tbbits, state, valid)
    lib = _load()
    outs = (score.data_ptr(), tbbits.data_ptr(), state.data_ptr(),
            valid.data_ptr())
    ins = (reads.data_ptr(), windows.data_ptr(), offsets.data_ptr(),
           qa.data_ptr(), qb.data_ptr(), ta.data_ptr(), tb.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if use_qv:
            rc = lib.blasr_banded_dp_qv(
                *ins, qv1.data_ptr(), qv2.data_ptr(), N, L, W, float(match),
                *outs, stream)
        else:
            rc = lib.blasr_banded_dp(
                *ins, N, L, W, float(match), float(mismatch),
                float(ins_open), float(ins_ext), float(del_open),
                float(del_ext), *outs, stream)
    key = "banded_dp_qv" if use_qv else "banded_dp"
    _launched(rc, key)
    LAUNCHES[key] += 1
    return BandedResult(score, tbbits, state, valid)


def banded_traceback_cuda(result: BandedResult, offsets, qa, qb, ta, tb, *,
                          t_max: int, w_b: int = 128) -> TracebackResult:
    """K2 on CUDA tensors (same contract as ``banded_traceback_plain``)."""
    tbb = result.tbbits
    dev = tbb.device
    if dev.type != "cuda":
        raise ValueError("banded_traceback_cuda needs CUDA tensors")
    if w_b != 128:
        raise ValueError("the CUDA traceback walks 128-cell bands")
    N, L, _ = tbb.shape
    _check(tbb, "tbbits", torch.int32, (N, L, 128), dev)
    _check(offsets, "offsets", torch.int32, (N, L), dev)
    for name, x in (("qa", qa), ("qb", qb), ("ta", ta), ("tb", tb),
                    ("final_state", result.final_state)):
        _check(x, name, torch.int32, (N,), dev)
    _check(result.valid, "valid", torch.bool, (N,), dev)
    P = pair_capacity(t_max)
    pairs = torch.zeros((N, P // 2), dtype=torch.int32, device=dev)
    counts = torch.empty((5, N), dtype=torch.int32, device=dev)
    overflow = torch.empty(N, dtype=torch.bool, device=dev)
    if N > 0:
        lib = _load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.blasr_banded_traceback(
                tbb.data_ptr(), offsets.data_ptr(), qa.data_ptr(),
                qb.data_ptr(), ta.data_ptr(), tb.data_ptr(),
                result.final_state.data_ptr(), result.valid.data_ptr(),
                N, L, P, pairs.data_ptr(), counts[0].data_ptr(),
                counts[1].data_ptr(), counts[2].data_ptr(),
                counts[3].data_ptr(), counts[4].data_ptr(),
                overflow.data_ptr(), stream)
        _launched(rc, "banded_traceback")
        LAUNCHES["banded_traceback"] += 1
    return TracebackResult(pairs=pairs, n_pairs=counts[0],
                           n_match=counts[1], n_mismatch=counts[2],
                           n_ins=counts[3], n_del=counts[4],
                           overflow=overflow)
