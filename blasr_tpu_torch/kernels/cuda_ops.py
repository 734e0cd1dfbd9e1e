"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc``, one process per source, all at once,
and link into one shared library with a plain C interface, loaded through
``ctypes`` (no PyTorch headers, so the build takes seconds).  The library
is built at first use, from the package's own sources, into
``build/blasr_tpu_torch/`` beside the package; its file name carries a
hash of the sources, the headers they share and the flags, so an edited
source rebuilds.

Every wrapper checks device, dtype, shape and contiguity, launches on
``torch.cuda.current_stream()``, raises if ``cudaGetLastError()`` is not 0
and counts its launches in :data:`LAUNCHES`.  No launch sets a function
attribute: :func:`_load` sets every kernel's (``blasr_setup_kernels``)
once per device before the first launch there, so a launch is all a
CUDA graph capture records (``pipeline/graphs.py``).
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

import numpy as np
import torch

from blasr_tpu_torch.kernels.anchor import Anchors
from blasr_tpu_torch.kernels.banded import (BandedResult, TracebackResult,
                                            pair_capacity)
from blasr_tpu_torch.kernels.chain import Candidates

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
SOURCES = ("banded_dp.cu", "banded_traceback.cu", "chain_scan.cu",
           "sdp_window.cu", "anchor_search.cu", "band_offsets.cu",
           "chain_members.cu", "banded_dp_wide.cu",
           "banded_traceback_wide.cu", "setup.cu")
HEADERS = ("block_scan.cuh", "setup.cuh", "chain_members_plan.h")
BUILD_DIR = _PKG_DIR.parent / "build" / "blasr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches since the last reset, one entry per wrapper
LAUNCHES = {"banded_dp": 0, "banded_dp_qv": 0, "banded_dp_hp": 0,
            "banded_dp_gen": 0, "banded_dp_hp_gen": 0, "banded_dp_qv_gen": 0,
            "banded_traceback": 0, "chain_scan": 0, "sdp_window": 0,
            "anchor_search": 0, "anchor_search_block": 0, "band_offsets": 0,
            "chain_members": 0, "banded_dp_w": 0, "banded_dp_w_qv": 0,
            "banded_dp_w_hp": 0, "banded_dp_w_gen": 0,
            "banded_dp_w_hp_gen": 0, "banded_dp_w_qv_gen": 0,
            "banded_traceback_w": 0}
# K2 and K2-W launches given an index of the DP rows to walk (``rows``)
# since the last reset, graph replays included
INDEXED_WALKS = 0
# the band width of K1 and K2; K1-W and K2-W take every other one
K1_WIDTH = 128
# K7's calls by path since the last reset (csrc/chain_members_plan.h):
# "lift" (the shared path: the lifting table in shared memory, one CTA a
# row), "chase" (a warp a chain over the row's parents staged in shared
# memory) or "global" (the chase over parents in global memory)
MEMBER_PATHS = {"lift": 0, "chase": 0, "global": 0}
# MEMBER_PATHS' key of each stage of blasr_chain_members
MEMBER_STAGES = ("global", "chase", "lift")

# shared memory a block may opt into on sm_90 (227 KB), less a margin for
# the kernels' static arrays; K3 keeps 42 bytes per anchor there (above
# CHAIN_MAX_ANCHORS in a global scratch row instead), K4 a tile's slab
# keys and window bytes (csrc/sdp_window.cu sizes them)
SMEM_OPTIN = 232448 - 1024
CHAIN_SMEM_PER_ANCHOR = 42
CHAIN_MAX_ANCHORS = SMEM_OPTIN // CHAIN_SMEM_PER_ANCHOR
# K6 keeps an item's rows in shared memory up to this many, above in a
# global scratch of two int32 rows an item (csrc/band_offsets.cu)
BAND_SMEM_ROWS = 8192
# K5's selection CTA: its static shared arrays, and the largest A it sorts
ANCHOR_SELECT_STATIC = 8 * 1024 + 8 * 32 + 4 * 512 + 64
ANCHOR_MAX_SELECT = 16384

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# (library, device index) pairs whose kernels' attributes are set
_set_up: set = set()


def reset_launch_counts() -> None:
    global INDEXED_WALKS
    INDEXED_WALKS = 0
    for counts in (LAUNCHES, MEMBER_PATHS):
        for k in counts:
            counts[k] = 0


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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libblasr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing; return its path.  Each source compiles in its own ``nvcc``
    process, all started together, then one ``nvcc -shared`` links them.
    The compilers' register/spill reports are kept next to the library as
    ``<lib>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    objs = [tmp.with_suffix(f".{Path(s).stem}.o") for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(SRC_DIR / s), "-o", str(o)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    runs = []
    for c, p in zip(cmds, procs):
        out, err = p.communicate()
        runs.append((c, p.returncode, out, err))
    if all(rc == 0 for _, rc, _, _ in runs):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, res.returncode, res.stdout, res.stderr))
    for o in objs:
        o.unlink(missing_ok=True)
    text = "".join(" ".join(c) + "\n" + out + err for c, _, out, err in runs)
    Path(str(lib) + ".log").write_text(text)
    failed = [rc for _, rc, _, _ in runs if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{text}")
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    p = Path(str(library_path()) + ".log")
    return p.read_text() if p.exists() else ""


_P, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
# each C entry point: (restype, argtypes)
ARGTYPES = {
    "blasr_banded_dp": (_I, [_P] * 7 + [_I] * 3 + [_F] * 6 + [_P] * 4 + [_P]),
    "blasr_banded_dp_qv": (_I, [_P] * 9 + [_I] * 3 + [_F] + [_P] * 4 + [_P]),
    "blasr_banded_dp_mode": (_I, [_P] * 9 + [_I] * 5 + [_P] + [_F] * 8
                             + [_P] * 4 + [_P]),
    "blasr_banded_traceback": (_I, [_P] * 9 + [_I] * 3 + [_P] * 7 + [_P]),
    "blasr_banded_dp_wide": (_I, [_P] * 9 + [_I] * 6 + [_P] + [_F] * 8
                             + [_P] * 5 + [_P]),
    "blasr_banded_dp_wide_ws_bytes": (ctypes.c_size_t, [_I]),
    "blasr_banded_dp_wide_max_smem": (_I, []),
    "blasr_banded_traceback_wide": (_I, [_P] * 9 + [_I] * 4 + [_P] * 7
                                    + [_P]),
    "blasr_banded_traceback_wide_plan": (_I, [_I]),
    "blasr_chain_scan": (_I, [_P] * 3 + [_I] + [_P] * 3 + [_I] * 5
                         + [_F] * 3 + [_I, _F, _I, _I] + [_P] * 10
                         + [_P, _LL] + [_P]),
    "blasr_sdp_window": (_I, [_P] * 4 + [_I, _P] + [_I] * 8 + [_P] * 2
                         + [_P]),
    "blasr_sdp_window_smem": (ctypes.c_size_t, [_I] * 3),
    "blasr_anchor_search": (_I, [_P] * 10 + [_LL] * 2 + [_I] * 8 + [_LL]
                            + [_I] * 5 + [_F] + [_P] * 14 + [_P]),
    "blasr_anchor_search_block": (_I, [_P] * 10 + [_LL] * 2 + [_I] * 8
                                  + [_LL] + [_I] * 5 + [_F] + [_P] * 14
                                  + [_P] + [_LL]),
    "blasr_band_offsets": (_I, [_P] * 5 + [_I] * 7 + [_P] * 2 + [_P]),
    "blasr_chain_members": (_I, [_P] * 3 + [_I] + [_P] * 2 + [_I] * 6
                            + [_P] * 4 + [_P]),
    "blasr_chain_members_smem": (ctypes.c_size_t, [_I] * 4),
    "blasr_chain_members_max_smem": (_I, []),
    "blasr_chain_members_plan": (_I, [_I] * 3 + [_P]),
}
# each kernel source's own set-up entry (what setup.cu's
# blasr_setup_kernels runs for it), for a source built alone
SETUP_ENTRIES = tuple(f"blasr_{Path(s).stem}_setup" for s in SOURCES
                      if s != "setup.cu")


def bind(lib: ctypes.CDLL, names=tuple(ARGTYPES)) -> ctypes.CDLL:
    """Set the C signatures of ``names`` on a loaded library."""
    for name in names:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ARGTYPES[name]
    return lib


def set_up(lib: ctypes.CDLL, device=None) -> None:
    """Set the function attributes of ``lib``'s kernels on ``device`` (the
    current device by default), once per library and device: by
    ``blasr_setup_kernels`` where the library has it, else by the
    ``SETUP_ENTRIES`` of the sources built into it (a source built alone;
    a source with none, an older one, sets its attributes itself)."""
    idx = None if device is None else torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if (id(lib), idx) in _set_up:
        return
    names = (["blasr_setup_kernels"] if hasattr(lib, "blasr_setup_kernels")
             else [n for n in SETUP_ENTRIES if hasattr(lib, n)])
    with torch.cuda.device(idx):
        for name in names:
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = _I, []
            rc = fn()
            if rc != 0:
                raise RuntimeError(f"{name}: setting the kernels' attributes "
                                   f"failed with CUDA error {rc}")
    _set_up.add((id(lib), idx))


def _load(device=None) -> ctypes.CDLL:
    """The kernel library, built and loaded at first use, its kernels'
    attributes set on ``device`` (the current device by default)."""
    global _lib
    lib = _lib
    if (lib is not None and device is not None
            and (id(lib), device.index) in _set_up):
        return lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build())))
        set_up(_lib, device)
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


def dp_launch_key(use_qv: bool, use_hp: bool, gen: bool,
                  w_b: int = K1_WIDTH) -> str:
    """The :data:`LAUNCHES` key of a K1 mode: ``banded_dp`` (``banded_dp_w``
    for K1-W, a band width other than 128) with ``_qv``, ``_hp`` and
    ``_gen`` (a general matrix) as they apply."""
    return ("banded_dp" + ("_w" if w_b != K1_WIDTH else "")
            + ("_qv" if use_qv else "") + ("_hp" if use_hp else "")
            + ("_gen" if gen else ""))


def banded_dp_launch(reads, windows, offsets, qa, qb, ta, tb, *,
                     match: float, mismatch: float, ins_open: float,
                     ins_ext: float, del_open: float, del_ext: float,
                     qv1=None, qv2=None, submat=None, use_hp: bool = False,
                     hp_open: float = 0.0, hp_ext: float = 0.0,
                     w_b: int = K1_WIDTH, lib=None) -> BandedResult:
    """K1 on CUDA tensors: reads/windows int8 [N, L]/[N, W], offsets int32
    [N, L] (slope 0..2 per active row), qa..tb int32 [N].  At a band width
    ``w_b`` other than 128 it launches K1-W (``csrc/banded_dp_wide.cu``)
    in the same mode instead, which takes any offsets.  With qv1/qv2
    (int32 [N, L] packed QV tracks) it launches K1-QV, which takes its
    costs from the tracks and only ``match`` from the arguments.
    ``use_hp`` adds the homopolymer-insertion band at ``hp_open`` /
    ``hp_ext`` (K1-HP; not with the QV tracks).  ``submat`` (25 floats on
    the host, read base major) is a general matrix: the GEN form of the
    mode (K1-GEN, K1-HP-GEN, K1-QV-GEN), which takes every substitution
    cost from it instead of ``match`` / ``mismatch``.  Each form counts
    its own launches.  ``lib``: another build of ``banded_dp_wide.cu``
    (``chip_smoke.py --compare K1W``), for K1-W only."""
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
        if use_hp:
            raise ValueError("K1's QV mode has no hp band (linear gaps)")
    gen = submat is not None
    if gen:
        m = np.ascontiguousarray(submat, dtype=np.float32).reshape(-1)
        if m.shape != (25,):
            raise ValueError(f"submat has {m.size} entries, expected 25")
    if w_b < 1:
        raise ValueError(f"band width {w_b}")
    key = dp_launch_key(use_qv, use_hp, gen, w_b)
    score = torch.empty(N, dtype=torch.float32, device=dev)
    tbbits = torch.empty((N, L, w_b), dtype=torch.int32, device=dev)
    state = torch.empty(N, dtype=torch.int32, device=dev)
    valid = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return BandedResult(score, tbbits, state, valid)
    if lib is None:
        lib = _load(dev)
    elif w_b == K1_WIDTH:
        raise ValueError("lib= takes another build of K1-W only")
    else:
        set_up(lib, dev)
    outs = (score.data_ptr(), tbbits.data_ptr(), state.data_ptr(),
            valid.data_ptr())
    ins = (reads.data_ptr(), windows.data_ptr(), offsets.data_ptr(),
           qa.data_ptr(), qb.data_ptr(), ta.data_ptr(), tb.data_ptr())
    scratch = None
    if w_b != K1_WIDTH:
        # K1-W's workspace, in shared memory where it fits
        ws = lib.blasr_banded_dp_wide_ws_bytes(w_b)
        if ws > lib.blasr_banded_dp_wide_max_smem():
            scratch = torch.empty(N * ws, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if w_b != K1_WIDTH:
            rc = lib.blasr_banded_dp_wide(
                *ins, qv1.data_ptr() if use_qv else None,
                qv2.data_ptr() if use_qv else None, N, L, W, w_b,
                int(use_hp), int(gen), m.ctypes.data if gen else None,
                float(match), float(mismatch), float(ins_open),
                float(ins_ext), float(del_open), float(del_ext),
                float(hp_open), float(hp_ext),
                None if scratch is None else scratch.data_ptr(), *outs,
                stream)
        elif use_hp or gen:
            rc = lib.blasr_banded_dp_mode(
                *ins, qv1.data_ptr() if use_qv else None,
                qv2.data_ptr() if use_qv else None, N, L, W, int(use_hp),
                int(gen), m.ctypes.data if gen else None, float(match),
                float(mismatch), float(ins_open), float(ins_ext),
                float(del_open), float(del_ext), float(hp_open),
                float(hp_ext), *outs, stream)
        elif use_qv:
            rc = lib.blasr_banded_dp_qv(
                *ins, qv1.data_ptr(), qv2.data_ptr(), N, L, W, float(match),
                *outs, stream)
        else:
            rc = lib.blasr_banded_dp(
                *ins, N, L, W, float(match), float(mismatch),
                float(ins_open), float(ins_ext), float(del_open),
                float(del_ext), *outs, stream)
    _launched(rc, key)
    LAUNCHES[key] += 1
    return BandedResult(score, tbbits, state, valid)


def banded_traceback_cuda(result: BandedResult, offsets, qa, qb, ta, tb, *,
                          t_max: int, w_b: int = K1_WIDTH, rows=None,
                          lib=None) -> TracebackResult:
    """K2 on CUDA tensors (same contract as ``banded_traceback_plain``); at
    a band width other than 128, K2-W (``csrc/banded_traceback_wide.cu``;
    ``lib``: another build of it, ``chip_smoke.py --compare K2W``).
    ``rows`` (int64 [n], contiguous, each in [0, N_dp)) names the DP rows
    to walk: the kernel reads their cell words and inputs in place, and
    the outputs have n rows; ``None`` walks every row."""
    global INDEXED_WALKS
    tbb = result.tbbits
    dev = tbb.device
    if dev.type != "cuda":
        raise ValueError("banded_traceback_cuda needs CUDA tensors")
    N_dp, L, _ = tbb.shape
    _check(tbb, "tbbits", torch.int32, (N_dp, L, w_b), dev)
    _check(offsets, "offsets", torch.int32, (N_dp, L), dev)
    for name, x in (("qa", qa), ("qb", qb), ("ta", ta), ("tb", tb),
                    ("final_state", result.final_state)):
        _check(x, name, torch.int32, (N_dp,), dev)
    _check(result.valid, "valid", torch.bool, (N_dp,), dev)
    N = N_dp if rows is None else rows.numel()
    if rows is not None:
        _check(rows, "rows", torch.int64, (N,), dev)
    wide = w_b != K1_WIDTH
    if not wide and tbb.data_ptr() % 16:
        raise ValueError("K2 copies 16-byte aligned rows of tbbits: its "
                         "storage must start 16-byte aligned")
    P = pair_capacity(t_max)
    # the kernel writes every pair word, zeros after the stop included
    pairs = torch.empty((N, P // 2), dtype=torch.int32, device=dev)
    counts = torch.empty((5, N), dtype=torch.int32, device=dev)
    overflow = torch.empty(N, dtype=torch.bool, device=dev)
    if lib is not None and not wide:
        raise ValueError("lib= takes another build of K2-W only")
    if N > 0:
        if lib is None:
            lib = _load(dev)
        else:
            set_up(lib, dev)
        ins = (tbb.data_ptr(), offsets.data_ptr(), qa.data_ptr(),
               qb.data_ptr(), ta.data_ptr(), tb.data_ptr(),
               result.final_state.data_ptr(), result.valid.data_ptr(),
               None if rows is None else rows.data_ptr())
        outs = (pairs.data_ptr(), *(c.data_ptr() for c in counts),
                overflow.data_ptr())
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if wide:
                rc = lib.blasr_banded_traceback_wide(*ins, N, L, w_b, P,
                                                     *outs, stream)
            else:
                rc = lib.blasr_banded_traceback(*ins, N, L, P, *outs, stream)
        key = "banded_traceback_w" if wide else "banded_traceback"
        _launched(rc, key)
        LAUNCHES[key] += 1
        INDEXED_WALKS += rows is not None
    return TracebackResult(pairs=pairs, n_pairs=counts[0],
                           n_match=counts[1], n_mismatch=counts[2],
                           n_ins=counts[3], n_del=counts[4],
                           overflow=overflow)


def chain_scan_launch(q, t, l, valid, nlogp, read_len, *, n_cand: int,
                      lookback: int, rate: float, drift_frac: float,
                      drift_slack: float, drift_penalty: float,
                      global_chain: bool, rank_mode: int) -> Candidates:
    """K3 on CUDA tensors: anchors q/t/l [B, A], all three int32 or all
    three int64 (values below 2^31, as the JAX package's int32 anchors),
    valid bool [B, A], nlogp float32 [B, A], read_len int32 or int64 [B];
    ``lookback`` is the predecessor window D (1..A), ``rank_mode`` the
    selection key (0 best, 1 sump, 2 best * log 4, 3 sumr).  Returns the
    Candidates of ``chain_anchors_plain``; the kernel writes the int64
    fields itself."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("chain_scan_launch needs CUDA tensors")
    B, A = q.shape
    pos_dt = torch.int64 if q.dtype == torch.int64 else torch.int32
    for name, x, dt in (("q", q, pos_dt), ("t", t, pos_dt),
                        ("l", l, pos_dt), ("valid", valid, torch.bool),
                        ("nlogp", nlogp, torch.float32)):
        _check(x, name, dt, (B, A), dev)
    wide_len = read_len.dtype == torch.int64
    _check(read_len, "read_len", torch.int64 if wide_len else torch.int32,
           (B,), dev)
    if A < 1 or not 1 <= lookback <= A or n_cand < 1 \
            or rank_mode not in range(4):
        raise ValueError(f"K3 arguments out of range: lookback={lookback}, "
                         f"n_cand={n_cand}, rank_mode={rank_mode}")
    C = n_cand
    i64 = torch.int64
    outs = [torch.empty((B, C), dtype=dt, device=dev)
            for dt in (i64, i64, i64, i64, torch.float32, i64,
                       torch.float32, torch.bool, i64)]
    parent = torch.empty((B, A), dtype=i64, device=dev)
    # beyond one block's shared memory the rows' arrays go to a scratch
    # buffer in global memory, one 16-byte aligned slice per row
    row_bytes = 0
    scratch = None
    if A > CHAIN_MAX_ANCHORS:
        row_bytes = -(-A * CHAIN_SMEM_PER_ANCHOR // 16) * 16
        scratch = torch.empty(B * row_bytes, dtype=torch.uint8, device=dev)
    if B > 0:
        lib = _load(dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.blasr_chain_scan(
                q.data_ptr(), t.data_ptr(), l.data_ptr(),
                int(pos_dt == torch.int64), valid.data_ptr(),
                nlogp.data_ptr(), read_len.data_ptr(), int(wide_len), B, A,
                lookback, C, float(rate), float(drift_frac),
                float(drift_slack), int(drift_penalty > 0.0),
                -float(drift_penalty), int(bool(global_chain)), rank_mode,
                *(o.data_ptr() for o in outs), parent.data_ptr(),
                None if scratch is None else scratch.data_ptr(), row_bytes,
                stream)
        _launched(rc, "chain_scan")
        LAUNCHES["chain_scan"] += 1
    qs, qe, ts, te, score, n_anch, cnlogp, cvalid, end = outs
    return Candidates(
        q_start=qs, q_end=qe, t_start=ts, t_end=te, score=score,
        n_anchors=n_anch, nlogp=cnlogp, valid=cvalid, end_idx=end,
        parent=parent)


def sdp_window_launch(rkeys, rvalid, windows, wlens, offs, *, k: int, occ: int,
                      D: int, w_b: int):
    """K4 on CUDA tensors, the whole of ``window_fragment_diags_banded`` in
    one launch, on its own arguments: read keys int64 [N, L] holding uint32
    and rvalid bool [N, L], windows int8 [N, W], wlens int32 or int64 [N],
    guide offsets int32 or int64 [N, L].  The kernel builds the window keys
    and the slab starts itself and writes (diag int64, valid bool), each
    [N, L, occ], as ``window_fragment_diags_banded_plain`` returns them."""
    dev = rkeys.device
    if dev.type != "cuda":
        raise ValueError("sdp_window_launch needs CUDA tensors")
    N, L = rkeys.shape
    W = windows.shape[1]
    _check(rkeys, "rkeys", torch.int64, (N, L), dev)
    _check(rvalid, "rvalid", torch.bool, (N, L), dev)
    _check(windows, "windows", torch.int8, (N, W), dev)
    for name, x, shape in (("wlens", wlens, (N,)), ("offs", offs, (N, L))):
        # the kernel reads either width; any other dtype is refused
        wide = x.dtype != torch.int32
        _check(x, name, torch.int64 if wide else torch.int32, shape, dev)
    if occ not in (1, 2) or D < 1 or not 1 <= k <= 32 or w_b < 0:
        raise ValueError(f"K4 takes occ 1 or 2, D >= 1 and 1 <= k <= 32 "
                         f"(occ={occ}, D={D}, k={k}, w_b={w_b})")
    diag = torch.empty((N, L, occ), dtype=torch.int64, device=dev)
    valid = torch.empty((N, L, occ), dtype=torch.bool, device=dev)
    if N > 0 and L > 0:
        lib = _load(dev)
        if lib.blasr_sdp_window_smem(L, D, k) > SMEM_OPTIN:
            raise ValueError(f"K4 stages a tile's D = {D} slab keys past its "
                             "query positions in shared memory: D is too "
                             "large")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.blasr_sdp_window(
                rkeys.data_ptr(), rvalid.data_ptr(), windows.data_ptr(),
                wlens.data_ptr(), int(wlens.dtype == torch.int64),
                offs.data_ptr(), int(offs.dtype == torch.int64), N, L, W, k,
                D, occ, w_b // 2, diag.data_ptr(), valid.data_ptr(), stream)
        _launched(rc, "sdp_window")
        LAUNCHES["sdp_window"] += 1
    return diag, valid


def anchor_search_launch(genome, keys_sorted, pos_sorted, reads, read_len, *,
                         k: int, occ_per_pos: int, max_anchors: int,
                         anchor_ext: int, min_match: int,
                         max_anchors_per_pos: int, max_lcp: int = 0,
                         advance_exact: int = 0,
                         occ_block_sample: bool = False, bucket_starts=None,
                         bucket_pairs=None, gwords=None, gnwords=None,
                         pos_records=None, lib=None) -> Anchors:
    """K5 on CUDA tensors: reads int8 [B, L], read_len int32 [B] and the
    DeviceIndex fields in their dtypes (genome int8 [G], keys_sorted and
    pos_sorted int64 [M], bucket_starts int32 [4^k + 1], bucket_pairs int32
    [4^k, 2], gwords/gnwords int64 [G], pos_records int32 [>= M, 6]).  The
    lookup is the paired LUT rows if given, else the LUT, else the sorted
    keys; the records serve the fetch when given and anchor_ext <= 32.
    Returns the Anchors of ``find_anchors_plain``, every field in its
    dtype.  ``occ_block_sample`` launches K5's block mode (counted apart
    as ``anchor_search_block``).  ``lib`` launches another build of the
    same C interface (``chip_smoke.py --compare K5``) instead of the
    package's."""
    dev = reads.device
    if dev.type != "cuda":
        raise ValueError("anchor_search_launch needs CUDA tensors")
    if gwords is None or gnwords is None:
        raise ValueError("K5 extends seeds with the packed genome words")
    B, L = reads.shape
    G = genome.shape[0]
    M = pos_sorted.shape[0]
    O, E = occ_per_pos, anchor_ext
    _check(reads, "reads", torch.int8, (B, L), dev)
    _check(read_len, "read_len", torch.int32, (B,), dev)
    _check(genome, "genome", torch.int8, (G,), dev)
    _check(pos_sorted, "pos_sorted", torch.int64, (M,), dev)
    _check(gwords, "gwords", torch.int64, (G,), dev)
    _check(gnwords, "gnwords", torch.int64, (G,), dev)
    if not 1 <= k <= 16 or O < 1 or E < 1 or max_anchors < 1 or L < 1:
        raise ValueError(f"K5 arguments out of range: k={k}, O={O}, E={E}, "
                         f"max_anchors={max_anchors}, L={L}")
    if bucket_pairs is not None:
        mode = 0
        _check(bucket_pairs, "bucket_pairs", torch.int32, (4 ** k, 2), dev)
    elif bucket_starts is not None:
        mode = 1
        _check(bucket_starts, "bucket_starts", torch.int32, (4 ** k + 1,),
               dev)
    else:
        mode = 2
        _check(keys_sorted, "keys_sorted", torch.int64, (M,), dev)
    use_rec = pos_records is not None and E <= 32
    if use_rec:
        _check(pos_records, "pos_records", torch.int32,
               (pos_records.shape[0], 6), dev)
        if pos_records.shape[0] < max(M, O if occ_block_sample else 0):
            raise ValueError("pos_records has fewer rows than pos_sorted "
                             "(or, in the block mode, than O)")
    n = L * O
    A_out = min(max_anchors, n)
    nbits = max(1, (n - 1).bit_length())
    lmax = k + E
    P = max(32, 1 << (A_out - 1).bit_length())
    # the keys, and a second buffer for the merge sort up to 4096 of them
    smem = (16 if P <= 4096 else 8) * P + 4 * A_out + 4 * (lmax + 1)
    if (n >= 1 << 31 or lmax >= 1 << 16 or lmax.bit_length() + nbits > 32
            or A_out > ANCHOR_MAX_SELECT
            or smem + ANCHOR_SELECT_STATIC > SMEM_OPTIN):
        raise ValueError(f"K5 cannot rank L*O = {n} candidates of length "
                         f"<= {lmax} into {A_out} anchors per row")
    i64 = torch.int64
    hits_t = torch.empty((B, L, O), dtype=i64, device=dev)
    hits_valid = torch.empty((B, L, O), dtype=torch.bool, device=dev)
    q, t, l = (torch.empty((B, A_out), dtype=i64, device=dev)
               for _ in range(3))
    valid = torch.empty((B, A_out), dtype=torch.bool, device=dev)
    nlogp = torch.empty((B, A_out), dtype=torch.float32, device=dev)
    n_total = torch.empty(B, dtype=torch.int32, device=dev)
    n_clipped = torch.empty(B, dtype=torch.int32, device=dev)
    seed_counts = torch.empty((B, 5), dtype=i64, device=dev)
    # the kernels' scratch in one buffer (a view costs more host time than
    # an allocation, so the outputs stay their own): per candidate a meta
    # word and its nlogp, per 256-position block of a row its clip sum
    nblk = -(-L // 256)
    scratch = torch.empty(B * (2 * n + nblk), dtype=torch.int32, device=dev)
    # and per block of a row its share of four of the seed counts
    seed_part = torch.empty((B, nblk, 4), dtype=i64, device=dev)
    if B > 0:
        def ptr(x):
            return None if x is None else x.data_ptr()

        def clamp30(x):
            # lengths stay below 2^16: wider values compare the same
            return max(min(int(x), 1 << 30), -(1 << 30))

        if lib is None:
            lib = _load(dev)
        else:
            set_up(lib, dev)
        big = (1 << 63) - 1
        meta = scratch.data_ptr()
        args = (reads.data_ptr(), read_len.data_ptr(), genome.data_ptr(),
                ptr(keys_sorted if mode == 2 else None),
                pos_sorted.data_ptr(),
                ptr(bucket_starts if mode == 1 else None),
                ptr(bucket_pairs if mode == 0 else None),
                ptr(pos_records if use_rec else None), gwords.data_ptr(),
                gnwords.data_ptr(), G, M, mode, int(use_rec), B, L, O, k, E,
                clamp30(min_match), max(min(max_anchors_per_pos, big), -big),
                clamp30(max_lcp), clamp30(advance_exact), A_out, nbits, lmax,
                float(M),
                hits_t.data_ptr(), hits_valid.data_ptr(), meta,
                meta + 4 * B * n, meta + 8 * B * n, seed_part.data_ptr(),
                q.data_ptr(), t.data_ptr(), l.data_ptr(), valid.data_ptr(),
                nlogp.data_ptr(), n_total.data_ptr(), n_clipped.data_ptr(),
                seed_counts.data_ptr())
        key = "anchor_search_block" if occ_block_sample else "anchor_search"
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if occ_block_sample:
                rc = lib.blasr_anchor_search_block(
                    *args, stream,
                    pos_records.shape[0] if use_rec else M)
            else:
                rc = lib.blasr_anchor_search(*args, stream)
        _launched(rc, key)
        LAUNCHES[key] += 1
    return Anchors(q=q, t=t, l=l, valid=valid, n_total=n_total,
                   nlogp=nlogp, hits_t=hits_t, hits_valid=hits_valid,
                   n_clipped=n_clipped, seed_counts=seed_counts)


def band_offsets_launch(mq, mt, ws, *, L: int, W: int, w_b: int,
                        frag_diag=None, frag_valid=None,
                        between_only: bool = False, lib=None) -> torch.Tensor:
    """K6 on CUDA tensors: chain members mq/mt int64 [N, MC] (BIG32 where
    invalid), window starts ws int64 [N], and optionally the fragments
    frag_diag int64 / frag_valid bool [N, L, F].  Returns the int64 [N, L]
    band offsets of ``_band_offsets_plain``."""
    dev = mq.device
    if dev.type != "cuda":
        raise ValueError("band_offsets_launch needs CUDA tensors")
    N, MC = mq.shape
    _check(mq, "mq", torch.int64, (N, MC), dev)
    _check(mt, "mt", torch.int64, (N, MC), dev)
    _check(ws, "ws", torch.int64, (N,), dev)
    if (frag_diag is None) != (frag_valid is None):
        raise ValueError("K6 takes frag_diag and frag_valid together")
    F = 0
    if frag_diag is not None:
        F = frag_diag.shape[-1]
        _check(frag_diag, "frag_diag", torch.int64, (N, L, F), dev)
        _check(frag_valid, "frag_valid", torch.bool, (N, L, F), dev)
    if not 1 <= L <= 1 << 16 or w_b < 1:
        raise ValueError(f"K6 packs rows in 16 bits: L = {L}, w_b = {w_b}")
    out = torch.empty((N, L), dtype=torch.int64, device=dev)
    if N > 0:
        scratch = None
        if L > BAND_SMEM_ROWS or lib is not None:
            # another build (--compare) may keep its rows there at any L
            scratch = torch.empty((N, 2, L), dtype=torch.int32, device=dev)
        if lib is None:
            lib = _load(dev)
        else:
            set_up(lib, dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.blasr_band_offsets(
                mq.data_ptr(), mt.data_ptr(), ws.data_ptr(),
                None if F == 0 else frag_diag.data_ptr(),
                None if F == 0 else frag_valid.data_ptr(), N, MC, L, W, w_b,
                F, int(bool(between_only)),
                None if scratch is None else scratch.data_ptr(),
                out.data_ptr(), stream)
        _launched(rc, "band_offsets")
        LAUNCHES["band_offsets"] += 1
    return out


def chain_members_plan(lib, C: int, A: int, M: int):
    """K7's launch for C > 0 chains of M members over rows of A anchors:
    (warps, stage) as ``blasr_chain_members`` takes them, from the
    library's own plan (``csrc/chain_members_plan.h``): the shared path
    (stage 2) while the row's lifting table fits in shared memory, else
    the chase with the row's parents staged (1) or in global memory (0)."""
    plan = (ctypes.c_int * 2)()
    if lib.blasr_chain_members_plan(C, A, M, ctypes.addressof(plan)):
        raise ValueError(f"K7 keeps a chain's {M} members in shared "
                         "memory: max_chain is too large")
    return plan[0], plan[1]


def chain_members_launch(q, t, l, parent, end_idx, *, max_chain: int):
    """K7 on CUDA tensors: anchors q/t/l [B, A], all three int32 or all
    three int64, K3's parent pointers int64 [B, A] and chain ends int64
    [B, C].  Returns (mq, mt, ml int64, mvalid bool), each [B, C, M], as
    ``chain_members_plain`` returns them.  The path is
    :func:`chain_members_plan`'s, counted in :data:`MEMBER_PATHS`."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("chain_members_launch needs CUDA tensors")
    B, A = q.shape
    C = end_idx.shape[1] if end_idx.dim() == 2 else -1
    M = max_chain
    pos_dt = torch.int64 if q.dtype == torch.int64 else torch.int32
    for name, x, dt, shape in (("q", q, pos_dt, (B, A)),
                               ("t", t, pos_dt, (B, A)),
                               ("l", l, pos_dt, (B, A)),
                               ("parent", parent, torch.int64, (B, A)),
                               ("end_idx", end_idx, torch.int64, (B, C))):
        _check(x, name, dt, shape, dev)
    if M < 1:
        raise ValueError(f"K7 needs max_chain >= 1, got {M}")
    i64 = torch.int64
    mq, mt, ml = (torch.empty((B, C, M), dtype=i64, device=dev)
                  for _ in range(3))
    mvalid = torch.empty((B, C, M), dtype=torch.bool, device=dev)
    if B * C == 0:
        return mq, mt, ml, mvalid
    lib = _load(dev)
    warps, stage = chain_members_plan(lib, C, A, M)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.blasr_chain_members(
            q.data_ptr(), t.data_ptr(), l.data_ptr(),
            int(pos_dt == torch.int64), parent.data_ptr(),
            end_idx.data_ptr(), B, C, A, M, warps, stage, mq.data_ptr(),
            mt.data_ptr(), ml.data_ptr(), mvalid.data_ptr(), stream)
    _launched(rc, "chain_members")
    LAUNCHES["chain_members"] += 1
    MEMBER_PATHS[MEMBER_STAGES[stage]] += 1
    return mq, mt, ml, mvalid
