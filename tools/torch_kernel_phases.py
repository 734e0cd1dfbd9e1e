#!/usr/bin/env python3
"""Where the time of K5's selection kernel and of K6 goes, phase by phase.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_kernel_phases.py

It builds instrumented copies of ``blasr_tpu_torch/csrc/anchor_search.cu``
and ``band_offsets.cu`` into ``build/phases/``: thread 0 of every CTA
stores ``%globaltimer`` (ns) after each marked line.  Each copy runs
through the package's wrapper (``lib=``) on the calls of
``chip_smoke.py`` phase 2 (the bench batch's find_anchors call and its
map_batch's two _band_offsets calls, K6 also without its fragments), its
outputs held to the package's kernels, and the script prints, per phase,
the mean and the largest time over the CTAs in microseconds.  A mark that
no longer matches its source exits nonzero.  The stamps and the copies'
other code cost a little time of their own; compare phases, not totals.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blasr_tpu_torch.kernels import cuda_ops  # noqa: E402

cs.np, cs.torch = np, torch
SLOTS = 10      # stamps a CTA may store
STAMP = ("if (threadIdx.x == 0) { unsigned long long t_; asm volatile("
         "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
         "g_phase[blockIdx.x * SLOTS + PHASE] = t_; }\n")

# (phase name, a line of the source, stamp after it (else before))
K6_MARKS = [
    ("start", "  const int r0 = threadIdx.x * R;\n", True),
    ("members", "    atomicMax(&arr[pad((int)row)], packed);\n  }\n"
     "  __syncthreads();\n", True),
    ("fills 1", "        if (v >= 0) atomicOr(&s_member[r >> 5], "
     "1u << (r & 31));\n      }\n    }\n    __syncthreads();\n", True),
    ("fold", "          atomicMax(&arr[pad(r)], (r << DBITS) | "
     "(d + DBIAS));\n      }\n    }\n    __syncthreads();\n  }\n", True),
    ("fills 2", "  scan_both(vmax, vmin, cmax, cmin, s_w[1]);\n", True),
    ("offsets", "  const int c3 = scan_before<true>(omax, s_w[0]);\n", True),
    ("cummax", "  const int c4 = scan_before<false>(lmin, s_w[1]);\n", True),
    ("slope", "    if (r < L) arr[pad(r)] = 2 * r + min(c4, nx[pad(r)]);\n"
     "  }\n  __syncthreads();\n", True),
    ("out", "    out[(size_t)n * L + r] = arr[pad(r)];\n", True),
]
K5_MARKS = [
    ("start", "  const float* np_ = cnlogp + (size_t)b * n;\n", True),
    ("stage + histogram", "      atomicAdd(&s_hist[u & 0xFFFFu], "
     "__popc(peers));\n  });\n  __syncthreads();\n", True),
    ("threshold", "  const int total = s_total;\n", False),
    ("radix", "  const uint32_t rthr = s_prefix;\n", True),
    ("collect + invalid", "  for (int i = A_out + tid; i < s.P; "
     "i += SEL_THREADS) s_keys[i] = ~0ull;\n  __syncthreads();\n", True),
    ("sort", "  // write the A_out slots\n", False),
    ("out", "    out_nlogp[orow + i] = np_[f];\n  }\n", True),
]


def instrument(name: str, marks, fn: str):
    """The instrumented copy of csrc/<name>.cu, built and bound."""
    src = open(os.path.join(cuda_ops.SRC_DIR, f"{name}.cu")).read()
    for i, (phase, line, after) in enumerate(marks):
        if src.count(line) != 1:
            sys.exit(f"{name}.cu: the mark of phase '{phase}' matches "
                     f"{src.count(line)} lines")
        st = STAMP.replace("SLOTS", str(SLOTS)).replace("PHASE", str(i))
        src = src.replace(line, line + st if after else st + line)
    src = src.replace("namespace {\n", "__device__ unsigned long long "
                      f"g_phase[65536 * {SLOTS}];\nnamespace {{\n", 1)
    src += ("\nextern \"C\" int phases_read(unsigned long long* dst, int n) "
            "{ return (int)cudaMemcpyFromSymbol(dst, g_phase, "
            "n * sizeof(unsigned long long)); }\n")
    out = os.path.join(HERE, "build", "phases")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, f"{name}.cu"), os.path.join(out, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    r = subprocess.run([cuda_ops._nvcc(), *cuda_ops.NVCC_FLAGS, "-shared",
                        "-I", str(cuda_ops.SRC_DIR), "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(r.stderr[-3000:])
    lib = cuda_ops.bind(ctypes.CDLL(so), (fn,))
    lib.phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def report(lib, ctas: int, marks, used, label: str, card: str) -> None:
    buf = (ctypes.c_ulonglong * (ctas * SLOTS))()
    if lib.phases_read(buf, ctas * SLOTS) != 0:
        sys.exit("reading the stamps failed")
    t = np.array(buf, dtype=np.float64).reshape(ctas, SLOTS)
    prev = t[:, 0]
    parts = []
    for i in used[1:]:
        d = (t[:, i] - prev) / 1e3
        parts.append(f"{marks[i][0]} {d.mean():.2f}/{d.max():.2f}")
        prev = t[:, i]
    print(f"# {label}: {ctas} CTAs, first start to last stamp "
          f"{(t[:, used[-1]].max() - t[:, 0].min()) / 1e3:.2f} us; us per "
          f"phase, mean/max over the CTAs: " + ", ".join(parts)
          + f" on {card}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("torch_kernel_phases: no CUDA device available\n")
        return 2
    card = cs.card_line()
    cuda_ops.build()
    k6 = instrument("band_offsets", K6_MARKS, "blasr_band_offsets")
    k5 = instrument("anchor_search", K5_MARKS, "blasr_anchor_search")
    gi, sims = cs.bench_world()
    bb = cs.bench_batch(gi, sims)
    for i, (a, kw, ref) in enumerate(cs.band_calls(bb)):
        x = cs.band_launch_args(a, kw)
        for frags in (True, False):
            def run():
                return cuda_ops.band_offsets_launch(
                    x["mq"], x["mt"], x["ws"], L=x["L"], W=x["W"],
                    w_b=x["w_b"], between_only=x["between_only"], lib=k6,
                    frag_diag=x["frag_diag"] if frags else None,
                    frag_valid=x["frag_valid"] if frags else None)
            for _ in range(3):
                out = run()
            torch.cuda.synchronize()
            if frags and not torch.equal(out, ref):
                sys.exit(f"the instrumented K6 differs on call {i + 1}")
            used = [0, 1, 2, 3, 4, 5, 6, 7, 8] if frags else \
                [0, 1, 4, 5, 6, 7, 8]
            report(k6, x["mq"].shape[0], K6_MARKS, used,
                   f"K6 call {i + 1} (N={x['mq'].shape[0]}, L={x['L']}, "
                   f"F={x['frag_diag'].shape[-1] if frags else 0})", card)
    a = bb["anchor_args"]
    a = (*a[:3], a[3].contiguous(), a[4].to(torch.int32).contiguous())
    for _ in range(3):
        out = cuda_ops.anchor_search_launch(*a, **bb["anchor_kw"], lib=k5)
    torch.cuda.synchronize()
    cs.check_equal(out, bb["anchors"], out._fields, "instrumented K5")
    report(k5, a[3].shape[0], K5_MARKS, list(range(len(K5_MARKS))),
           f"K5 anchor_select (B={a[3].shape[0]}, L={a[3].shape[1]})", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
