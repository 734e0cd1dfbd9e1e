#!/usr/bin/env python3
"""Where the time of K5's selection kernel, of K6 and of K1 goes.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_kernel_phases.py
    python3 tools/torch_kernel_phases.py --k1 [A/banded_dp.cu ...]

The second form measures K1 (``blasr_tpu_torch/csrc/banded_dp.cu``, or
each given source, e.g. a parent commit's beside this one's): it prints
``-Xptxas -v``'s registers and spills of the six instantiations and
whether each one's SASS equals the first source's, then
builds a copy in which each warp's lane 0 counts the SM cycles it spends
inside ``mbar_wait`` (in shared memory) and stamps ``clock64`` and
``%globaltimer`` when its role starts and ends, and runs K1 and K1-HP
(and K1-HP-GEN) on ``chip_smoke.py`` phase 2's inputs (N=640, L=2048,
W=3072, ``random_case``) and on the same shape with about three rows of
four ``hp_ok`` (``hp_share=0.7``), every output held to the package's
kernel.  Per warp it prints the mean over the CTAs of the time outside
and inside the waits in microseconds, and the recurrence warp's ns per
active row (its time outside the waits over the item's rows qa..qb).
The counters cost a shared-memory add per wait.

The first form:

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
import difflib
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
    lib = cuda_ops.bind(compile_copy(src, name), (fn,))
    lib.phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def compile_copy(src: str, stem: str):
    """``src`` (a source's text) built into build/phases/<stem>.so with the
    package's flags; the loaded library."""
    out = os.path.join(HERE, "build", "phases")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, f"{stem}.cu"), os.path.join(out, f"{stem}.so")
    with open(cu, "w") as f:
        f.write(src)
    r = subprocess.run([cuda_ops._nvcc(), *cuda_ops.NVCC_FLAGS, "-shared",
                        "-I", str(cuda_ops.SRC_DIR), "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(r.stderr[-3000:])
    lib = ctypes.CDLL(so)
    cuda_ops.set_up(lib)   # its kernels' attributes, where it sets them so
    return lib


# K1's instantiations by their mangled template arguments <QV, HP, GEN>
K1_NAMES = {"ILb0ELb0ELb0E": "K1", "ILb1ELb0ELb0E": "K1-QV",
            "ILb0ELb1ELb0E": "K1-HP", "ILb0ELb0ELb1E": "K1-GEN",
            "ILb0ELb1ELb1E": "K1-HP-GEN", "ILb1ELb0ELb1E": "K1-QV-GEN"}
# one CTA's counters: per warp (cycles of its role, cycles inside
# mbar_wait, ns of its role by %globaltimer, unused)
K1_SLOTS = 12
K1_EDITS = [
    # the wait counters, in static shared memory beside the ring
    ("namespace {\n", "__device__ unsigned long long g_k1[65536 * 12];\n"
     "__shared__ unsigned long long s_wait_[3];\nnamespace {\n"),
    ("                                          unsigned parity) {\n"
     "  unsigned done;\n",
     "                                          unsigned parity) {\n"
     "  unsigned done;\n  const long long w0_ = clock64();\n"),
    ("  } while (!done);\n}\n",
     "  } while (!done);\n  if ((threadIdx.x & 31) == 0)\n"
     "    s_wait_[threadIdx.x >> 5] += clock64() - w0_;\n}\n"),
    ("  if (threadIdx.x == 0) {\n    for (int k = 0; k < 2; ++k) {\n",
     "  if (threadIdx.x < 3) s_wait_[threadIdx.x] = 0;\n"
     "  if (threadIdx.x == 0) {\n    for (int k = 0; k < 2; ++k) {\n"),
    ("  __syncthreads();\n  if (warp == 0) {\n",
     "  __syncthreads();\n  const long long c0_ = clock64();\n"
     "  unsigned long long g0_;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0_));\n"
     "  if (warp == 0) {\n"),
    ("    cell_words<HP>(a, sm, n, lane);\n  }\n}\n",
     "    cell_words<HP>(a, sm, n, lane);\n  }\n"
     "  const long long c1_ = clock64();\n  unsigned long long g1_;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1_));\n"
     "  if (lane == 0) {\n"
     "    unsigned long long* o_ = g_k1 + (size_t)blockIdx.x * 12 + "
     "warp * 4;\n"
     "    o_[0] = c1_ - c0_; o_[1] = s_wait_[warp]; o_[2] = g1_ - g0_;\n"
     "  }\n}\n"),
]


def k1_build_info(path: str, stem: str):
    """(-Xptxas -v's registers and spills of each K1 instantiation, {the
    instantiation: its SASS instructions, addresses and encodings left
    out}) of one K1 source compiled to a cubin."""
    out = os.path.join(HERE, "build", "phases", f"{stem}.cubin")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    r = subprocess.run([cuda_ops._nvcc(), *cuda_ops.NVCC_FLAGS[:4],
                        "-Xptxas", "-v", "-cubin", "-o", out, path],
                       check=True, capture_output=True, text=True)
    regs, name = [], None
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in K1_NAMES.items() if k in line), None)
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            n = line.split("Used ")[1].split(" registers")[0]
            regs.append(f"{name} {n} registers ({spill})")
            name = None
    dump = subprocess.run(
        [os.path.join(os.path.dirname(cuda_ops._nvcc()), "cuobjdump"),
         "-sass", out], check=True, capture_output=True, text=True).stdout
    sass = {}
    for line in dump.splitlines():
        if "Function :" in line:
            name = next((v for k, v in K1_NAMES.items() if k in line), None)
            sass[name] = []
        elif name and line.strip().startswith("/*") and "*/" in line:
            ins = line.split("*/", 1)[1].split("/*")[0].strip()
            if ins:
                sass[name].append(ins)
    return "; ".join(sorted(regs)), sass


def k1_warps(paths, card: str) -> None:
    """K1, K1-HP and K1-HP-GEN of each source, instrumented, on phase 2's
    inputs and on an hp-heavy case of the same shape: each warp's time
    outside and inside its waits."""
    from blasr_tpu_torch.kernels.pallas_banded import two_valued
    from blasr_tpu_torch.params import MappingParams
    from torch_edge_cases import k1_mode_kwargs
    libs, sass = [], []
    for k, path in enumerate(paths):
        regs, code = k1_build_info(path, f"k1_plain_{k}")
        log(f"# {path}: ptxas {regs} on {card}")
        sass.append(code)
        if k:
            parts = []
            for n in K1_NAMES.values():
                a, b = sass[0].get(n, []), sass[k].get(n, [])
                ratio = difflib.SequenceMatcher(None, a, b,
                                                autojunk=False).ratio()
                parts.append(f"{n} {'identical' if a == b else 'differs'} "
                             f"({len(a)} -> {len(b)}, {ratio:.3f})")
            log(f"# {path}: SASS of each instantiation against {paths[0]}'s"
                " (instructions there -> here, share matched): "
                + ", ".join(parts))
        src = open(path).read()
        for old, new in K1_EDITS:
            if src.count(old) != 1:
                sys.exit(f"{path}: an edit of the K1 copy matches "
                         f"{src.count(old)} places: {old!r}")
            src = src.replace(old, new)
        src += ("\nextern \"C\" int k1_read(unsigned long long* dst, int n)"
                " { return (int)cudaMemcpyFromSymbol(dst, g_k1, n * "
                "sizeof(unsigned long long)); }\n")
        lib = compile_copy(src, f"k1_phases_{k}")
        cuda_ops.bind(lib, ("blasr_banded_dp", "blasr_banded_dp_mode"))
        lib.k1_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs.append(lib)
    N, L, W = 640, 2048, 3072
    dev = torch.device("cuda")
    sm = np.asarray(MappingParams().make_sane().score_matrix,
                    np.float32).reshape(25)
    for label, share in (("random_case", None), ("hp-heavy", 0.7)):
        ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
               cs.random_case(np.random.default_rng(7), N, L, W,
                              hp_share=share)]
        rows = (ins[4] - ins[3]).double().cpu().numpy()
        shares = cs.hp_row_cases(ins[0], ins[3], ins[4])
        for mode in ("distance", "hp", "hp-gen"):
            if mode == "distance":
                m, gaps, kw = sm, (4.0, 4.0, 5.0, 5.0), {}
                ref = cuda_ops.banded_dp_launch(
                    *ins, match=float(sm[0]), mismatch=float(sm[1]),
                    ins_open=4.0, ins_ext=4.0, del_open=5.0, del_ext=5.0)
            else:
                m, gaps, kw = k1_mode_kwargs(mode)
                gen = not two_valued(m)
                ref = cuda_ops.banded_dp_launch(
                    *ins, match=float(m[0]), mismatch=float(m[1]),
                    ins_open=gaps[0], ins_ext=gaps[1], del_open=gaps[2],
                    del_ext=gaps[3], submat=m if gen else None, **kw)
            name = {"distance": "K1", "hp": "K1-HP",
                    "hp-gen": "K1-HP-GEN"}[mode]
            for path, lib in zip(paths, libs):
                outs = (torch.empty(N, dtype=torch.float32, device=dev),
                        torch.empty((N, L, 128), dtype=torch.int32,
                                    device=dev),
                        torch.empty(N, dtype=torch.int32, device=dev),
                        torch.empty(N, dtype=torch.bool, device=dev))
                p = [x.data_ptr() for x in ins]
                o = [x.data_ptr() for x in outs]
                stream = torch.cuda.current_stream().cuda_stream
                for _ in range(3):
                    if mode == "distance":
                        rc = lib.blasr_banded_dp(*p, N, L, W, float(sm[0]),
                                                 float(sm[1]), 4.0, 4.0,
                                                 5.0, 5.0, *o, stream)
                    else:
                        rc = lib.blasr_banded_dp_mode(
                            *p, None, None, N, L, W, 1, int(gen),
                            np.ascontiguousarray(m).ctypes.data,
                            float(m[0]), float(m[1]), *gaps,
                            kw["hp_open"], kw["hp_ext"], *o, stream)
                    assert rc == 0, f"launch failed: {rc}"
                torch.cuda.synchronize()
                for a, b in zip(outs, ref):
                    if not torch.equal(a, b):
                        sys.exit(f"the instrumented {name} of {path} "
                                 f"differs from the package's kernel")
                buf = (ctypes.c_ulonglong * (N * K1_SLOTS))()
                if lib.k1_read(buf, N * K1_SLOTS) != 0:
                    sys.exit("reading the counters failed")
                t = np.array(buf, dtype=np.float64).reshape(N, 3, 4)
                ns_per_cycle = t[:, :, 2] / t[:, :, 0]
                busy = (t[:, :, 0] - t[:, :, 1]) * ns_per_cycle / 1e3
                wait = t[:, :, 1] * ns_per_cycle / 1e3
                per_row = 1e3 * busy[:, 1] / rows
                parts = [f"warp {w} ({role}) {busy[:, w].mean():.1f} "
                         f"outside / {wait[:, w].mean():.1f} inside waits"
                         for w, role in enumerate(("row inputs",
                                                   "recurrence",
                                                   "cell words"))]
                log(f"# {name} on {label} (N={N}, L={L}; rows hp_ok "
                    f"{shares['hp_ok']:.3f}, cases 1-4 "
                    + "/".join(f"{x:.3f}" for x in shares["cases"])
                    + f") from {path}: us per CTA, mean: "
                    + ", ".join(parts)
                    + f"; recurrence {per_row.mean():.1f} ns per active "
                    f"row; longest CTA {t[:, 1, 2].max() / 1e3:.1f} us, "
                    f"{1e3 / ns_per_cycle[:, 1].mean():.0f} MHz on {card}")


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


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("torch_kernel_phases: no CUDA device available\n")
        return 2
    card = cs.card_line()
    if sys.argv[1:2] == ["--k1"]:
        k1_warps(sys.argv[2:] or [os.path.join(cuda_ops.SRC_DIR,
                                               "banded_dp.cu")], card)
        return 0
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
