// K1-W: guided banded DP, forward pass, at any band width, in the six
// compile-time modes <QV, HP, GEN> of K1.
//
// Replaces blasr_tpu/kernels/banded.py::banded_align (banded.py:362,
// `_align_one` from banded.py:150) at band widths other than 128, where
// the JAX Mapper runs the XLA kernel (its Pallas kernel and the port's K1,
// csrc/banded_dp.cu, take band 128 only).  It reproduces `_align_one` bit
// for bit, as K1 does: the M/I/D (and H) min-cost recurrence, the <=
// tie-breaks in the order M, I, D, H, INF = 1e30, and the int32 cell word
// per banded cell (layout in blasr_tpu_torch/kernels/banded.py), so K2-W
// and the host read it unchanged.  The modes are K1's (distance, QV, the
// hp band, each with a two-valued matrix or, GEN, any 5x5 matrix); see
// banded_dp.cu for what each one computes.
//
// Any band offsets are taken, as the XLA kernel takes them: the row's
// shift s = o_r - o_{r-1} reads the previous row at w + s - 1 (diagonal)
// and w + s (vertical) with lax.dynamic_slice's index rule (a negative
// start counts from the end of the padded row [fill, row, fill * w_b],
// then clamps into [0, w_b + 1]), so K1-W has no slope limit.
//
// Layout (a simple design): one CTA per item, T = min(32 * ceil(w_b /
// 32), 1024) threads, thread i owning the band cells [i * cpt, (i + 1) *
// cpt), cpt = ceil(w_b / T), so no width is refused.  Every per-cell value
// that crosses a thread lives in a workspace of NARR arrays of w_b words:
// the previous row's M/I/D/H, run counters (rexit | mrun << 2 | meq << 8)
// and ssum, double-buffered, and this row's base, prefix-min of g, cell
// code and, in QV mode, the deletion costs cd and their prefix sum S.  The
// workspace is dynamic shared memory up to SMEM_DYNAMIC_MAX (w_b up to
// ~3,300 cells), above that a global scratch the wrapper allocates.  Per
// row: one pass over the thread's cells (the shifted predecessors, M, I,
// H, base, the thread's running min of g), a block-wide prefix (warp
// shuffles, then the warps' totals) of cd (QV) and of min(g), a second
// pass (D, d_open, d_from_m, the run counters, the cell word, stored
// straight to global memory), and a barrier.  At the first row the
// boundary row qa - 1 replaces the previous row; in QV mode its deletion
// profile, the running sum of row qa's cd over the window from ta, is
// summed in chunks of T window columns.  Rows outside [qa, qb) are written
// as zeros.
//
// Arithmetic: every cost is an integer below 2^24, so the sums are exact
// in any order (S is held in a full float, exact while it stays below 2^24:
// w_b * 255 < 2^24 for w_b < 65,793); the float operations keep the plain
// version's order through the _rn intrinsics, which nvcc never contracts
// into an FMA, and the sources build without --use_fast_math.
//
// What bounds it on an H100: the row's dependent chain, three block-wide
// barriers a row (four in QV mode) with the shared-memory round trips
// between them, one item per CTA; then the cell-word stream, N * L * w_b
// * 4 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float INF_F = 1e30f;
constexpr float HALF_INF = 1e30f * 0.5f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ST_M = 0, ST_I = 1, ST_D = 2, ST_H = 3;
constexpr int RUN_CAP = 63;
constexpr int MAX_THREADS = 1024;
// the workspace arrays, each w_b words: two buffers of the previous row's
// state (M, I, D, H, run counters C, ssum S), then this row's base, the
// running min of g, the cell code, the QV prefix sum and deletion costs
enum {
  A_M, A_I, A_D, A_H, A_C, A_S,  // buffer 0; buffer 1 at + NSTATE
  NSTATE = 6,
  A_BASE = 2 * NSTATE, A_G, A_CODE, A_QS, A_CD, NARR
};
// the dynamic shared memory a CTA may take beside its static arrays
constexpr int SMEM_DYNAMIC_MAX = 232448 - 8192;
// cell code: msrc (bits 0-1), i_open (2), eq (5), h_open (6) as in the
// cell word, and M <= I (the next cell's d_from_m) at bit 8
constexpr unsigned C_MLEI = 256u;

struct Args {
  const int8_t* reads;
  const int8_t* windows;
  const int32_t* offsets;
  const int32_t *qa, *qb, *ta, *tb, *qv1, *qv2;
  int N, L, W, w_b, cpt;
  float match, mismatch, ins_open, ins_ext, del_open, del_ext;
  float hp_open, hp_ext;
  float submat[25];  // GEN: the whole matrix, read base major
  float* scratch;    // the workspace in global memory, or null
  float* score;
  int32_t* tbbits;
  int32_t* state;
  uint8_t* valid;
};

struct MinOp {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct AddOp {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};

// The prefix over the block's threads, in thread order, of v under op
// (identity id): returns the exclusive prefix and sets incl to the
// inclusive one.  Every thread of the block calls it; one barrier, and
// wtot (32 words) may be written again only after another barrier.
template <class Op>
__device__ __forceinline__ float block_scan(float v, float id, float* wtot,
                                            Op op, float& incl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x = op(y, x);
  }
  float ex = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) ex = id;
  if (lane == 31) wtot[warp] = x;
  __syncthreads();
  float pre = id;
  for (int k = 0; k < warp; ++k) pre = op(pre, wtot[k]);
  incl = op(pre, x);
  return op(pre, ex);
}

// lax.dynamic_slice's start of a shift: negative counts from the end of
// the padded row (2 * w_b + 1 long), then clamped into [0, w_b + 1]
__device__ __forceinline__ int slice_start(int st, int w_b) {
  if (st < 0) st += 2 * w_b + 1;
  return min(max(st, 0), w_b + 1);
}

template <bool QV, bool HP, bool GEN>
__global__ void __launch_bounds__(MAX_THREADS) banded_dp_wide_kernel(Args a) {
  extern __shared__ __align__(16) float smem_ws[];
  __shared__ float chunk[MAX_THREADS];
  __shared__ float wtot[3][32];
  __shared__ float fin_score;
  __shared__ int fin_state, fin_ok;
  const int n = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int L = a.L, W = a.W, w_b = a.w_b;
  const int c_lo = min(tid * a.cpt, w_b), c_hi = min(c_lo + a.cpt, w_b);
  float* ws = a.scratch != nullptr
                  ? a.scratch + (size_t)n * NARR * (size_t)w_b
                  : smem_ws;
  auto arr = [&](int k) { return ws + (size_t)k * w_b; };
  auto iarr = [&](int k) { return reinterpret_cast<int*>(ws) + (size_t)k * w_b; };

  const int qa = a.qa[n], qb = a.qb[n], ta = a.ta[n], tb = a.tb[n];
  const int8_t* rd = a.reads + (size_t)n * L;
  const int8_t* win = a.windows + (size_t)n * W;
  const int32_t* off = a.offsets + (size_t)n * L;
  int32_t* out = a.tbbits + (size_t)n * L * (size_t)w_b;

  for (int c = c_lo; c < c_hi; ++c) {
    arr(A_M)[c] = INF_F;
    arr(A_I)[c] = INF_F;
    arr(A_D)[c] = INF_F;
    arr(A_H)[c] = INF_F;
    iarr(A_C)[c] = 0;
    iarr(A_S)[c] = 0;
  }
  if (tid == 0) {
    fin_score = INF_F;
    fin_state = ST_M;
    fin_ok = 0;
  }
  __syncthreads();

  int po = 0;   // the offset of the last active row
  int cur = 0;  // the buffer that holds the previous row
  for (int r = 0; r < L; ++r) {
    int32_t* row_out = out + (size_t)r * w_b;
    if (r < qa || r >= qb) {  // uniform
      for (int c = tid; c < w_b; c += nt) row_out[c] = 0;
      continue;
    }
    const bool first = r == qa;
    const int o_r = off[r];
    const int s = first ? 0 : o_r - po;
    const int rb = rd[r];
    const int ps = cur * NSTATE, ns = (cur ^ 1) * NSTATE;
    float* pM = arr(ps + A_M);
    float* pI = arr(ps + A_I);
    float* pD = arr(ps + A_D);
    float* pH = arr(ps + A_H);
    const int* pC = iarr(ps + A_C);
    const int* pS = iarr(ps + A_S);
    float* nM = arr(ns + A_M);
    float* nI = arr(ns + A_I);
    float* nD = arr(ns + A_D);
    float* nH = arr(ns + A_H);
    int* nC = iarr(ns + A_C);
    int* nS = iarr(ns + A_S);

    // the row's QV costs (packed tracks) and whether it takes the hp band
    float insq = 0.f, delq = 0.f, subq = 0.f, dpri = 0.f, spri = 0.f;
    int dtag = 7, stag = 7;
    if constexpr (QV) {
      const unsigned w1 = (unsigned)a.qv1[(size_t)n * L + r];
      const unsigned w2 = (unsigned)a.qv2[(size_t)n * L + r];
      insq = (float)(w1 & 255u);
      delq = (float)((w1 >> 8) & 255u);
      subq = (float)((w1 >> 16) & 255u);
      dtag = (int)((w1 >> 24) & 7u);
      stag = (int)((w1 >> 27) & 7u);
      dpri = (float)(w2 & 255u);
      spri = (float)((w2 >> 8) & 255u);
    }
    bool hp_ok = false;
    if constexpr (HP) {
      const int rbp = r > 0 ? (int)rd[r - 1] : 4;
      hp_ok = rb == rbp && rbp < 4;
    }
    const int tstart = min(max(o_r, 0), W);

    if (first) {
      // the boundary row qa - 1 replaces the previous row: a zero-cost M
      // cell at ta - 1, leading deletions from ta on
      for (int c = c_lo; c < c_hi; ++c) {
        const int t_abs = o_r + c;
        pM[c] = t_abs == ta - 1 ? 0.0f : INF_F;
        pI[c] = INF_F;
        pH[c] = INF_F;
        if constexpr (!QV) {
          pD[c] = t_abs >= ta
                      ? __fadd_rn(a.del_open,
                                  __fmul_rn(a.del_ext, (float)(t_abs - ta)))
                      : INF_F;
        } else {
          pD[c] = t_abs >= ta ? 0.0f : INF_F;
        }
      }
      if constexpr (QV) {
        // the running sum of row qa's cd over the window columns
        // [clamp(ta), clamp(t_abs + 1)), in chunks of nt columns
        const int lo = min(max(ta, 0), W);
        const int hi_max = min(max(o_r + w_b, 0), W);
        float carry = 0.0f;
        for (int base = lo; base < hi_max; base += nt) {
          const int t = base + tid;
          const float v = t < hi_max
                              ? ((int)win[t] == dtag ? delq : dpri)
                              : 0.0f;
          float incl;
          block_scan(v, 0.0f, wtot[2], AddOp(), incl);
          chunk[tid] = incl;
          __syncthreads();
          for (int c = c_lo; c < c_hi; ++c) {
            const int t_abs = o_r + c;
            const int hi = min(max(t_abs + 1, 0), W);
            if (t_abs >= ta && hi - 1 >= base && hi - 1 < base + nt)
              pD[c] = __fadd_rn(carry, chunk[hi - 1 - base]);
          }
          carry = __fadd_rn(carry, chunk[nt - 1]);
          __syncthreads();
        }
      }
      __syncthreads();
    }

    const int sd = slice_start(s, w_b), sv = slice_start(s + 1, w_b);
    // pass 1: the shifted predecessors, M, I, H, base, the cell code and
    // the thread's running min of g (distance) or sum of cd (QV)
    float run = QV ? 0.0f : INF_F;
    for (int c = c_lo; c < c_hi; ++c) {
      const int t_abs = o_r + c;
      const int ti = tstart + c;
      const int tgt = ti < W ? (int)win[ti] : 4;
      const bool eq = rb == tgt && rb < 4;
      const bool in_t = t_abs >= ta && t_abs < tb;
      const bool in_t_i = t_abs >= ta - 1 && t_abs < tb;
      float sub;
      if constexpr (GEN) {
        sub = a.submat[rb * 5 + tgt];
      } else {
        sub = eq ? a.match : a.mismatch;
      }
      if constexpr (QV) {
        if (!eq) sub = tgt == stag ? subq : spri;
      }
      const int jd = c + sd - 1, jv = c + sv - 1;
      const bool okd = jd >= 0 && jd < w_b, okv = jv >= 0 && jv < w_b;
      const float dM = okd ? pM[jd] : INF_F, dI = okd ? pI[jd] : INF_F,
                  dD = okd ? pD[jd] : INF_F;
      const float vM = okv ? pM[jv] : INF_F, vI = okv ? pI[jv] : INF_F;
      float db = fminf(dM, fminf(dI, dD));
      int last = ST_D;
      float dH = INF_F, vH = INF_F;
      if constexpr (HP) {
        dH = okd ? pH[jd] : INF_F;
        vH = okv ? pH[jv] : INF_F;
        db = fminf(db, dH);
        last = dD <= db ? ST_D : ST_H;
      }
      const int msrc = dM <= db ? ST_M : (dI <= db ? ST_I : last);
      const float M = in_t ? __fadd_rn(sub, db) : INF_F;
      float ifm, ifi;
      if constexpr (QV) {
        ifm = __fadd_rn(vM, insq);
        ifi = __fadd_rn(vI, insq);
      } else {
        ifm = __fadd_rn(vM, a.ins_open);
        ifi = __fadd_rn(vI, a.ins_ext);
      }
      const float I = in_t_i ? fminf(ifm, ifi) : INF_F;
      float base = fminf(M, I);
      bool hopen = false;
      if constexpr (HP) {
        const float hfm = __fadd_rn(vM, a.hp_open);
        const float hfh = __fadd_rn(vH, a.hp_ext);
        const float H = in_t_i && hp_ok ? fminf(hfm, hfh) : INF_F;
        hopen = hfm <= hfh;
        base = fminf(base, H);
        nH[c] = H;
      }
      nM[c] = M;
      nI[c] = I;
      arr(A_BASE)[c] = base;
      iarr(A_CODE)[c] = msrc | (ifm <= ifi ? 4 : 0) | (eq ? 32 : 0) |
                        (hopen ? 64 : 0) | (M <= I ? (int)C_MLEI : 0);
      if constexpr (QV) {
        const float cd = tgt == dtag ? delq : dpri;
        arr(A_CD)[c] = cd;
        run = __fadd_rn(run, cd);
        arr(A_QS)[c] = run;
      } else {
        const float g = base < HALF_INF
                            ? __fsub_rn(base, __fmul_rn(a.del_ext, (float)c))
                            : INF_F;
        run = fminf(run, g);
        arr(A_G)[c] = run;
      }
    }
    if constexpr (QV) {
      // S, the inclusive prefix sum of cd over the band, then g = base - S
      // and its running min
      float incl;
      const float ex = block_scan(run, 0.0f, wtot[0], AddOp(), incl);
      run = INF_F;
      for (int c = c_lo; c < c_hi; ++c) {
        const float S = __fadd_rn(ex, arr(A_QS)[c]);
        arr(A_QS)[c] = S;
        const float base = arr(A_BASE)[c];
        const float g = base < HALF_INF ? __fsub_rn(base, S) : INF_F;
        run = fminf(run, g);
        arr(A_G)[c] = run;
      }
    }
    // the exclusive prefix-min of g over the band: this thread's cells
    // see the min over the threads before it and their own running min
    float incl;
    const float gex = block_scan(run, INF_F, wtot[1], MinOp(), incl);

    // pass 2: D, the open bits, the run counters and the cell word
    const int s_clip = min(s, 3);
    for (int c = c_lo; c < c_hi; ++c) {
      const int t_abs = o_r + c;
      const bool in_t = t_abs >= ta && t_abs < tb;
      const float run_prev = c == c_lo ? gex : fminf(gex, arr(A_G)[c - 1]);
      float D;
      const float bprev = c > 0 ? arr(A_BASE)[c - 1] : INF_F;
      bool d_open;
      if constexpr (QV) {
        const float S = arr(A_QS)[c];
        D = in_t ? __fadd_rn(S, run_prev) : INF_F;
        D = fminf(D, INF_F);
        d_open = D >= __fadd_rn(bprev, arr(A_CD)[c]);
      } else {
        D = in_t ? __fadd_rn(__fadd_rn(__fmul_rn(a.del_ext, (float)c),
                                       run_prev),
                             a.del_open - a.del_ext)
                 : INF_F;
        D = fminf(D, INF_F);
        d_open = D >= __fadd_rn(bprev, a.del_open);
      }
      const int code = iarr(A_CODE)[c];
      const int d_from_m = c > 0 ? ((iarr(A_CODE)[c - 1] & C_MLEI) ? 1 : 0)
                                 : 1;
      const int msrc = code & 3;
      const int eq = (code >> 5) & 1;
      const int jd = c + sd - 1;
      const bool okd = jd >= 0 && jd < w_b;
      const int dC = okd ? pC[jd] : 0;
      const int dS = okd ? pS[jd] : 0;
      const int dR = (dC >> 2) & 63, dE = (dC >> 8) & 63, dX = dC & 3;
      const bool fresh = msrc != ST_M || first || dR >= RUN_CAP;
      const int mrun = fresh ? 1 : dR + 1;
      const int meq = (fresh ? 0 : dE) + eq;
      const int rexit = fresh ? msrc : dX;
      const int ssum = s > 2 ? 127 : min(fresh ? s : dS + s, 127);
      const unsigned bits =
          (unsigned)msrc | ((unsigned)(code & 4)) | (d_open ? 8u : 0u) |
          ((unsigned)d_from_m << 4) | ((unsigned)(code & 96)) |
          ((unsigned)rexit << 7) | ((unsigned)mrun << 9) |
          ((unsigned)meq << 15) | ((unsigned)s_clip << 21) |
          ((unsigned)ssum << 23);
      row_out[c] = (int32_t)bits;
      nD[c] = D;
      nC[c] = rexit | (mrun << 2) | (meq << 8);
      nS[c] = ssum;
      if (r == qb - 1 && c == tb - 1 - o_r) {  // final (score, state)
        const float cM = nM[c], cI = nI[c];
        float cbest = fminf(cM, fminf(cI, D));
        int clast = ST_D;
        if constexpr (HP) {
          const float cH = nH[c];
          cbest = fminf(cbest, cH);
          clast = D <= cbest ? ST_D : ST_H;
        }
        if (cbest < HALF_INF) {
          fin_score = cbest;
          fin_state = cM <= cbest ? ST_M : (cI <= cbest ? ST_I : clast);
          fin_ok = 1;
        }
      }
    }
    po = o_r;
    cur ^= 1;
    __syncthreads();
  }
  if (tid == 0) {
    a.score[n] = fin_score;
    a.state[n] = fin_state;
    a.valid[n] = fin_ok ? 1 : 0;
  }
}

template <bool QV, bool HP, bool GEN>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(banded_dp_wide_kernel<QV, HP, GEN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_DYNAMIC_MAX);
}

template <bool QV, bool HP, bool GEN>
int launch(const Args& a, int threads, size_t smem, void* stream) {
  banded_dp_wide_kernel<QV, HP, GEN>
      <<<a.N, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The workspace of one item at band width w_b, in bytes: dynamic shared
// memory up to blasr_banded_dp_wide_max_smem(), else a global scratch of
// N times it that the caller passes.
extern "C" size_t blasr_banded_dp_wide_ws_bytes(int w_b) {
  return (size_t)NARR * (size_t)w_b * sizeof(float);
}

extern "C" int blasr_banded_dp_wide_max_smem() { return SMEM_DYNAMIC_MAX; }

// Every mode's opt-in to its dynamic shared memory, on the current device;
// called once per device before any launch (blasr_setup_kernels), never
// while a stream is captured.
extern "C" int blasr_banded_dp_wide_setup() {
  const cudaError_t errs[] = {
      opt_in<false, false, false>(), opt_in<true, false, false>(),
      opt_in<false, true, false>(),  opt_in<false, true, true>(),
      opt_in<true, false, true>(),   opt_in<false, false, true>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

// K1-W in the mode its arguments ask for: qv1/qv2 non-null the QV form,
// hp != 0 the hp band (not with QV), gen != 0 the general matrix
// ``submat`` (25 floats in host memory, read base major; copied into the
// launch's arguments) in place of match / mismatch.  ``scratch`` holds
// N * blasr_banded_dp_wide_ws_bytes(w_b) bytes where that is more than
// blasr_banded_dp_wide_max_smem(), else it may be null.
extern "C" int blasr_banded_dp_wide(
    const int8_t* reads, const int8_t* windows, const int32_t* offsets,
    const int32_t* qa, const int32_t* qb, const int32_t* ta,
    const int32_t* tb, const int32_t* qv1, const int32_t* qv2, int N, int L,
    int W, int w_b, int hp, int gen, const float* submat, float match,
    float mismatch, float ins_open, float ins_ext, float del_open,
    float del_ext, float hp_open, float hp_ext, float* scratch,
    float* score, int32_t* tbbits, int32_t* final_state, uint8_t* valid,
    void* stream) {
  const bool qv = qv1 != nullptr;
  if (w_b < 1 || (qv && hp) || (qv && qv2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t ws = blasr_banded_dp_wide_ws_bytes(w_b);
  const bool in_smem = ws <= (size_t)SMEM_DYNAMIC_MAX;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = min(32 * ((w_b + 31) / 32), MAX_THREADS);
  const int cpt = (w_b + threads - 1) / threads;
  Args a{reads, windows, offsets, qa, qb, ta, tb, qv1, qv2, N, L, W, w_b,
         cpt, match, mismatch, ins_open, ins_ext, del_open, del_ext,
         hp_open, hp_ext, {}, in_smem ? nullptr : scratch, score, tbbits,
         final_state, valid};
  if (gen)
    for (int k = 0; k < 25; ++k) a.submat[k] = submat[k];
  const size_t smem = in_smem ? ws : 0;
  if (qv) {
    return gen ? launch<true, false, true>(a, threads, smem, stream)
               : launch<true, false, false>(a, threads, smem, stream);
  }
  if (hp) {
    return gen ? launch<false, true, true>(a, threads, smem, stream)
               : launch<false, true, false>(a, threads, smem, stream);
  }
  return gen ? launch<false, false, true>(a, threads, smem, stream)
             : launch<false, false, false>(a, threads, smem, stream);
}
