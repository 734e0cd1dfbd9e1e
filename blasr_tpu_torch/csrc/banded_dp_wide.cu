// K1-W: guided banded DP, forward pass, at any band width, in the six
// compile-time modes <QV, HP, GEN> of K1.
//
// Replaces blasr_tpu/kernels/banded.py::banded_align (banded.py:363,
// `_align_one` at banded.py:100) at band widths other than 128, where the
// JAX Mapper runs the XLA kernel (its Pallas kernel and the port's K1,
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
// Two layouts, by band width:
//
// * Up to 256 cells (WARP_MAX_WB), the warp-specialised design: K1's
//   layout with the band held in one warp's registers, CPL = ceil(w_b /
//   32) cells a lane (a template parameter, 1..8), the band padded to 32 *
//   CPL cells whose pad cells stay INF and are never stored.  One CTA of
//   three warps per item, decoupled by double-buffered mbarrier rings of
//   R = 16-row tiles:
//     - warp 0 (row inputs) writes one flag word per cell (eq, in_t,
//       in_t_i; QV: the tag matches and the prefix sum S of cd, by a
//       CPL-cell serial sum and a 5-step shuffle scan; HP: in_t_i & hp_ok;
//       GEN: the target code), the row's scalars and, at row qa, the
//       boundary deletion profile;
//     - warp 1 (the recurrence) carries M/I/D (and H) in registers: the
//       shifted predecessors by shuffles and selects (below), M, I, the
//       deletion closed form's exclusive prefix-min (a CPL-cell serial scan,
//       then a 5-step __shfl_up scan), D, and a code byte per cell.  No
//       block barrier lies in the row's chain;
//     - warp 2 (the cell words) carries the M-run counters and ssum, packs
//       each cell word and stages the tile's R * w_b words in shared
//       memory, which leave by one cp.async.bulk store.
//   The shift is uniform across the warp, so a lane's CPL predecessors come
//   from two source lanes (lane + q and lane + q + 1, q = floor(b / CPL))
//   by 2 * CPL shuffles, then a log2(CPL)-stage barrel shift by b mod CPL
//   made of selects: no register array is indexed dynamically and no
//   branch goes around a shuffle.  A source lane outside the warp, a cell
//   past w_b (a pad cell) or the diagonal of a step back by one (the
//   slice's start wraps past the row) reads the fill value.
//   Bulk stores need 16-byte aligned addresses and sizes.  The staging
//   slot is skewed by the tile's global address mod 16, so the tile's
//   16-byte aligned interior leaves by cp.async.bulk and its first and last
//   (at most three) words by plain stores: every width, every L and any
//   tbbits address take the same path.
// * Above 256 cells, the first design (kept unchanged): one CTA
//   per item, one thread per band cell (T = min(32 * ceil(w_b / 32), 1024)
//   threads, cpt = ceil(w_b / T) cells a thread), every per-cell value that
//   crosses a thread in a workspace of NARR arrays of w_b words (dynamic
//   shared memory up to SMEM_DYNAMIC_MAX, ~3,300 cells, above that a global
//   scratch the wrapper allocates), three block-wide barriers a row (four
//   in QV mode) around a block prefix of min(g) (and of cd).  Widths above
//   256 have no user in the repo's configurations (ShapeConfig's default
//   is 128; the tests and the smoke take 48, 64 and 256 on the main path),
//   and a band past one warp's registers needs its warps to trade edge
//   cells and prefix carries every row, so this design stays there and its
//   times stay in PERF.md.
//
// Arithmetic: every cost is an integer below 2^24, so the sums are exact
// in any order (S is held in a full float, exact while it stays below
// 2^24; the warp design packs it in 16 bits of the flag word, S <= 256 *
// 255); the float operations keep the plain version's order through the
// _rn intrinsics, which nvcc never contracts into an FMA, and the sources
// build without --use_fast_math.
//
// What bounds it on an H100: the row's dependent chain (in the warp design
// the shuffles of the shift and of the prefix-min scan, one warp advancing
// one item a row at a time, the chain's latency hidden by the CTAs beside
// it on the SM), then the cell-word stream, N * L * w_b * 4 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

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

// ------------------------------------------------------------------------
// The first design, above WARP_MAX_WB cells.

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
__global__ void __launch_bounds__(MAX_THREADS) banded_dp_wide_block_kernel(Args a) {
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
cudaError_t opt_in_block() {
  return cudaFuncSetAttribute(banded_dp_wide_block_kernel<QV, HP, GEN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_DYNAMIC_MAX);
}

template <bool QV, bool HP, bool GEN>
int launch_block(const Args& a, int threads, size_t smem, void* stream) {
  banded_dp_wide_block_kernel<QV, HP, GEN>
      <<<a.N, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------------------
// The warp-specialised design, up to WARP_MAX_WB cells.

constexpr int R = 16;  // rows per tile
constexpr int MAX_CPL = 8;
constexpr int WARP_MAX_WB = 32 * MAX_CPL;
constexpr int WARP_THREADS = 96;

// the row-input stage's flag word per cell: bits 0-5, the target code
// (GEN) at bits 8-10, the QV prefix sum S at bits 16-31
constexpr unsigned F_EQ = 1u, F_IN_T = 2u, F_IN_TI = 4u, F_STAG = 8u,
                   F_DTAG = 16u, F_IN_TH = 32u;
constexpr int F_TGT_SHIFT = 8;
// the recurrence's code byte per cell: the cell word's bits 0-3, 5 and 6
// (msrc, i_open, d_open, eq, h_open) as they are, and at bit 4 M <= I,
// which is the next cell's d_from_m (cell-word bit 4)
constexpr unsigned K_MLEI = 16u, K_WORD = 0x6Fu;
constexpr int GEN_SUB = 5;

// a row's scalars: offset, shift, QV costs and (HP) whether the row can
// take the hp band, read[r] == read[r-1] < 4
struct RowScalars {
  int o_r, s;
  float insq, dpri, subq, spri, delq;
  int hp_ok;
};

// The rings between the three warps, double-buffered R-row tiles; cell j
// of lane l at [j][l], so every warp's access is one word (or byte) a
// lane, consecutive.  The cell-word staging follows at stage_offset().
template <int CPL>
struct WSmem {
  unsigned flags[2][R][CPL][32];
  unsigned char code[2][R][CPL][32];
  RowScalars sc[2][R];
  int shift[2][R];
  float bd[CPL][32];                 // boundary deletion profile, row qa
  float gsub[2][R][GEN_SUB];         // GEN: the row's matrix entries
  unsigned long long full[2], empty[2];    // row inputs <-> recurrence
  unsigned long long full2[2], empty2[2];  // recurrence <-> cell words
};

// a staging slot: one tile's R * w_b words after a skew of up to three
// words, in whole 16-byte units
__host__ __device__ constexpr int stage_words(int w_b) {
  return (R * w_b + 3 + 3) & ~3;
}
template <int CPL>
__host__ __device__ constexpr size_t stage_offset() {
  return (sizeof(WSmem<CPL>) + 15) & ~(size_t)15;
}
template <int CPL>
constexpr size_t warp_smem_bytes(int w_b) {
  return stage_offset<CPL>() + 2 * (size_t)stage_words(w_b) * 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A row's band shift, uniform across the warp.  The diagonal predecessor
// of cell c is cell c + kd, the vertical one c + kv (kd = slice_start(s)
// - 1, kv = slice_start(s + 1) - 1, fill outside [0, w_b)).  The warp
// reads one window win[m] = cell CPL * lane + m + b, m in [0, CPL], b =
// kv - 1 = q * CPL + rem, so that v[j] = win[j + 1] and d[j] = win[j]
// (kd = kv - 1: every 0 <= s < w_b and most negative s), win[j + 1] (kd =
// kv: both slices clamp to the same start) or the fill (dmode 2: s = -1,
// whose diagonal slice starts past the row, kd = w_b).
struct Shift {
  int q, rem, dmode;
};

__device__ __forceinline__ Shift row_shift(int s, int w_b, int cpl) {
  const int kd = slice_start(s, w_b) - 1;
  const int kv = slice_start(s + 1, w_b) - 1;
  const int b = kv - 1;
  const int q = b >= 0 ? b / cpl : -((cpl - 1 - b) / cpl);
  return Shift{q, b - q * cpl, kd == b ? 0 : (kd == kv ? 1 : 2)};
}

// win[m] = x at cell CPL * lane + m + b (see Shift): the lane's CPL
// registers of lanes lane + q and lane + q + 1 (2 * CPL shuffles, the
// fill for a lane outside the warp), then a barrel shift by rem in
// log2(CPL) stages of selects.  Cells past w_b hold the fill already.
template <int CPL, typename T>
__device__ __forceinline__ void band_window(const T (&x)[CPL], const Shift& sh,
                                            T fill, int lane,
                                            T (&win)[CPL + 1]) {
  const int la = lane + sh.q, lb = la + 1;
  const bool oka = (unsigned)la < 32u, okb = (unsigned)lb < 32u;
  T e[2 * CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const T va = __shfl_sync(FULL, x[k], la & 31);
    const T vb = __shfl_sync(FULL, x[k], lb & 31);
    e[k] = oka ? va : fill;
    e[CPL + k] = okb ? vb : fill;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // bits 1, 2, 4 of rem < CPL <= 8
    const int bit = 1 << k;
    const bool take = ((sh.rem >> k) & 1) != 0;
#pragma unroll
    for (int i = 0; i < 2 * CPL; ++i)
      if (bit < CPL && i + bit < 2 * CPL) e[i] = take ? e[i + bit] : e[i];
  }
#pragma unroll
  for (int m = 0; m <= CPL; ++m) win[m] = e[m];
}

// the diagonal (d) and vertical (v) predecessors of the lane's cells
template <int CPL, typename T>
__device__ __forceinline__ void shift_dv(const T (&x)[CPL], const Shift& sh,
                                         T fill, int lane, T (&d)[CPL],
                                         T (&v)[CPL]) {
  T win[CPL + 1];
  band_window<CPL>(x, sh, fill, lane, win);
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    v[j] = win[j + 1];
    d[j] = sh.dmode == 0 ? win[j] : (sh.dmode == 1 ? win[j + 1] : fill);
  }
}

template <int CPL, typename T>
__device__ __forceinline__ void shift_d(const T (&x)[CPL], const Shift& sh,
                                        T fill, int lane, T (&d)[CPL]) {
  T win[CPL + 1];
  band_window<CPL>(x, sh, fill, lane, win);
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    d[j] = sh.dmode == 0 ? win[j] : (sh.dmode == 1 ? win[j + 1] : fill);
}

// the inclusive prefix sum over the band of x (CPL cells a lane): a
// serial sum per lane, then a 5-step __shfl_up scan of the lane totals.
// The inputs are integers, so the sums are exact in any order.
template <int CPL>
__device__ __forceinline__ void band_cumsum(const float (&x)[CPL], int lane,
                                            float (&out)[CPL]) {
  out[0] = x[0];
#pragma unroll
  for (int j = 1; j < CPL; ++j) out[j] = __fadd_rn(out[j - 1], x[j]);
  float scan = out[CPL - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(FULL, scan, d);
    if (lane >= d) scan = __fadd_rn(y, scan);
  }
  float excl = __shfl_up_sync(FULL, scan, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) out[j] = __fadd_rn(excl, out[j]);
}

// Warp 0: the row-input stage of item n.
template <int CPL, bool QV, bool HP, bool GEN>
__device__ void w_row_inputs(const Args& a, WSmem<CPL>& sm, int n, int lane) {
  const int L = a.L, W = a.W, w_b = a.w_b;
  const int qa = a.qa[n], qb = a.qb[n], ta = a.ta[n], tb = a.tb[n];
  const int8_t* rd = a.reads + (size_t)n * L;
  const int8_t* win = a.windows + (size_t)n * W;
  const int32_t* off = a.offsets + (size_t)n * L;
  const int c0 = CPL * lane;
  const int ntiles = (L + R - 1) / R;
  for (int t = 0; t < ntiles; ++t) {
    const int slot = t & 1, use = t >> 1;
    if (use > 0) mbar_wait(&sm.empty[slot], (use - 1) & 1);
    const int r0 = t * R, nr = min(R, L - r0);
    int my_o = 0, my_prev = 0, my_rb = 4, my_rbp = 4;
    unsigned my_w1 = 0, my_w2 = 0;
    if (lane < nr && r0 + lane >= qa && r0 + lane < qb) {
      const int r = r0 + lane;
      my_o = __ldg(off + r);
      my_prev = r > 0 ? __ldg(off + r - 1) : 0;
      my_rb = __ldg(rd + r);
      if constexpr (HP) my_rbp = r > 0 ? __ldg(rd + r - 1) : 4;
      if constexpr (QV) {
        my_w1 = (unsigned)__ldg(a.qv1 + (size_t)n * L + r);
        my_w2 = (unsigned)__ldg(a.qv2 + (size_t)n * L + r);
      }
    }
    for (int i = 0; i < nr; ++i) {
      const int r = r0 + i;
      const int o_r = __shfl_sync(FULL, my_o, i);
      const int prev = __shfl_sync(FULL, my_prev, i);
      const int rb = __shfl_sync(FULL, my_rb, i);
      if (r < qa || r >= qb) continue;  // uniform
      const bool first = r == qa;
      RowScalars sc{o_r, first ? 0 : o_r - prev, 0.f, 0.f, 0.f, 0.f, 0.f,
                    0};
      int dtag = 7, stag = 7;
      bool hp_ok = false;
      if constexpr (HP) {
        const int rbp = __shfl_sync(FULL, my_rbp, i);
        hp_ok = rb == rbp && rbp < 4;
        sc.hp_ok = hp_ok;
      }
      if constexpr (GEN) {
        if (lane < GEN_SUB)
          sm.gsub[slot][i][lane] = a.submat[rb * GEN_SUB + lane];
      }
      if constexpr (QV) {
        const unsigned w1 = __shfl_sync(FULL, my_w1, i);
        const unsigned w2 = __shfl_sync(FULL, my_w2, i);
        sc.insq = (float)(w1 & 255u);
        sc.delq = (float)((w1 >> 8) & 255u);
        sc.subq = (float)((w1 >> 16) & 255u);
        dtag = (int)((w1 >> 24) & 7u);
        stag = (int)((w1 >> 27) & 7u);
        sc.dpri = (float)(w2 & 255u);
        sc.spri = (float)((w2 >> 8) & 255u);
      }
      const int tstart = min(max(o_r, 0), W);
      unsigned fl[CPL];
      float cd[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = c0 + j;
        const bool band = c < w_b;
        const int ti = tstart + c;
        const int tgt = band && ti < W ? (int)__ldg(win + ti) : 4;
        const int t_abs = o_r + c;
        fl[j] = 0u;
        cd[j] = 0.0f;
        if (band) {
          fl[j] = ((rb == tgt) && (rb < 4) ? F_EQ : 0u) |
                  ((t_abs >= ta) && (t_abs < tb) ? F_IN_T : 0u) |
                  ((t_abs >= ta - 1) && (t_abs < tb) ? F_IN_TI : 0u);
          if constexpr (QV) {
            fl[j] |= (tgt == stag ? F_STAG : 0u) | (tgt == dtag ? F_DTAG : 0u);
            cd[j] = tgt == dtag ? sc.delq : sc.dpri;
          }
          if constexpr (HP) {
            if (hp_ok && t_abs >= ta - 1 && t_abs < tb) fl[j] |= F_IN_TH;
          }
          if constexpr (GEN) fl[j] |= (unsigned)tgt << F_TGT_SHIFT;
        }
      }
      if constexpr (QV) {
        float S[CPL];
        band_cumsum<CPL>(cd, lane, S);
#pragma unroll
        for (int j = 0; j < CPL; ++j) fl[j] |= (unsigned)(int)S[j] << 16;
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j) sm.flags[slot][i][j][lane] = fl[j];
      if (lane == 0) sm.sc[slot][i] = sc;
      if (first) {
        // the boundary row qa - 1: leading deletions from ta on
        float bd[CPL];
        if constexpr (QV) {
          // the running sum of row qa's cd over the window columns from
          // ta (t < W): the columns left of the band, then the band
          const int t0 = max(ta, 0);
          float pre = 0.0f;
          for (int t = t0 + lane; t < min(o_r, W); t += 32)
            pre = __fadd_rn(pre, (int)__ldg(win + t) == dtag ? sc.delq
                                                             : sc.dpri);
#pragma unroll
          for (int d = 16; d > 0; d >>= 1)
            pre = __fadd_rn(pre, __shfl_xor_sync(FULL, pre, d));
          float m[CPL], prof[CPL];
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int t_abs = o_r + c0 + j;
            m[j] = (c0 + j < w_b && t_abs >= t0 && t_abs < W)
                       ? ((int)__ldg(win + t_abs) == dtag ? sc.delq : sc.dpri)
                       : 0.0f;
          }
          band_cumsum<CPL>(m, lane, prof);
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            bd[j] = c0 + j < w_b && o_r + c0 + j >= ta ? __fadd_rn(pre, prof[j])
                                                       : INF_F;
        } else {
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int t_abs = o_r + c0 + j;
            bd[j] = c0 + j < w_b && t_abs >= ta
                        ? __fadd_rn(a.del_open,
                                    __fmul_rn(a.del_ext, (float)(t_abs - ta)))
                        : INF_F;
          }
        }
#pragma unroll
        for (int j = 0; j < CPL; ++j) sm.bd[j][lane] = bd[j];
      }
    }
    mbar_arrive(&sm.full[slot]);
  }
}

// Warp 1: the recurrence of item n, the first design's arithmetic on
// registers.  Only the M/I/D (and H) carries cross rows here; the run
// counters and the cell word are warp 2's.
template <int CPL, bool QV, bool HP, bool GEN>
__device__ void w_recurrence(const Args& a, WSmem<CPL>& sm, int n, int lane) {
  const int L = a.L, w_b = a.w_b;
  const int qa = a.qa[n], qb = a.qb[n], ta = a.ta[n], tb = a.tb[n];
  const int c0 = CPL * lane;
  float pM[CPL], pI[CPL], pD[CPL], pH[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    pM[j] = INF_F; pI[j] = INF_F; pD[j] = INF_F; pH[j] = INF_F;
  }
  float fin_score = INF_F;
  int fin_state = ST_M;
  bool fin_ok = false;

  const int ntiles = (L + R - 1) / R;
  for (int t = 0; t < ntiles; ++t) {
    const int slot = t & 1, use = t >> 1;
    const int r0 = t * R, nr = min(R, L - r0);
    mbar_wait(&sm.full[slot], use & 1);
    if (use > 0) mbar_wait(&sm.empty2[slot], (use - 1) & 1);
    for (int i = 0; i < nr; ++i) {
      const int r = r0 + i;
      if (r < qa || r >= qb) continue;  // uniform
      const RowScalars& sc = sm.sc[slot][i];
      const int o_r = sc.o_r, s = sc.s;
      unsigned fl[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) fl[j] = sm.flags[slot][i][j][lane];
      if (r == qa) {  // the boundary row qa - 1 replaces the carries
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          pM[j] = c0 + j < w_b && o_r + c0 + j == ta - 1 ? 0.0f : INF_F;
          pI[j] = INF_F;
          pH[j] = INF_F;
          pD[j] = sm.bd[j][lane];
        }
      }
      const Shift sh = row_shift(s, w_b, CPL);
      float dM[CPL], vM[CPL], dI[CPL], vI[CPL], dD[CPL], dH[CPL], vH[CPL];
      shift_dv<CPL>(pM, sh, INF_F, lane, dM, vM);
      shift_dv<CPL>(pI, sh, INF_F, lane, dI, vI);
      shift_d<CPL>(pD, sh, INF_F, lane, dD);
      if constexpr (HP) shift_dv<CPL>(pH, sh, INF_F, lane, dH, vH);

      float M[CPL], I[CPL], H[CPL], base[CPL], g[CPL], S[CPL], cd[CPL];
      unsigned code[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = c0 + j;
        const bool in_t = fl[j] & F_IN_T;
        const bool in_t_i = fl[j] & F_IN_TI;
        const bool eq = fl[j] & F_EQ;
        float sub;
        if constexpr (GEN) {
          const float gs = sm.gsub[slot][i][(fl[j] >> F_TGT_SHIFT) & 7u];
          if constexpr (QV) {
            sub = eq ? gs : ((fl[j] & F_STAG) ? sc.subq : sc.spri);
          } else {
            sub = gs;
          }
        } else if constexpr (QV) {
          sub = eq ? a.match : ((fl[j] & F_STAG) ? sc.subq : sc.spri);
        } else {
          sub = eq ? a.match : a.mismatch;
        }
        float db = fminf(dM[j], fminf(dI[j], dD[j]));
        int last = ST_D;
        if constexpr (HP) {
          db = fminf(db, dH[j]);
          last = dD[j] <= db ? ST_D : ST_H;
        }
        const int msrc = dM[j] <= db ? ST_M : (dI[j] <= db ? ST_I : last);
        M[j] = in_t ? __fadd_rn(sub, db) : INF_F;
        float ifm, ifi;
        if constexpr (QV) {
          ifm = __fadd_rn(vM[j], sc.insq);
          ifi = __fadd_rn(vI[j], sc.insq);
        } else {
          ifm = __fadd_rn(vM[j], a.ins_open);
          ifi = __fadd_rn(vI[j], a.ins_ext);
        }
        I[j] = in_t_i ? fminf(ifm, ifi) : INF_F;
        base[j] = fminf(M[j], I[j]);
        bool hopen = false;
        H[j] = INF_F;
        if constexpr (HP) {
          const float hfm = __fadd_rn(vM[j], a.hp_open);
          const float hfh = __fadd_rn(vH[j], a.hp_ext);
          H[j] = (fl[j] & F_IN_TH) ? fminf(hfm, hfh) : INF_F;
          hopen = hfm <= hfh;
          base[j] = fminf(base[j], H[j]);
        }
        if constexpr (QV) {
          S[j] = (float)(fl[j] >> 16);
          cd[j] = (fl[j] & F_DTAG) ? sc.delq : sc.dpri;
          g[j] = base[j] < HALF_INF ? __fsub_rn(base[j], S[j]) : INF_F;
        } else {
          g[j] = base[j] < HALF_INF
                     ? __fsub_rn(base[j], __fmul_rn(a.del_ext, (float)c))
                     : INF_F;
        }
        code[j] = (unsigned)msrc | (ifm <= ifi ? 4u : 0u) | (eq ? 32u : 0u) |
                  (hopen ? 64u : 0u) | (M[j] <= I[j] ? K_MLEI : 0u);
      }
      // the exclusive prefix-min of g over the band
      float incl[CPL];
      incl[0] = g[0];
#pragma unroll
      for (int j = 1; j < CPL; ++j) incl[j] = fminf(incl[j - 1], g[j]);
      float scan = incl[CPL - 1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float y = __shfl_up_sync(FULL, scan, d);
        if (lane >= d) scan = fminf(scan, y);
      }
      float excl = __shfl_up_sync(FULL, scan, 1);
      if (lane == 0) excl = INF_F;
      float base_l = __shfl_up_sync(FULL, base[CPL - 1], 1);
      if (lane == 0) base_l = INF_F;

      float Dn[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = c0 + j;
        const bool in_t = fl[j] & F_IN_T;
        const float run_prev = j == 0 ? excl : fminf(excl, incl[j - 1]);
        const float bprev = j == 0 ? base_l : base[j - 1];
        float D;
        bool d_open;
        if constexpr (QV) {
          D = in_t ? __fadd_rn(S[j], run_prev) : INF_F;
          D = fminf(D, INF_F);
          d_open = D >= __fadd_rn(bprev, cd[j]);
        } else {
          D = in_t ? __fadd_rn(__fadd_rn(__fmul_rn(a.del_ext, (float)c),
                                         run_prev),
                               a.del_open - a.del_ext)
                   : INF_F;
          D = fminf(D, INF_F);
          d_open = D >= __fadd_rn(bprev, a.del_open);
        }
        if (d_open) code[j] |= 8u;
        Dn[j] = D;
        sm.code[slot][i][j][lane] = (unsigned char)code[j];
      }
      if (lane == 0) sm.shift[slot][i] = s;

      if (r == qb - 1) {  // the final (score, state) at cell t = tb - 1
        const int wf = tb - 1 - o_r;
        if (wf >= 0 && wf < w_b) {
          const int src = wf / CPL, jj = wf - src * CPL;
          float cM0 = M[0], cI0 = I[0], cD0 = Dn[0], cH0 = H[0];
#pragma unroll
          for (int j = 1; j < CPL; ++j) {
            if (j == jj) {
              cM0 = M[j]; cI0 = I[j]; cD0 = Dn[j]; cH0 = H[j];
            }
          }
          const float cM = __shfl_sync(FULL, cM0, src);
          const float cI = __shfl_sync(FULL, cI0, src);
          const float cD = __shfl_sync(FULL, cD0, src);
          float cbest = fminf(cM, fminf(cI, cD));
          int clast = ST_D;
          if constexpr (HP) {
            const float cH = __shfl_sync(FULL, cH0, src);
            cbest = fminf(cbest, cH);
            clast = cD <= cbest ? ST_D : ST_H;
          }
          if (cbest < HALF_INF) {
            fin_score = cbest;
            fin_state = cM <= cbest ? ST_M : (cI <= cbest ? ST_I : clast);
            fin_ok = true;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        pM[j] = M[j]; pI[j] = I[j]; pD[j] = Dn[j];
        if constexpr (HP) pH[j] = H[j];
      }
    }
    mbar_arrive(&sm.empty[slot]);  // the row inputs of the slot are read
    mbar_arrive(&sm.full2[slot]);  // its code bytes are written
  }
  if (lane == 0) {
    a.score[n] = fin_score;
    a.state[n] = fin_state;
    a.valid[n] = fin_ok ? 1 : 0;
  }
}

// Warp 2: the cell words of item n.  It carries the run counters C =
// rexit | mrun << 2 | meq << 8 and ssum (any sign: a band may step back),
// shifted with the diagonal, and stages each tile's words in a slot of
// ``stage`` skewed by the tile's address mod 16: the 16-byte aligned
// interior leaves in one bulk store, the (at most three) words before and
// after it by plain stores.
template <int CPL>
__device__ void w_cell_words(const Args& a, WSmem<CPL>& sm, int32_t* stage,
                             int n, int lane) {
  const int L = a.L, w_b = a.w_b;
  const int qa = a.qa[n], qb = a.qb[n];
  const int c0 = CPL * lane;
  const int sw = stage_words(w_b);
  int pC[CPL], pS[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    pC[j] = 0;
    pS[j] = 0;
  }
  int32_t* item = a.tbbits + (size_t)n * L * (size_t)w_b;
  const int ntiles = (L + R - 1) / R;
  for (int t = 0; t < ntiles; ++t) {
    const int slot = t & 1, use = t >> 1;
    const int r0 = t * R, nr = min(R, L - r0);
    mbar_wait(&sm.full2[slot], use & 1);
    if (t >= 2) {
      // the bulk store of tile t - 2 has read this staging slot
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncwarp();
    }
    int32_t* dst = item + (size_t)r0 * w_b;
    const int skew = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3u);
    int32_t* st = stage + slot * sw + skew;
    for (int i = 0; i < nr; ++i) {
      const int r = r0 + i;
      int32_t* row = st + i * w_b;
      if (r < qa || r >= qb) {  // uniform
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          if (c0 + j < w_b) row[c0 + j] = 0;
        continue;
      }
      const bool first = r == qa;
      const int s = sm.shift[slot][i];
      const Shift sh = row_shift(s, w_b, CPL);
      unsigned k[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) k[j] = sm.code[slot][i][j][lane];
      unsigned kl = __shfl_up_sync(FULL, k[CPL - 1], 1);
      if (lane == 0) kl = K_MLEI;  // left of cell 0: INF <= INF
      int dC[CPL], dS[CPL];
      shift_d<CPL>(pC, sh, 0, lane, dC);
      shift_d<CPL>(pS, sh, 0, lane, dS);
      const int s_clip = min(s, 3);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const unsigned left = j == 0 ? kl : k[j - 1];
        const int msrc = (int)(k[j] & 3u);
        const int eq = (int)((k[j] >> 5) & 1u);
        const int dR = (dC[j] >> 2) & 63, dE = (dC[j] >> 8) & 63,
                  dX = dC[j] & 3;
        const bool fresh = msrc != ST_M || first || dR >= RUN_CAP;
        const int mrun = fresh ? 1 : dR + 1;
        const int meq = (fresh ? 0 : dE) + eq;
        const int rexit = fresh ? msrc : dX;
        const int ssum = s > 2 ? 127 : min(fresh ? s : dS[j] + s, 127);
        const unsigned bits =
            (k[j] & K_WORD) | (left & K_MLEI) | ((unsigned)rexit << 7) |
            ((unsigned)mrun << 9) | ((unsigned)meq << 15) |
            ((unsigned)s_clip << 21) | ((unsigned)ssum << 23);
        if (c0 + j < w_b) {
          row[c0 + j] = (int32_t)bits;
          pC[j] = rexit | (mrun << 2) | (meq << 8);
          pS[j] = ssum;
        }
      }
    }
    mbar_arrive(&sm.empty2[slot]);  // the slot's code bytes are read
    // the tile leaves: words [h, e) by one bulk store, 16-byte aligned in
    // both spaces, the words before h and from e on by plain stores
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    const int T = nr * w_b;
    const int h = min((4 - skew) & 3, T);
    const int e = max(((skew + T) & ~3) - skew, h);
    if (lane == 0) {
      if (e > h) {
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                dst + h),
            "r"(smem_addr(st + h)), "r"((e - h) * 4)
            : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (lane < h) dst[lane] = st[lane];
    for (int idx = e + lane; idx < T; idx += 32) dst[idx] = st[idx];
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int CPL, bool QV, bool HP, bool GEN>
__global__ void __launch_bounds__(WARP_THREADS)
    banded_dp_wide_warp_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WSmem<CPL>& sm = *reinterpret_cast<WSmem<CPL>*>(smem_raw);
  int32_t* stage = reinterpret_cast<int32_t*>(smem_raw + stage_offset<CPL>());
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(&sm.full[k], 32);
      mbar_init(&sm.empty[k], 32);
      mbar_init(&sm.full2[k], 32);
      mbar_init(&sm.empty2[k], 32);
    }
  }
  __syncthreads();
  if (warp == 0) {
    w_row_inputs<CPL, QV, HP, GEN>(a, sm, n, lane);
  } else if (warp == 1) {
    w_recurrence<CPL, QV, HP, GEN>(a, sm, n, lane);
  } else {
    w_cell_words<CPL>(a, sm, stage, n, lane);
  }
}

template <int CPL, bool QV, bool HP, bool GEN>
cudaError_t opt_in_warp() {
  return cudaFuncSetAttribute(banded_dp_wide_warp_kernel<CPL, QV, HP, GEN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)warp_smem_bytes<CPL>(32 * CPL));
}

// every CPL's opt-in of one mode
template <bool QV, bool HP, bool GEN, int... C>
cudaError_t opt_in_warps(std::integer_sequence<int, C...>) {
  cudaError_t e = cudaSuccess;
  ((e = e != cudaSuccess ? e : opt_in_warp<C + 1, QV, HP, GEN>()), ...);
  return e;
}

template <bool QV, bool HP, bool GEN>
cudaError_t opt_in() {
  const cudaError_t e = opt_in_block<QV, HP, GEN>();
  if (e != cudaSuccess) return e;
  return opt_in_warps<QV, HP, GEN>(std::make_integer_sequence<int, MAX_CPL>());
}

template <int CPL, bool QV, bool HP, bool GEN>
int launch_cpl(const Args& a, void* stream) {
  banded_dp_wide_warp_kernel<CPL, QV, HP, GEN>
      <<<a.N, WARP_THREADS, warp_smem_bytes<CPL>(a.w_b),
         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the warp design at CPL = ceil(w_b / 32), or the first design above
// WARP_MAX_WB cells
template <bool QV, bool HP, bool GEN>
int launch(const Args& a, int threads, size_t smem, void* stream) {
  switch ((a.w_b + 31) / 32) {
    case 1: return launch_cpl<1, QV, HP, GEN>(a, stream);
    case 2: return launch_cpl<2, QV, HP, GEN>(a, stream);
    case 3: return launch_cpl<3, QV, HP, GEN>(a, stream);
    case 4: return launch_cpl<4, QV, HP, GEN>(a, stream);
    case 5: return launch_cpl<5, QV, HP, GEN>(a, stream);
    case 6: return launch_cpl<6, QV, HP, GEN>(a, stream);
    case 7: return launch_cpl<7, QV, HP, GEN>(a, stream);
    case 8: return launch_cpl<8, QV, HP, GEN>(a, stream);
    default: return launch_block<QV, HP, GEN>(a, threads, smem, stream);
  }
}

}  // namespace

// The first design's workspace of one item at band width w_b, in bytes
// (0 where the warp design runs): dynamic shared memory up to
// blasr_banded_dp_wide_max_smem(), else a global scratch of N times it
// that the caller passes.
extern "C" size_t blasr_banded_dp_wide_ws_bytes(int w_b) {
  return w_b <= WARP_MAX_WB ? 0 : (size_t)NARR * (size_t)w_b * sizeof(float);
}

extern "C" int blasr_banded_dp_wide_max_smem() { return SMEM_DYNAMIC_MAX; }

// Every mode's opt-ins to its dynamic shared memory (the first design and
// the warp design at each CPL), on the current device; called once per
// device before any launch (blasr_setup_kernels), never while a stream is
// captured.
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
