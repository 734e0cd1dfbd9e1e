// K1: guided banded DP, forward pass, in two compile-time modes.
//
// Replaces blasr_tpu/kernels/pallas_banded.py::pallas_banded_align (the
// Pallas TPU kernel, `_kernel` / `_block_body`, defined at
// pallas_banded.py:388) in both of its modes, and reproduces
// blasr_tpu/kernels/banded.py::_align_one bit for bit: the same M/I/D
// min-cost recurrence, the same <= tie-breaks in the order M, I, D,
// INF = 1e30, and the same int32 cell word per banded cell (layout in
// blasr_tpu_torch/kernels/banded.py).
//   * distance mode (QV = false, "K1"): affine gaps from the arguments.
//     Every cost is an integer below 2^24, so fused or unfused float32
//     arithmetic gives the same bits.
//   * QV mode (QV = true, "K1-QV", the --useQuality path): per-row costs
//     from the packed tracks qv1/qv2 (int32 [N, L], layout in
//     kernels/banded.py::unpack_qv) -- mismatch subQV/prior by the
//     substitution tag, insertion insQV (linear), and a per-cell linear
//     deletion cost cd = delQV/prior by the deletion tag.  The in-row
//     deletion closed form runs on the prefix sum S of cd:
//     D = S + excl_prefix_min(base - S).  Every cost is an integer below
//     256 and S <= 128*255, so every float32 sum is exact in any order.
//     At the first row the boundary deletion profile is the running sum
//     of row qa's cd from ta (the Pallas kernel's bD; the XLA kernel's
//     cumz form): the same scan with inputs masked to ta <= t < W, plus
//     the sum over ta..o_r-1 when the band starts right of ta.
//
// Contract (as the Pallas kernel's): band width 128, a two-valued score
// matrix (match on the ACGT diagonal, one mismatch value elsewhere), and a
// band offset that advances by 0, 1 or 2 per active row.  The wrapper
// (kernels/cuda_ops.py) checks all three.
//
// Layout: one warp per item; lane l holds band cells 4l..4l+3.  The M/I/D
// carries and the packed M-run counter (rexit | mrun<<2 | meq<<8 |
// ssum<<14) stay in registers across the loop over rows.  Per row:
//   * the diagonal / vertical predecessors for shift s in {0,1,2} are
//     register moves plus one __shfl_up/__shfl_down from the neighbour lane;
//   * the exclusive prefix-min of the in-row deletion closed form is a
//     4-cell serial scan per lane, then a 5-step __shfl_up scan over lane
//     totals; QV mode adds the same scheme once more for the prefix sum S;
//   * target bases come from the window in global memory (__ldg at o_r+w);
//     in QV mode the row's two QV words are one warp-uniform load each;
//   * the row's 128 cell words leave as one 16-byte store per lane (512 B,
//     coalesced).
// Rows outside [qa, qb) are written as zeros, as both JAX kernels do.
//
// What bounds it on an H100: the per-row chain of dependent shuffles (the
// prefix-min scan, in QV mode also the prefix-sum scan, and the neighbour
// exchanges) -- one warp advances one item one row at a time -- and the
// cell-word stream, N*L*512 bytes per call (671 MB at N=640, L=2048), plus
// N*L*8 bytes of QV words in QV mode.  The design keeps every intermediate
// in registers so the stream is the only device-memory traffic of size;
// the latency chain is hidden only by running many items (warps) per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WB = 128;
constexpr float INF_F = 1e30f;
constexpr float HALF_INF = 1e30f * 0.5f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ST_M = 0, ST_I = 1, ST_D = 2;
constexpr int RUN_CAP = 63;

// out[j] = row[4*lane + j + k] (fill outside [0, 128)), k in {-1, 0, 1, 2}
// (warp-uniform).  Every lane executes the three shuffles.
template <typename T>
__device__ __forceinline__ void band_shift(const T x[4], int k, T fill,
                                           int lane, T out[4]) {
  T up3 = __shfl_up_sync(FULL, x[3], 1);
  T dn0 = __shfl_down_sync(FULL, x[0], 1);
  T dn1 = __shfl_down_sync(FULL, x[1], 1);
  if (lane == 0) up3 = fill;
  if (lane == 31) { dn0 = fill; dn1 = fill; }
  if (k == -1) {
    out[0] = up3; out[1] = x[0]; out[2] = x[1]; out[3] = x[2];
  } else if (k == 0) {
    out[0] = x[0]; out[1] = x[1]; out[2] = x[2]; out[3] = x[3];
  } else if (k == 1) {
    out[0] = x[1]; out[1] = x[2]; out[2] = x[3]; out[3] = dn0;
  } else {
    out[0] = x[2]; out[1] = x[3]; out[2] = dn0; out[3] = dn1;
  }
}

// value of cell 4*lane - 1 (fill at lane 0): the in-row left neighbour of
// this lane's first cell
__device__ __forceinline__ float left_of(float x3, int lane) {
  float v = __shfl_up_sync(FULL, x3, 1);
  return lane == 0 ? INF_F : v;
}

__device__ __forceinline__ float pick4(const float v[4], int j) {
  return j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
}

// inclusive prefix sum over the 128-cell band of x (4 cells per lane):
// a 4-cell serial sum per lane, then a 5-step __shfl_up scan of the lane
// totals.  Inputs are integers, so the sums are exact in any order.
__device__ __forceinline__ void band_cumsum(const float x[4], int lane,
                                            float out[4]) {
  out[0] = x[0];
  out[1] = out[0] + x[1];
  out[2] = out[1] + x[2];
  out[3] = out[2] + x[3];
  float scan = out[3];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(FULL, scan, d);
    if (lane >= d) scan += y;
  }
  float excl = __shfl_up_sync(FULL, scan, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] += excl;
}

template <bool QV>
__global__ void __launch_bounds__(128) banded_dp_kernel(
    const int8_t* __restrict__ reads, const int8_t* __restrict__ windows,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ qa_a,
    const int32_t* __restrict__ qb_a, const int32_t* __restrict__ ta_a,
    const int32_t* __restrict__ tb_a, const int32_t* __restrict__ qv1,
    const int32_t* __restrict__ qv2, int N, int L, int W, float match,
    float mismatch, float ins_open, float ins_ext, float del_open,
    float del_ext, float* __restrict__ score_out,
    int32_t* __restrict__ tbbits, int32_t* __restrict__ state_out,
    uint8_t* __restrict__ valid_out) {
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;  // uniform per warp
  const int qa = qa_a[n], qb = qb_a[n], ta = ta_a[n], tb = tb_a[n];
  const int8_t* rd = reads + (size_t)n * L;
  const int8_t* win = windows + (size_t)n * W;
  const int32_t* off = offsets + (size_t)n * L;
  const int32_t* q1 = QV ? qv1 + (size_t)n * L : nullptr;
  const int32_t* q2 = QV ? qv2 + (size_t)n * L : nullptr;
  int4* out = reinterpret_cast<int4*>(tbbits + (size_t)n * L * WB) + lane;
  const int c0 = 4 * lane;

  float pM[4], pI[4], pD[4];
  int pC[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pM[j] = INF_F; pI[j] = INF_F; pD[j] = INF_F; pC[j] = 0;
  }
  int po = 0;
  float fin_score = INF_F;
  int fin_state = ST_M;
  bool fin_ok = false;

  for (int r = 0; r < L; ++r) {
    if (r < qa || r >= qb) {
      out[(size_t)r * (WB / 4)] = make_int4(0, 0, 0, 0);
      continue;
    }
    const int o_r = __ldg(off + r);
    const bool first = (r == qa);
    const int s = first ? 0 : o_r - po;
    const int rb = __ldg(rd + r);

    // QV mode: this row's costs (one warp-uniform load per track) and the
    // per-cell deletion costs cd
    float insq = 0.0f, subq = 0.0f, spri = 0.0f;
    int stag = 7;
    int tg[4];
    float cd[4];
    if constexpr (QV) {
      const unsigned w1 = (unsigned)__ldg(q1 + r);
      const unsigned w2 = (unsigned)__ldg(q2 + r);
      insq = (float)(w1 & 255u);
      const float delq = (float)((w1 >> 8) & 255u);
      subq = (float)((w1 >> 16) & 255u);
      const int dtag = (int)((w1 >> 24) & 7u);
      stag = (int)((w1 >> 27) & 7u);
      const float dpri = (float)(w2 & 255u);
      spri = (float)((w2 >> 8) & 255u);
      const int ts0 = min(max(o_r, 0), W);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ti = ts0 + c0 + j;
        tg[j] = ti < W ? (int)__ldg(win + ti) : 4;
        cd[j] = tg[j] == dtag ? delq : dpri;
      }
      if (first) {
        // boundary deletion profile: sum of cd over ta..t_abs (t < W)
        float pre = 0.0f;  // cells ta..o_r-1 left of the band
        for (int t = ta + lane; t < min(o_r, W); t += 32)
          pre += (int)__ldg(win + t) == dtag ? delq : dpri;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          pre += __shfl_xor_sync(FULL, pre, d);
        float m[4], prof[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t_abs = o_r + c0 + j;
          m[j] = (t_abs >= ta && t_abs < W) ? cd[j] : 0.0f;
        }
        band_cumsum(m, lane, prof);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t_abs = o_r + c0 + j;
          pM[j] = (t_abs == ta - 1) ? 0.0f : INF_F;
          pI[j] = INF_F;
          pD[j] = (t_abs >= ta) ? pre + prof[j] : INF_F;
        }
      }
    } else if (first) {  // boundary row qa-1 replaces the carries
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t_abs = o_r + c0 + j;
        pM[j] = (t_abs == ta - 1) ? 0.0f : INF_F;
        pI[j] = INF_F;
        pD[j] = (t_abs >= ta) ? del_open + del_ext * (float)(t_abs - ta)
                              : INF_F;
      }
    }
    float dM[4], dI[4], dD[4], vM[4], vI[4];
    int dC[4];
    band_shift(pM, s - 1, INF_F, lane, dM);
    band_shift(pI, s - 1, INF_F, lane, dI);
    band_shift(pD, s - 1, INF_F, lane, dD);
    band_shift(pC, s - 1, 0, lane, dC);
    band_shift(pM, s, INF_F, lane, vM);
    band_shift(pI, s, INF_F, lane, vI);

    const int tstart = min(max(o_r, 0), W);
    float M[4], I[4], base[4], g[4];
    int msrc[4], eqv[4];
    bool iopen[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      const int t_abs = o_r + c;
      const int ti = tstart + c;
      int tgt;
      if constexpr (QV) {
        tgt = tg[j];
      } else {
        tgt = ti < W ? (int)__ldg(win + ti) : 4;
      }
      const bool in_t = (t_abs >= ta) && (t_abs < tb);
      const bool in_t_i = (t_abs >= ta - 1) && (t_abs < tb);
      const bool eq = (rb == tgt) && (rb < 4);
      float sub, ifm, ifi;
      if constexpr (QV) {
        sub = eq ? match : (tgt == stag ? subq : spri);
      } else {
        sub = eq ? match : mismatch;
      }
      const float db = fminf(dM[j], fminf(dI[j], dD[j]));
      msrc[j] = dM[j] <= db ? ST_M : (dI[j] <= db ? ST_I : ST_D);
      M[j] = in_t ? sub + db : INF_F;
      if constexpr (QV) {
        ifm = vM[j] + insq;
        ifi = vI[j] + insq;
      } else {
        ifm = vM[j] + ins_open;
        ifi = vI[j] + ins_ext;
      }
      I[j] = in_t_i ? fminf(ifm, ifi) : INF_F;
      iopen[j] = ifm <= ifi;
      base[j] = fminf(M[j], I[j]);
      if constexpr (!QV)
        g[j] = base[j] < HALF_INF ? base[j] - del_ext * (float)c : INF_F;
      eqv[j] = eq ? 1 : 0;
    }
    float S[4];  // QV mode: in-row inclusive prefix sum of cd
    if constexpr (QV) {
      band_cumsum(cd, lane, S);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        g[j] = base[j] < HALF_INF ? base[j] - S[j] : INF_F;
    }
    // exclusive prefix-min of g over the 128-cell band
    float incl[4];
    incl[0] = g[0];
    incl[1] = fminf(incl[0], g[1]);
    incl[2] = fminf(incl[1], g[2]);
    incl[3] = fminf(incl[2], g[3]);
    float scan = incl[3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(FULL, scan, d);
      if (lane >= d) scan = fminf(scan, y);
    }
    float excl = __shfl_up_sync(FULL, scan, 1);
    if (lane == 0) excl = INF_F;
    const float base_l = left_of(base[3], lane);
    const float M_l = left_of(M[3], lane);
    const float I_l = left_of(I[3], lane);

    int bits[4];
    float Dn[4];
    int Cn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      const int t_abs = o_r + c;
      const bool in_t = (t_abs >= ta) && (t_abs < tb);
      const float run_prev = j == 0 ? excl : fminf(excl, incl[j - 1]);
      float D;
      if constexpr (QV) {
        D = in_t ? S[j] + run_prev : INF_F;
      } else {
        D = in_t ? del_ext * (float)c + run_prev + (del_open - del_ext)
                 : INF_F;
      }
      D = fminf(D, INF_F);
      const float bprev = j == 0 ? base_l : base[j - 1];
      const float mprev = j == 0 ? M_l : M[j - 1];
      const float iprev = j == 0 ? I_l : I[j - 1];
      const int d_open = D >= bprev + (QV ? cd[j] : del_open) ? 1 : 0;
      const int d_from_m = mprev <= iprev ? 1 : 0;

      const int dX = dC[j] & 3;
      const int dR = (dC[j] >> 2) & 63;
      const int dE = (dC[j] >> 8) & 63;
      const int dS = (dC[j] >> 14) & 127;
      const bool from_m = msrc[j] == ST_M;
      const bool fresh = !from_m || first || dR >= RUN_CAP;
      const int mrun = fresh ? 1 : dR + 1;
      const int meq = (fresh ? 0 : dE) + eqv[j];
      const int rexit = fresh ? (from_m ? ST_M : msrc[j]) : dX;
      const int ssum = min(fresh ? s : dS + s, 127);
      bits[j] = msrc[j] | ((iopen[j] ? 1 : 0) << 2) | (d_open << 3) |
                (d_from_m << 4) | (eqv[j] << 5) | (rexit << 7) |
                (mrun << 9) | (meq << 15) | (s << 21) | (ssum << 23);
      Dn[j] = D;
      Cn[j] = rexit | (mrun << 2) | (meq << 8) | (ssum << 14);
    }
    out[(size_t)r * (WB / 4)] = make_int4(bits[0], bits[1], bits[2], bits[3]);

    if (r == qb - 1) {  // final (score, state) at cell t = tb-1
      const int wf = tb - 1 - o_r;
      if (wf >= 0 && wf < WB) {
        const int jj = wf & 3;
        const float cM0 = pick4(M, jj), cI0 = pick4(I, jj),
                    cD0 = pick4(Dn, jj);
        const float cM = __shfl_sync(FULL, cM0, wf >> 2);
        const float cI = __shfl_sync(FULL, cI0, wf >> 2);
        const float cD = __shfl_sync(FULL, cD0, wf >> 2);
        const float cbest = fminf(cM, fminf(cI, cD));
        if (cbest < HALF_INF) {
          fin_score = cbest;
          fin_state = cM <= cbest ? ST_M : (cI <= cbest ? ST_I : ST_D);
          fin_ok = true;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pM[j] = M[j]; pI[j] = I[j]; pD[j] = Dn[j]; pC[j] = Cn[j];
    }
    po = o_r;
  }
  if (lane == 0) {
    score_out[n] = fin_score;
    state_out[n] = fin_state;
    valid_out[n] = fin_ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int blasr_banded_dp(
    const int8_t* reads, const int8_t* windows, const int32_t* offsets,
    const int32_t* qa, const int32_t* qb, const int32_t* ta,
    const int32_t* tb, int N, int L, int W, float match, float mismatch,
    float ins_open, float ins_ext, float del_open, float del_ext,
    float* score, int32_t* tbbits, int32_t* final_state, uint8_t* valid,
    void* stream) {
  const int threads = 128;  // 4 warps = 4 items per block
  const int blocks = (N + 3) / 4;
  banded_dp_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      reads, windows, offsets, qa, qb, ta, tb, nullptr, nullptr, N, L, W,
      match, mismatch, ins_open, ins_ext, del_open, del_ext, score, tbbits,
      final_state, valid);
  return (int)cudaGetLastError();
}

// K1-QV: the QV-steered mode; the costs come from qv1/qv2, so of the
// scalar costs only the match value is taken.
extern "C" int blasr_banded_dp_qv(
    const int8_t* reads, const int8_t* windows, const int32_t* offsets,
    const int32_t* qa, const int32_t* qb, const int32_t* ta,
    const int32_t* tb, const int32_t* qv1, const int32_t* qv2, int N, int L,
    int W, float match, float* score, int32_t* tbbits, int32_t* final_state,
    uint8_t* valid, void* stream) {
  const int threads = 128;
  const int blocks = (N + 3) / 4;
  banded_dp_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      reads, windows, offsets, qa, qb, ta, tb, qv1, qv2, N, L, W, match,
      0.0f, 0.0f, 0.0f, 0.0f, 0.0f, score, tbbits, final_state, valid);
  return (int)cudaGetLastError();
}
