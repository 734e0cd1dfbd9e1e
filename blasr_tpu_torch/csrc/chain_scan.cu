// K3: anchor chaining and candidate selection, one launch per call.
//
// Replaces blasr_tpu/kernels/chain.py::chain_anchors: an XLA lax.scan of
// A anchor steps (8 per scan step), each a masked [D, B] max-plus over the
// predecessor window, then a lax.scan of n_cand greedy selections (no
// Pallas kernel on the TPU; eager torch pays ~45 launches per anchor step).
// It computes exactly what kernels/chain.py::chain_anchors_plain computes:
//
//   scan, anchor i of row b, predecessors j in [max(0, i - D), i):
//     ok   = valid_j & valid_i & dq > 0 & dt > 0 & dt <= wlen
//            & drift <= fma(drift_frac, span, slack)  [& dq, dt >= l_j]
//     gain = min(l_i, min(dq, dt))  [fma(-pen, drift, gain)]
//     cand = ok ? best_j + gain : NEG;  w = first argmax
//     start a new chain if cand_w < l_i, else extend w: best, chain start
//     (sq, st), count, sump = fma(p_i, gain_w / max(l_i, 1), sump_w), sumr
//   selection, n_cand times: the first argmax of the rank key over the
//     remaining anchors; drop the remaining ends that overlap it by > 50%
//     on the same diagonal band (|diag difference| < 128).
//
// Rounding: the drift bound, the drift penalty and sump are single-rounded
// fused multiply-adds (__fmaf_rn), as XLA's CPU build contracts them; every
// other float op is written as its _rn intrinsic so nvcc contracts nothing.
// Positions are int32 as in the JAX package, converted with __int2float_rn.
// Ties resolve to the lowest index in both argmaxes: each thread walks its
// anchors in ascending order with a strict >, and the warp and block
// reductions prefer the lower index on equal values.  When every value is
// NEG the selection's argmax is index 0, as jnp.argmax's is.
//
// Layout: one CTA of 256 threads per strand-row.  The row's anchors
// (q, t, l, valid, nlogp) and its six carries (best, sq, st, cnt, sump,
// sumr) sit in shared memory, 42 bytes per anchor (A <= 5,510 in the
// 227 KB a block may opt into); above that (--maxExpand doubles A per
// retry) the same arrays live in a per-row slice of a global scratch
// buffer, read through L1/L2, with the same code and the same order of
// operations (template <bool GLOBAL>).  Thread tid owns anchors j = tid mod 256:
// it alone evaluates them as predecessors, writes their carries and clears
// their selection flags, so each anchor step and each selection needs one
// __syncthreads (inside the block argmax; its per-warp partials are
// double-buffered).  Every thread reduces the eight warp partials itself,
// and the owner of anchor i writes row i's carries.  Invalid anchors take
// their fixed carries without a reduction.
//
// What bounds it on an H100: latency.  The scan is A dependent steps, each
// a block-wide argmax (two 5-step shuffle chains, one barrier, eight
// shared-memory reads), and the selection n_cand more; the pair tests are
// ~20 float32/int ops each, B * A^2 / 2 of them, microseconds of the card's
// peak.  The design keeps every carry on chip and issues one barrier per
// step; 2B CTAs (64 in a bench batch) leave most SMs idle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr float NEG_HALF = -5e29f;     // NEG * 0.5, exactly
constexpr float LOG4 = 1.3862944f;     // float32 bits 0x3fb17218
constexpr int NO_INDEX = 0x7fffffff;

// rank modes: 0 = best (anchor bases), 1 = sump (p-value type 0),
// 2 = best * LOG4 (type 1), 3 = sumr (type 2)
struct Params {
  int A, D, C;
  float rate, frac, slack, neg_pen;
  int use_pen, global_chain, rank_mode;
};

__device__ __forceinline__ bool better(float v2, int j2, float v1, int j1) {
  return v2 > v1 || (v2 == v1 && j2 < j1);
}

// Block-wide first argmax of (v, j); every thread returns the result.
__device__ __forceinline__ void block_argmax(float& v, int& j,
                                             float (*rv)[WARPS],
                                             int (*rj)[WARPS], int buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, o);
    const int j2 = __shfl_down_sync(0xffffffffu, j, o);
    if (better(v2, j2, v, j)) { v = v2; j = j2; }
  }
  if ((threadIdx.x & 31) == 0) {
    rv[buf][threadIdx.x >> 5] = v;
    rj[buf][threadIdx.x >> 5] = j;
  }
  __syncthreads();
  v = rv[buf][0];
  j = rj[buf][0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    if (better(rv[buf][w], rj[buf][w], v, j)) {
      v = rv[buf][w];
      j = rj[buf][w];
    }
  }
}

// Transition j -> i: whether it is allowed, and its gain.
__device__ __forceinline__ bool transition(const Params& p, int wlen, int qi,
                                           int ti, float li, int qj, int tj,
                                           int lj, float& gain) {
  const int dq = qi - qj, dt = ti - tj;
  const float drift = __int2float_rn(abs(dt - dq));
  const float span = __int2float_rn(max(dq, dt));
  bool ok = dq > 0 && dt > 0 && dt <= wlen &&
            drift <= __fmaf_rn(p.frac, span, p.slack);
  if (p.global_chain) ok = ok && dq >= lj && dt >= lj;
  gain = fminf(li, __int2float_rn(min(dq, dt)));
  if (p.use_pen) gain = __fmaf_rn(p.neg_pen, drift, gain);
  return ok;
}

template <bool GLOBAL>
__global__ void __launch_bounds__(THREADS) chain_scan_kernel(
    const int32_t* __restrict__ q_in, const int32_t* __restrict__ t_in,
    const int32_t* __restrict__ l_in, const uint8_t* __restrict__ v_in,
    const float* __restrict__ p_in, const int32_t* __restrict__ read_len,
    Params p, int32_t* __restrict__ o_qs, int32_t* __restrict__ o_qe,
    int32_t* __restrict__ o_ts, int32_t* __restrict__ o_te,
    float* __restrict__ o_score, int32_t* __restrict__ o_nanch,
    float* __restrict__ o_nlogp, uint8_t* __restrict__ o_valid,
    int32_t* __restrict__ o_end, int32_t* __restrict__ o_parent,
    char* scratch, size_t row_bytes) {
  extern __shared__ int32_t smem[];
  __shared__ float rv[2][WARPS];
  __shared__ int rj[2][WARPS];
  const int A = p.A;
  int32_t* s_q = GLOBAL ? reinterpret_cast<int32_t*>(
                              scratch + (size_t)blockIdx.x * row_bytes)
                        : smem;
  int32_t* s_t = s_q + A;
  int32_t* s_l = s_t + A;
  float* s_p = reinterpret_cast<float*>(s_l + A);
  float* s_best = s_p + A;
  int32_t* s_sq = reinterpret_cast<int32_t*>(s_best + A);
  int32_t* s_st = s_sq + A;
  int32_t* s_cnt = s_st + A;
  float* s_sump = reinterpret_cast<float*>(s_cnt + A);
  float* s_sumr = s_sump + A;
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_sumr + A);
  uint8_t* s_rem = s_valid + A;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)b * A;
  for (int j = tid; j < A; j += THREADS) {
    s_q[j] = q_in[row + j];
    s_t[j] = t_in[row + j];
    s_l[j] = l_in[row + j];
    s_p[j] = p_in[row + j];
    s_valid[j] = v_in[row + j];
    s_rem[j] = v_in[row + j];
  }
  const int wlen =
      __float2int_rz(__fmul_rn(__int2float_rn(read_len[b]), p.rate));
  __syncthreads();

  // ---- the chain scan
  int nred = 0;
  for (int i = 0; i < A; ++i) {
    const bool own = (i % THREADS) == tid;
    const int qi = s_q[i], ti = s_t[i];
    if (!s_valid[i]) {  // every candidate is masked: fixed carries
      if (own) {
        s_best[i] = NEG;
        s_sq[i] = qi;
        s_st[i] = ti;
        s_cnt[i] = 0;
        s_sump[i] = 0.0f;
        s_sumr[i] = 0.0f;
        o_parent[row + i] = -1;
      }
      continue;
    }
    const float li = __int2float_rn(s_l[i]);
    float bv = NEG;
    int bj = NO_INDEX;
    const int lo = max(0, i - p.D);
    for (int j = lo + (tid - lo % THREADS + THREADS) % THREADS; j < i;
         j += THREADS) {
      if (!s_valid[j]) continue;
      float gain;
      if (!transition(p, wlen, qi, ti, li, s_q[j], s_t[j], s_l[j], gain))
        continue;
      const float c = __fadd_rn(s_best[j], gain);
      if (c > bv) { bv = c; bj = j; }
    }
    block_argmax(bv, bj, rv, rj, nred++ & 1);
    if (own) {
      const float pi = s_p[i];
      if (bv < li) {  // start a new chain
        s_best[i] = li;
        s_sq[i] = qi;
        s_st[i] = ti;
        s_cnt[i] = 1;
        s_sump[i] = pi;
        s_sumr[i] = pi;
        o_parent[row + i] = -1;
      } else {
        float gain;
        transition(p, wlen, qi, ti, li, s_q[bj], s_t[bj], s_l[bj], gain);
        const float frac = __fdiv_rn(gain, fmaxf(li, 1.0f));
        s_best[i] = bv;
        s_sq[i] = s_sq[bj];
        s_st[i] = s_st[bj];
        s_cnt[i] = s_cnt[bj] + 1;
        s_sump[i] = __fmaf_rn(pi, frac, s_sump[bj]);
        s_sumr[i] = __fadd_rn(s_sumr[bj], pi);
        o_parent[row + i] = bj;
      }
    }
  }
  __syncthreads();

  // ---- greedy top-C selection with same-placement suppression
  const size_t orow = (size_t)b * p.C;
  for (int c = 0; c < p.C; ++c) {
    float bv = NEG;
    int bj = NO_INDEX;
    for (int j = tid; j < A; j += THREADS) {
      float key = NEG;
      if (s_rem[j]) {
        const float best = s_best[j];
        key = best;
        if (p.rank_mode != 0) {
          const float pk = p.rank_mode == 1   ? s_sump[j]
                           : p.rank_mode == 2 ? __fmul_rn(best, LOG4)
                                              : s_sumr[j];
          key = best > NEG_HALF ? pk : NEG;
        }
      }
      if (better(key, j, bv, bj)) { bv = key; bj = j; }
    }
    block_argmax(bv, bj, rv, rj, nred++ & 1);
    const int ts_i = s_st[bj], qs_i = s_sq[bj];
    const int te_i = s_t[bj] + s_l[bj], qe_i = s_q[bj] + s_l[bj];
    const int d_sel = te_i - qe_i;
    for (int j = tid; j < A; j += THREADS) {
      if (!s_rem[j]) continue;
      const int te_j = s_t[j] + s_l[j], qe_j = s_q[j] + s_l[j];
      const int ov = min(te_i, te_j) - max(ts_i, s_st[j]);
      const int span_min = min(te_i - ts_i, te_j - s_st[j]);
      if (2 * ov > span_min && abs((te_j - qe_j) - d_sel) < 128) s_rem[j] = 0;
    }
    if (tid == 0) {
      const bool okv = bv > NEG_HALF && s_valid[bj];
      o_qs[orow + c] = qs_i;
      o_qe[orow + c] = qe_i;
      o_ts[orow + c] = ts_i;
      o_te[orow + c] = te_i;
      o_score[orow + c] = okv ? bv : 0.0f;
      o_nanch[orow + c] = okv ? s_cnt[bj] : 0;
      o_nlogp[orow + c] = okv ? s_sump[bj] : 0.0f;
      o_valid[orow + c] = okv ? 1 : 0;
      o_end[orow + c] = bj;
    }
  }
}

}  // namespace

extern "C" int blasr_chain_scan(
    const int32_t* q, const int32_t* t, const int32_t* l, const uint8_t* valid,
    const float* nlogp, const int32_t* read_len, int B, int A, int D, int C,
    float rate, float drift_frac, float drift_slack, int use_pen,
    float neg_pen, int global_chain, int rank_mode, int32_t* q_start,
    int32_t* q_end, int32_t* t_start, int32_t* t_end, float* score,
    int32_t* n_anchors, float* out_nlogp, uint8_t* out_valid,
    int32_t* end_idx, int32_t* parent, char* scratch, long long row_bytes,
    void* stream) {
  const Params p{A, D, C, rate, drift_frac, drift_slack, neg_pen,
                 use_pen, global_chain, rank_mode};
  if (scratch != nullptr) {  // the row's arrays in global memory
    chain_scan_kernel<true><<<B, THREADS, 0, (cudaStream_t)stream>>>(
        q, t, l, valid, nlogp, read_len, p, q_start, q_end, t_start, t_end,
        score, n_anchors, out_nlogp, out_valid, end_idx, parent, scratch,
        (size_t)row_bytes);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)A * 42;  // cuda_ops.CHAIN_SMEM_PER_ANCHOR
  cudaError_t err = cudaFuncSetAttribute(
      chain_scan_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  chain_scan_kernel<false><<<B, THREADS, smem, (cudaStream_t)stream>>>(
      q, t, l, valid, nlogp, read_len, p, q_start, q_end, t_start, t_end,
      score, n_anchors, out_nlogp, out_valid, end_idx, parent, nullptr, 0);
  return (int)cudaGetLastError();
}
