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
// Positions are int32 as in the JAX package (read from int32 or int64
// inputs), converted with __int2float_rn.  Ties resolve to the lowest
// index in every argmax.  When every value is NEG the selection's argmax
// is index 0, as jnp.argmax's is.
//
// Layout: one CTA of 512 threads (16 warps) per strand-row.  The row's
// anchors (q, t, l, valid, nlogp) and its six carries (best, sq, st, cnt,
// sump, sumr) sit in shared memory, 42 bytes per anchor (A <= 5,510 in
// the 227 KB a block may opt into); above that (--maxExpand doubles A per
// retry) the same arrays live in a per-row slice of a global scratch
// buffer, read through L1/L2, with the same code (template <bool GLOBAL>).
//
// The scan runs in blocks of S = 32 anchors, [i0, i0 + 32).  The first
// argmax over a window splits into parts by predecessor index: combined by
// value, with equal values going to the lower index, the parts give the
// single argmax's index and value, because every cand is computed by the
// same transition and __fadd_rn.  For block b:
//   * phase A (warps 1-15, while warp 0 runs phase B of block b - 1): for
//     each of the block's anchors, the first argmax over the predecessors
//     j < i0 - 32, whose carries are final; lanes stride over j (loads and
//     tests without branches, four predecessors in flight), a redux.sync
//     max of the order-preserving integer key of cand and a redux.sync min
//     of the index among the lanes at the max reduce it; (value, index)
//     per anchor into a double-buffered shared array;
//   * phase B (warp 0; lane k holds anchor i0 + k).  Pass 1, serial in the
//     block's 32 anchors, keeps only each anchor's best on its chain: at
//     anchor i = i0 + s lane k tests the previous block's anchor
//     i0 - 32 + k (final) and this block's anchor i0 + k (k < s, its best
//     in lane k's register since step k); one redux.sync max of the keys,
//     the phase-A part winning ties (lower indices), then ballots pick the
//     lowest lane among the previous block's, then among this block's.
//     Pass 2 derives every anchor's carries at once from a new start or a
//     parent before the block; pass 3 walks, in order, the anchors whose
//     parent lies in the block and takes the parent's carries by shuffle.
//     The block's carries and parents are stored at the end.
// One __syncthreads per block of 32 anchors; the selection rounds keep
// their block-wide argmax (one barrier a round).  Invalid anchors take
// their fixed carries without a reduction.
//
// What bounds it on an H100: latency.  At the bench's A = 512 it is phase
// B's chain per anchor (a float add, the key, one redux.sync, a compare
// and a select, in place of a block-wide argmax with a barrier per anchor,
// ~1,400 cycles), which the design shortens by keeping the
// block's bests in registers and taking every older predecessor and every
// carry but the best off the chain.  At large A with a full lookback it is
// phase A's A^2 / 2 predecessor tests, ~20 float32/int ops each, on one
// SM per row (fifteen warps, four loads in flight each).  2B CTAs (64 in a
// bench batch) leave most SMs idle.

#include <cuda_runtime.h>
#include <stdint.h>

#include "setup.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int S = 32;                  // anchors per scan block
constexpr float NEG = -1e30f;
constexpr float NEG_HALF = -5e29f;     // NEG * 0.5, exactly
constexpr float LOG4 = 1.3862944f;     // float32 bits 0x3fb17218
constexpr int NO_INDEX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

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

// An int whose signed order is the float order (no cand is NaN or -0).
// The map is its own inverse.
__device__ __forceinline__ int fkey(float v) {
  const int b = __float_as_int(v);
  return b ^ (int)((unsigned)(b >> 31) >> 1);
}

__device__ __forceinline__ float fkey_inv(int k) {
  return __int_as_float(k ^ (int)((unsigned)(k >> 31) >> 1));
}

// Block-wide first argmax of (v, j); every thread returns the result.
__device__ __forceinline__ void block_argmax(float& v, int& j,
                                             float (*rv)[WARPS],
                                             int (*rj)[WARPS], int buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_down_sync(FULL, v, o);
    const int j2 = __shfl_down_sync(FULL, j, o);
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

// Transition j -> i: whether it is allowed, and its gain (no branch).
__device__ __forceinline__ bool transition(const Params& p, int wlen, int qi,
                                           int ti, float li, int qj, int tj,
                                           int lj, float& gain) {
  const int dq = qi - qj, dt = ti - tj;
  const float drift = __int2float_rn(abs(dt - dq));
  const float span = __int2float_rn(max(dq, dt));
  bool ok = (dq > 0) & (dt > 0) & (dt <= wlen) &
            (drift <= __fmaf_rn(p.frac, span, p.slack));
  if (p.global_chain) ok = ok & (dq >= lj) & (dt >= lj);
  gain = fminf(li, __int2float_rn(min(dq, dt)));
  if (p.use_pen) gain = __fmaf_rn(p.neg_pen, drift, gain);
  return ok;
}

// The row's arrays, in shared memory or in a global scratch slice.
struct Row {
  int32_t *q, *t, *l;
  float *p, *best;
  int32_t *sq, *st, *cnt;
  float *sump, *sumr;
  uint8_t *valid, *rem;
};

// Phase A for the block at i0: per anchor, the first argmax over the
// predecessors j in [max(0, i - D), i0 - S).  Run by warps 1.. (a lane's
// predecessors in ascending order, a strict > keeping the first).
__device__ __forceinline__ void phase_a(const Params& p, const Row& w,
                                        int wlen, int i0, float* ov,
                                        int* oj) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hi = i0 - S;
  for (int s = warp - 1; s < S; s += WARPS - 1) {
    const int i = i0 + s;
    float bv = NEG;
    int bj = NO_INDEX;
    if (i < p.A && w.valid[i] && hi > 0) {
      const int qi = w.q[i], ti = w.t[i];
      const float li = __int2float_rn(w.l[i]);
#pragma unroll 4
      for (int j = max(0, i - p.D) + lane; j < hi; j += 32) {
        float gain;
        const bool ok =
            transition(p, wlen, qi, ti, li, w.q[j], w.t[j], w.l[j], gain) &
            (w.valid[j] != 0);
        const float c = __fadd_rn(w.best[j], gain);
        if (ok && c > bv) { bv = c; bj = j; }
      }
    }
    const int k = fkey(bv);
    const int m = __reduce_max_sync(FULL, k);
    const unsigned jm =
        __reduce_min_sync(FULL, k == m ? (unsigned)bj : 0xffffffffu);
    if (lane == 0) {
      ov[s] = fkey_inv(m);
      oj[s] = (int)jm;
    }
  }
}

// Phase B for the block at i0, on warp 0; lane k holds anchor i0 + k.
// Pass 1 runs the block's anchors in order and keeps on its chain only
// what the next anchor needs (each anchor's best); pass 2 derives every
// lane's carries from its parent at once (a parent before the block from
// the row's arrays); pass 3 walks, in order, the anchors whose parent is
// in the block and takes the parent's carries by shuffle.
__device__ __forceinline__ void phase_b(const Params& p, const Row& w,
                                        int wlen, int i0, const float* ov,
                                        const int* oj,
                                        int64_t* __restrict__ o_parent) {
  const int lane = threadIdx.x & 31;
  const int n_in = min(S, p.A - i0);
  const bool in_row = lane < n_in;
  const int ik = i0 + lane;
  const int qk = in_row ? w.q[ik] : 0;
  const int tk = in_row ? w.t[ik] : 0;
  const int lk = in_row ? w.l[ik] : 0;
  const bool vk = in_row && w.valid[ik];
  const float pk = in_row ? w.p[ik] : 0.0f;
  const float lkf = __int2float_rn(lk);
  // the previous block's anchor i0 - S + lane (final)
  const int jp = i0 - S + lane;
  const bool pv = jp >= 0 && w.valid[jp];
  const int pq = jp >= 0 ? w.q[jp] : 0;
  const int pt = jp >= 0 ? w.t[jp] : 0;
  const int pl = jp >= 0 ? w.l[jp] : 0;
  const float pbest = jp >= 0 ? w.best[jp] : NEG;

  // pass 1: best and parent of each anchor, in order
  float best = NEG;
  int parent = -1;
  for (int s = 0; s < n_in; ++s) {
    const int qi = __shfl_sync(FULL, qk, s);
    const int ti = __shfl_sync(FULL, tk, s);
    const float li = __shfl_sync(FULL, lkf, s);
    if (!__shfl_sync(FULL, (int)vk, s)) continue;  // fixed carries
    const int lo = i0 + s - p.D;
    const float vo = ov[s];
    const int jo = oj[s];
    float gain_p, gain_n;
    const bool okp = pv & (jp >= lo) &
                     transition(p, wlen, qi, ti, li, pq, pt, pl, gain_p);
    const bool okn = (lane < s) & vk & (ik >= lo) &
                     transition(p, wlen, qi, ti, li, qk, tk, lk, gain_n);
    const int kp = fkey(okp ? __fadd_rn(pbest, gain_p) : NEG);
    const int kn = fkey(okn ? __fadd_rn(best, gain_n) : NEG);
    const int m = __reduce_max_sync(FULL, max(kp, kn));
    const unsigned bp = __ballot_sync(FULL, kp == m);
    const unsigned bn = __ballot_sync(FULL, kn == m);
    const bool older = fkey(vo) >= m;  // the older part wins ties
    const float bv = older ? vo : fkey_inv(m);
    const int bj = older ? jo : (bp ? i0 - S + __ffs(bp) - 1
                                    : i0 + __ffs(bn) - 1);
    const bool start = bv < li;  // start a new chain
    if (lane == s) {
      best = start ? li : bv;
      parent = start ? -1 : bj;
    }
  }

  // pass 2: carries from a new start or from a parent before the block
  int sq = qk, st = tk, cnt = 0;
  float sump = 0.0f, sumr = 0.0f, frac = 0.0f;
  const int src = parent >= i0 ? parent - i0 : lane;
  const int fq = __shfl_sync(FULL, qk, src);
  const int ft = __shfl_sync(FULL, tk, src);
  const int fl = __shfl_sync(FULL, lk, src);
  if (vk) {
    if (parent < 0) {
      cnt = 1;
      sump = pk;
      sumr = pk;
    } else {
      const bool old = parent < i0;
      float gain;
      transition(p, wlen, qk, tk, lkf, old ? w.q[parent] : fq,
                 old ? w.t[parent] : ft, old ? w.l[parent] : fl, gain);
      frac = __fdiv_rn(gain, fmaxf(lkf, 1.0f));
      if (old) {
        sq = w.sq[parent];
        st = w.st[parent];
        cnt = w.cnt[parent] + 1;
        sump = __fmaf_rn(pk, frac, w.sump[parent]);
        sumr = __fadd_rn(w.sumr[parent], pk);
      }
    }
  }

  // pass 3: parents in the block, in order
  unsigned todo = __ballot_sync(FULL, parent >= i0);
  while (todo) {
    const int s = __ffs(todo) - 1;
    todo &= todo - 1;
    const int from = __shfl_sync(FULL, src, s);
    const int psq = __shfl_sync(FULL, sq, from);
    const int pst = __shfl_sync(FULL, st, from);
    const int pcnt = __shfl_sync(FULL, cnt, from);
    const float psump = __shfl_sync(FULL, sump, from);
    const float psumr = __shfl_sync(FULL, sumr, from);
    if (lane == s) {
      sq = psq;
      st = pst;
      cnt = pcnt + 1;
      sump = __fmaf_rn(pk, frac, psump);
      sumr = __fadd_rn(psumr, pk);
    }
  }
  if (in_row) {
    w.best[ik] = best;
    w.sq[ik] = sq;
    w.st[ik] = st;
    w.cnt[ik] = cnt;
    w.sump[ik] = sump;
    w.sumr[ik] = sumr;
    o_parent[ik] = parent;
  }
}

__device__ __forceinline__ int ld_int(const void* x, size_t i, int wide) {
  return wide ? (int)reinterpret_cast<const int64_t*>(x)[i]
              : reinterpret_cast<const int32_t*>(x)[i];
}

template <bool GLOBAL>
__global__ void __launch_bounds__(THREADS) chain_scan_kernel(
    const void* __restrict__ q_in, const void* __restrict__ t_in,
    const void* __restrict__ l_in, int wide_pos,
    const uint8_t* __restrict__ v_in, const float* __restrict__ p_in,
    const void* __restrict__ read_len, int wide_len, Params p,
    int64_t* __restrict__ o_qs, int64_t* __restrict__ o_qe,
    int64_t* __restrict__ o_ts, int64_t* __restrict__ o_te,
    float* __restrict__ o_score, int64_t* __restrict__ o_nanch,
    float* __restrict__ o_nlogp, uint8_t* __restrict__ o_valid,
    int64_t* __restrict__ o_end, int64_t* __restrict__ o_parent,
    char* scratch, size_t row_bytes) {
  extern __shared__ int32_t smem[];
  __shared__ float rv[2][WARPS];
  __shared__ int rj[2][WARPS];
  __shared__ float old_v[2][S];
  __shared__ int old_j[2][S];
  const int A = p.A;
  Row w;
  w.q = GLOBAL ? reinterpret_cast<int32_t*>(scratch +
                                            (size_t)blockIdx.x * row_bytes)
               : smem;
  w.t = w.q + A;
  w.l = w.t + A;
  w.p = reinterpret_cast<float*>(w.l + A);
  w.best = w.p + A;
  w.sq = reinterpret_cast<int32_t*>(w.best + A);
  w.st = w.sq + A;
  w.cnt = w.st + A;
  w.sump = reinterpret_cast<float*>(w.cnt + A);
  w.sumr = w.sump + A;
  w.valid = reinterpret_cast<uint8_t*>(w.sumr + A);
  w.rem = w.valid + A;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)b * A;
  for (int j = tid; j < A; j += THREADS) {
    w.q[j] = ld_int(q_in, row + j, wide_pos);
    w.t[j] = ld_int(t_in, row + j, wide_pos);
    w.l[j] = ld_int(l_in, row + j, wide_pos);
    w.p[j] = p_in[row + j];
    w.valid[j] = v_in[row + j];
    w.rem[j] = v_in[row + j];
  }
  if (tid < S) {  // block 0 has no older predecessors
    old_v[0][tid] = NEG;
    old_j[0][tid] = NO_INDEX;
  }
  const int wlen = __float2int_rz(
      __fmul_rn(__int2float_rn(ld_int(read_len, b, wide_len)), p.rate));
  __syncthreads();

  // ---- the chain scan, 32 anchors a block: phase B of block k on warp 0
  // beside phase A of block k + 1 on warps 1-15, one barrier per block
  const int nblk = (A + S - 1) / S;
  for (int k = 0; k < nblk; ++k) {
    if (tid < 32) {
      phase_b(p, w, wlen, k * S, old_v[k & 1], old_j[k & 1], o_parent + row);
    } else if (k + 1 < nblk) {
      phase_a(p, w, wlen, (k + 1) * S, old_v[(k + 1) & 1],
              old_j[(k + 1) & 1]);
    }
    __syncthreads();
  }

  // ---- greedy top-C selection with same-placement suppression
  int nred = 0;
  const size_t orow = (size_t)b * p.C;
  for (int c = 0; c < p.C; ++c) {
    float bv = NEG;
    int bj = NO_INDEX;
    for (int j = tid; j < A; j += THREADS) {
      float key = NEG;
      if (w.rem[j]) {
        const float best = w.best[j];
        key = best;
        if (p.rank_mode != 0) {
          const float pk = p.rank_mode == 1   ? w.sump[j]
                           : p.rank_mode == 2 ? __fmul_rn(best, LOG4)
                                              : w.sumr[j];
          key = best > NEG_HALF ? pk : NEG;
        }
      }
      if (better(key, j, bv, bj)) { bv = key; bj = j; }
    }
    block_argmax(bv, bj, rv, rj, nred++ & 1);
    const int ts_i = w.st[bj], qs_i = w.sq[bj];
    const int te_i = w.t[bj] + w.l[bj], qe_i = w.q[bj] + w.l[bj];
    const int d_sel = te_i - qe_i;
    for (int j = tid; j < A; j += THREADS) {
      if (!w.rem[j]) continue;
      const int te_j = w.t[j] + w.l[j], qe_j = w.q[j] + w.l[j];
      const int ov = min(te_i, te_j) - max(ts_i, w.st[j]);
      const int span_min = min(te_i - ts_i, te_j - w.st[j]);
      if (2 * ov > span_min && abs((te_j - qe_j) - d_sel) < 128) w.rem[j] = 0;
    }
    if (tid == 0) {
      const bool okv = bv > NEG_HALF && w.valid[bj];
      o_qs[orow + c] = qs_i;
      o_qe[orow + c] = qe_i;
      o_ts[orow + c] = ts_i;
      o_te[orow + c] = te_i;
      o_score[orow + c] = okv ? bv : 0.0f;
      o_nanch[orow + c] = okv ? w.cnt[bj] : 0;
      o_nlogp[orow + c] = okv ? w.sump[bj] : 0.0f;
      o_valid[orow + c] = okv ? 1 : 0;
      o_end[orow + c] = bj;
    }
  }
}

}  // namespace

// The opt-in to all the dynamic shared memory a block can take beside the
// kernel's static arrays, on the current device, so that a launch of any
// A up to cuda_ops.CHAIN_MAX_ANCHORS needs no attribute call of its own
// (one that lowered it would fail a captured launch of a larger A); called
// once per device before any launch (blasr_setup_kernels), never while a
// stream is captured.
extern "C" int blasr_chain_scan_setup() {
  return (int)blasr::opt_in_max(
      reinterpret_cast<const void*>(chain_scan_kernel<false>));
}

// q, t, l: int32 (wide_pos = 0) or int64 (1) [B, A]; read_len int32 or
// int64 [B]; every integer output int64.
extern "C" int blasr_chain_scan(
    const void* q, const void* t, const void* l, int wide_pos,
    const uint8_t* valid, const float* nlogp, const void* read_len,
    int wide_len, int B, int A, int D, int C, float rate, float drift_frac,
    float drift_slack, int use_pen, float neg_pen, int global_chain,
    int rank_mode, int64_t* q_start, int64_t* q_end, int64_t* t_start,
    int64_t* t_end, float* score, int64_t* n_anchors, float* out_nlogp,
    uint8_t* out_valid, int64_t* end_idx, int64_t* parent, char* scratch,
    long long row_bytes, void* stream) {
  const Params p{A, D, C, rate, drift_frac, drift_slack, neg_pen,
                 use_pen, global_chain, rank_mode};
  if (scratch != nullptr) {  // the row's arrays in global memory
    chain_scan_kernel<true><<<B, THREADS, 0, (cudaStream_t)stream>>>(
        q, t, l, wide_pos, valid, nlogp, read_len, wide_len, p, q_start,
        q_end, t_start, t_end, score, n_anchors, out_nlogp, out_valid,
        end_idx, parent, scratch, (size_t)row_bytes);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)A * 42;  // cuda_ops.CHAIN_SMEM_PER_ANCHOR
  chain_scan_kernel<false><<<B, THREADS, smem, (cudaStream_t)stream>>>(
      q, t, l, wide_pos, valid, nlogp, read_len, wide_len, p, q_start,
      q_end, t_start, t_end, score, n_anchors, out_nlogp, out_valid, end_idx,
      parent, nullptr, 0);
  return (int)cudaGetLastError();
}
