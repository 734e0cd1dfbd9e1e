// K7: the member anchors of each selected chain, one launch per call.
//
// Replaces blasr_tpu/kernels/chain.py::chain_members, an XLA program on the
// TPU (no Pallas kernel; there it is ~14 dependent gather rounds of binary
// lifting, and eager torch pays ~50 launches a call).  It computes exactly
// what kernels/chain.py::chain_members_plain computes, per row b and chain c:
//
//   member d (0 <= d < M) = the distance-d ancestor of end_idx[b, c] under
//           parent[b, :], -1 absorbing (a negative end has no members);
//           candidates whose valid flag is false are walked all the same;
//   (q, t, l) of a member, (BIG, BIG, 0) for an absent one;
//   the M rows of a chain ordered by a stable sort on q, which is the
//           order of the composite key (q, d);
//   mvalid = mq < BIG.
//
// Three paths, two kernels; kernels/cuda_ops.py::chain_members_plan picks
// one from the sizes (chain_members_plan.h, the `stage` argument) and
// counts which in MEMBER_PATHS.
//
// Shared path (chain_members_lift, stage 2), while the row's lifting table
// fits in shared memory: one CTA per row b holding all C chains (as many
// as 1024 threads cover at one thread a member slot (c, d); the `warps`
// argument is then the chains a CTA holds).  The CTA stages the row's A
// parents once, as int32 (-1 absorbing; a pointer outside [0, A) reads as
// -1), and builds the binary-lifting table beside them: nbits = max(1,
// bit_length(M - 1)) levels, level k + 1 = level k composed with itself,
// one barrier a level (7 levels at M = 96, 8 at M = 256).  Thread (c, d)
// then finds the distance-d ancestor of end_idx[b, c] by one table lookup
// per set bit of d, the plain version's loop, so no member waits on
// another, and gathers the member's q, t and l once from global memory.
// A chain's present members are the prefix d < n (the ancestor of an
// absent member is absent), and the thread of member n - 1 (or of d = 0
// when n = 0) records n.  The rank of (q, d) among the chain's M keys is
// counted from the q's in shared memory: the n present keys one by one,
// the M - n absent ones (q = BIG at d = n..M-1) as a block, since they
// sort below (q_d, d) exactly when q_d > BIG (all of them) or q_d == BIG
// (those before d) -- the stable argsort's order, with nothing assumed of
// q along a chain.  Each member is written once, at its rank.
//
// The chase (chain_members_chase, stage 1 or 0), where the table does not
// fit (a row of ~7,900 anchors at M = 96): the first design of this
// kernel, one warp a chain, `warps` chains a CTA.  Stage 1 stages the
// row's parents in shared memory as int32 (up to ~55,900 anchors at M = 96
// and four warps); stage 0 reads them from global memory.  Lane 0 chases
// at most M pointers and records the member indices; the lanes gather each
// member's q into shared memory, and lane j ranks the members d = j, j +
// 32, ... by counting the members with a smaller (q, d): the n present
// ones against each other, the absent ones by formula, since they all
// hold q = BIG after the present ones.
//
// What bounds it on an H100: latency.  By bytes (each input read once, the
// [B, C, M] outputs written once) the bench's call (B = 64, C = 10, M = 96,
// A = 512) moves ~2 MB, ~0.6 us of HBM time.  The shared path's critical
// path is one global round trip for the parents, nbits - 1 barriers, at
// most nbits dependent shared loads, one round trip for the gathers and a
// chain's n compares; the chase's is up to M dependent loads on one lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_members_plan.h"

namespace {

constexpr long long BIG = 0x3FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;

// The rank of key (qd, d) among a chain's M keys: the n present ones in
// kc[0, n), the absent ones (BIG, n..M-1) counted as a block.
__device__ __forceinline__ int member_rank(const long long* kc, int n, int M,
                                           long long qd, int d) {
  int r = qd > BIG ? M - n : (qd == BIG && d > n ? d - n : 0);
  for (int e = 0; e < n; ++e) {
    const long long qe = kc[e];
    r += (qe < qd) | ((qe == qd) & (e < d));
  }
  return r;
}

template <typename P>
__global__ void __launch_bounds__(LIFT_THREADS)
    chain_members_lift(const P* __restrict__ q, const P* __restrict__ t,
                       const P* __restrict__ l,
                       const int64_t* __restrict__ parent,
                       const int64_t* __restrict__ end_idx, int C, int A,
                       int M, int nbits, int group,
                       int64_t* __restrict__ mq, int64_t* __restrict__ mt,
                       int64_t* __restrict__ ml, bool* __restrict__ mvalid) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the chains' q keys [group, M], the lifting table [nbits, A], the
  // chains' member counts [group]
  long long* key = reinterpret_cast<long long*>(smem);
  int* tab = reinterpret_cast<int*>(key + (size_t)group * M);
  int* cnt = tab + (size_t)nbits * A;
  const int b = blockIdx.x, c0 = blockIdx.y * group;
  const int64_t row = (int64_t)b * A;
  const int cl = threadIdx.x / M, d = threadIdx.x - cl * M;
  const bool mine = cl < group && c0 + cl < C;
  const long long end = mine ? end_idx[(int64_t)b * C + c0 + cl] : -1;
  for (int i = threadIdx.x; i < A; i += blockDim.x) {
    const long long p = parent[row + i];
    tab[i] = p >= 0 && p < A ? (int)p : -1;
  }
  __syncthreads();
  for (int k = 1; k < nbits; ++k) {
    const int* lo = tab + (size_t)(k - 1) * A;
    int* hi = tab + (size_t)k * A;
    for (int i = threadIdx.x; i < A; i += blockDim.x) {
      const int p = lo[i];
      hi[i] = p < 0 ? -1 : lo[p];
    }
    __syncthreads();
  }
  int cur = end >= 0 && end < A ? (int)end : -1;
  for (int k = 0; k < nbits; ++k)
    if (((d >> k) & 1) && cur >= 0) cur = tab[(size_t)k * A + cur];
  long long qd = BIG, td = BIG, ld = 0;
  if (mine && cur >= 0) {
    qd = (long long)q[row + cur];
    td = (long long)t[row + cur];
    ld = (long long)l[row + cur];
    if (d == M - 1 || tab[cur] < 0) cnt[cl] = d + 1;
  } else if (mine && d == 0) {
    cnt[cl] = 0;
  }
  if (mine) key[threadIdx.x] = qd;
  __syncthreads();
  if (!mine) return;
  const int64_t o = ((int64_t)b * C + c0 + cl) * M +
                    member_rank(key + (size_t)cl * M, cnt[cl], M, qd, d);
  mq[o] = qd;
  mt[o] = td;
  ml[o] = ld;
  mvalid[o] = qd < BIG;
}

template <typename P>
__global__ void chain_members_chase(const P* __restrict__ q,
                                    const P* __restrict__ t,
                                    const P* __restrict__ l,
                                    const int64_t* __restrict__ parent,
                                    const int64_t* __restrict__ end_idx,
                                    int C, int A, int M, int warps,
                                    int stage, int64_t* __restrict__ mq,
                                    int64_t* __restrict__ mt,
                                    int64_t* __restrict__ ml,
                                    bool* __restrict__ mvalid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.y * warps + warp;
  const int64_t* prow = parent + (int64_t)b * A;
  // member q values (int64) then member indices (int32), M each per warp
  int64_t* qw = reinterpret_cast<int64_t*>(smem) + (size_t)warp * M;
  int* iw = reinterpret_cast<int*>(reinterpret_cast<int64_t*>(smem)
                                   + (size_t)warps * M) + (size_t)warp * M;
  int* par_s = reinterpret_cast<int*>(reinterpret_cast<int64_t*>(smem)
                                      + (size_t)warps * M)
               + (size_t)warps * M;
  if (stage) {
    for (int i = threadIdx.x; i < A; i += blockDim.x)
      par_s[i] = (int)prow[i];
    __syncthreads();
  }
  if (c >= C) return;

  int n = 0;
  if (lane == 0) {
    long long cur = end_idx[(int64_t)b * C + c];
    while (n < M && cur >= 0 && cur < A) {
      iw[n++] = (int)cur;
      cur = stage ? (long long)par_s[cur] : (long long)prow[cur];
    }
  }
  n = __shfl_sync(FULL, n, 0);
  __syncwarp();
  const P* qrow = q + (int64_t)b * A;
  const P* trow = t + (int64_t)b * A;
  const P* lrow = l + (int64_t)b * A;
  int le_big = 0;  // present members with q <= BIG
  for (int d = lane; d < n; d += 32) {
    const long long qd = (long long)qrow[iw[d]];
    qw[d] = qd;
    le_big += qd <= BIG;
  }
  for (int o = 16; o > 0; o >>= 1) le_big += __shfl_xor_sync(FULL, le_big, o);
  __syncwarp();

  const int64_t out0 = ((int64_t)b * C + c) * M;
  for (int d = lane; d < M; d += 32) {
    int r;
    long long qd = BIG, td = BIG, ld = 0;
    if (d < n) {
      qd = qw[d];
      r = qd > BIG ? M - n : 0;  // the absent members sort below q > BIG
      for (int e = 0; e < n; ++e) {
        const long long qe = qw[e];
        r += (qe < qd) | ((qe == qd) & (e < d));
      }
      const int i = iw[d];
      td = (long long)trow[i];
      ld = (long long)lrow[i];
    } else {
      r = le_big + (d - n);
    }
    mq[out0 + r] = qd;
    mt[out0 + r] = td;
    ml[out0 + r] = ld;
    mvalid[out0 + r] = qd < BIG;
  }
}

template <typename P>
cudaError_t launch(const void* q, const void* t, const void* l,
                   const int64_t* parent, const int64_t* end_idx, int B,
                   int C, int A, int M, int warps, int stage, size_t smem,
                   cudaStream_t st, int64_t* mq, int64_t* mt, int64_t* ml,
                   bool* mvalid) {
  const P* qp = static_cast<const P*>(q);
  const P* tp = static_cast<const P*>(t);
  const P* lp = static_cast<const P*>(l);
  const dim3 grid(B, (C + warps - 1) / warps);
  if (stage == 2)
    chain_members_lift<P><<<grid, (warps * M + 31) / 32 * 32, smem, st>>>(
        qp, tp, lp, parent, end_idx, C, A, M, lift_bits(M), warps, mq, mt,
        ml, mvalid);
  else
    chain_members_chase<P><<<grid, 32 * warps, smem, st>>>(
        qp, tp, lp, parent, end_idx, C, A, M, warps, stage, mq, mt, ml,
        mvalid);
  return cudaGetLastError();
}

}  // namespace

// Every instance's opt-in to the most dynamic shared memory, on the
// current device; called once per device before any launch
// (blasr_setup_kernels), never while a stream is captured.
extern "C" int blasr_chain_members_setup() {
  const void* fns[] = {
      reinterpret_cast<const void*>(chain_members_lift<int64_t>),
      reinterpret_cast<const void*>(chain_members_lift<int32_t>),
      reinterpret_cast<const void*>(chain_members_chase<int64_t>),
      reinterpret_cast<const void*>(chain_members_chase<int32_t>)};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYNAMIC_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int blasr_chain_members(const void* q, const void* t,
                                   const void* l, int wide,
                                   const int64_t* parent,
                                   const int64_t* end_idx, int B, int C,
                                   int A, int M, int warps, int stage,
                                   int64_t* mq, int64_t* mt, int64_t* ml,
                                   bool* mvalid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = blasr_chain_members_smem(A, M, warps, stage);
  if (smem > (size_t)SMEM_DYNAMIC_MAX || stage < 0 || stage > 2 ||
      warps < 1 || (stage == 2 ? warps * M > LIFT_THREADS : warps > 32))
    return (int)cudaErrorInvalidValue;
  return (int)(wide ? launch<int64_t>(q, t, l, parent, end_idx, B, C, A, M,
                                      warps, stage, smem, st, mq, mt, ml,
                                      mvalid)
                    : launch<int32_t>(q, t, l, parent, end_idx, B, C, A, M,
                                      warps, stage, smem, st, mq, mt, ml,
                                      mvalid));
}
