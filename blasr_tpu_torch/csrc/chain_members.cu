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
// Layout: one CTA per (row, group of up to four chains), one warp a chain.
// The row's parent pointers are staged in shared memory as int32 (int64 in
// global memory) while they fit beside the warps' member buffers, else the
// chase reads them from global memory.  Lane 0 chases at most M pointers and
// records the member indices; the lanes then gather each member's q into
// shared memory, and lane j ranks the members d = j, j + 32, ... by counting
// the members with a smaller (q, d): the n present members against each other
// (n^2 / 32 compares a lane), the absent ones by formula, since they all hold
// q = BIG after the present ones.  Each member is written once, at its rank.
// Chains longer than M keep the M members nearest their end, as the lifting
// does.  Nothing assumes that q falls along a chain.
//
// What bounds it on an H100: the pointer chase, a chain of dependent
// shared-memory loads on one lane (~M x 30 cycles).  By bytes (each input
// read once, the [B, C, M] outputs written once) the bench's call (B = 64,
// C = 10, M = 96, A = 512) moves ~2 MB, ~0.6 us of HBM time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long BIG = 0x3FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_DYNAMIC_MAX = 232448 - 4096;

template <typename P>
__global__ void chain_members_kernel(const P* __restrict__ q,
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
  const dim3 grid(B, (C + warps - 1) / warps);
  chain_members_kernel<P><<<grid, 32 * warps, smem, st>>>(
      static_cast<const P*>(q), static_cast<const P*>(t),
      static_cast<const P*>(l), parent, end_idx, C, A, M, warps, stage, mq,
      mt, ml, mvalid);
  return cudaGetLastError();
}

}  // namespace

// Both instances' opt-in to the most dynamic shared memory, on the current
// device; called once per device before any launch (blasr_setup_kernels),
// never while a stream is captured.
extern "C" int blasr_chain_members_setup() {
  const void* fns[] = {
      reinterpret_cast<const void*>(chain_members_kernel<int64_t>),
      reinterpret_cast<const void*>(chain_members_kernel<int32_t>)};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYNAMIC_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Shared memory a launch needs: per warp M int64 q values and M int32
// indices, then (stage != 0) the row's A parents as int32.
extern "C" size_t blasr_chain_members_smem(int A, int M, int warps,
                                           int stage) {
  return (size_t)warps * M * 12 + (stage ? (size_t)A * 4 : 0);
}

extern "C" int blasr_chain_members_max_smem() { return SMEM_DYNAMIC_MAX; }

extern "C" int blasr_chain_members(const void* q, const void* t,
                                   const void* l, int wide,
                                   const int64_t* parent,
                                   const int64_t* end_idx, int B, int C,
                                   int A, int M, int warps, int stage,
                                   int64_t* mq, int64_t* mt, int64_t* ml,
                                   bool* mvalid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = blasr_chain_members_smem(A, M, warps, stage);
  if (smem > (size_t)SMEM_DYNAMIC_MAX) return (int)cudaErrorInvalidValue;
  return (int)(wide ? launch<int64_t>(q, t, l, parent, end_idx, B, C, A, M,
                                      warps, stage, smem, st, mq, mt, ml,
                                      mvalid)
                    : launch<int32_t>(q, t, l, parent, end_idx, B, C, A, M,
                                      warps, stage, smem, st, mq, mt, ml,
                                      mvalid));
}
