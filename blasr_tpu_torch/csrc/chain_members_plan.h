// K7's launch plan: the shared memory each of its paths needs and the path
// a call takes.  Host code only, with no CUDA header, so that it builds
// with a plain C++ compiler too (tests/test_torch_sdp.py builds it with g++
// to hold kernels/cuda_ops.py::chain_members_plan to these sizes on a
// machine without nvcc).  Included once, by chain_members.cu.
//
// The `stage` of a launch names its path:
//   2  the shared path (chain_members_lift): one CTA a row, `warps` chains
//      a CTA at one thread a member slot, the row's binary-lifting table
//      in shared memory;
//   1  the chase (chain_members_chase): `warps` warps of one chain each,
//      the row's parents staged in shared memory as int32;
//   0  the chase reading the row's parents from global memory.

#include <stddef.h>

// shared memory a block may opt into on sm_90 (227 KB), less a margin
constexpr int SMEM_DYNAMIC_MAX = 232448 - 4096;
// the shared path's threads a CTA, one per member slot
constexpr int LIFT_THREADS = 1024;

inline int lift_bits(int M) {
  int nbits = 0;
  while ((1 << nbits) < M) ++nbits;  // bit_length(M - 1)
  return nbits > 1 ? nbits : 1;
}

// Shared memory a launch needs.  Stage 2: the chains' M int64 keys, the
// lifting table (nbits int32 levels of A) and a count per chain.  Stage 0
// or 1: per warp M int64 q values and M int32 indices, then (stage 1) the
// row's A parents as int32.
extern "C" size_t blasr_chain_members_smem(int A, int M, int warps,
                                           int stage) {
  if (stage == 2)
    return (size_t)warps * M * 8 + (size_t)lift_bits(M) * A * 4 +
           (size_t)warps * 4;
  return (size_t)warps * M * 12 + (stage ? (size_t)A * 4 : 0);
}

extern "C" int blasr_chain_members_max_smem() { return SMEM_DYNAMIC_MAX; }

// The launch of a call of C > 0 chains of M members over rows of A
// anchors, as plan[0] = warps, plan[1] = stage: the shared path while the
// lifting table fits beside min(C, 1024 / M) chains' keys; else the chase
// at up to four warps, as many as their member buffers allow, with the
// parents staged while they fit too.  Returns 1 where no path holds a
// chain's M members.
extern "C" int blasr_chain_members_plan(int C, int A, int M, int* plan) {
  if (M <= LIFT_THREADS) {
    const int group = C < LIFT_THREADS / M ? C : LIFT_THREADS / M;
    if (blasr_chain_members_smem(A, M, group, 2) <= SMEM_DYNAMIC_MAX) {
      plan[0] = group;
      plan[1] = 2;
      return 0;
    }
  }
  int warps = C < 4 ? C : 4;
  while (warps > 1 &&
         blasr_chain_members_smem(A, M, warps, 0) > SMEM_DYNAMIC_MAX)
    warps /= 2;
  if (blasr_chain_members_smem(A, M, warps, 0) > SMEM_DYNAMIC_MAX) return 1;
  plan[0] = warps;
  plan[1] = blasr_chain_members_smem(A, M, warps, 1) <= SMEM_DYNAMIC_MAX;
  return 0;
}
