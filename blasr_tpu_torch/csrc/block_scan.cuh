// Device helpers shared by K4 (sdp_window.cu), K5 (anchor_search.cu) and
// K6 (band_offsets.cu).
#pragma once

#include <cuda_runtime.h>

namespace blasr {

struct MaxOp {
  template <class T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a > b ? a : b;
  }
};

struct MinOp {
  template <class T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a < b ? a : b;
  }
};

struct AddOp {
  template <class T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a + b;
  }
};

// Block-wide inclusive scan under `op` of one value per thread, in thread
// order, continuing from `carry`: every thread gets its prefix and `carry`
// becomes the running value after the block's last thread, so a row walked
// in chunks of 1024 scans as one.  For blocks of 1024 threads; s_warp
// holds 32 values.  Four barriers, every thread of the block must call it.
template <class T, class Op>
__device__ __forceinline__ T block_scan(T v, T& carry, T* s_warp, Op op) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = op(v, u);
  }
  if (lane == 31) s_warp[w] = v;
  __syncthreads();
  if (w == 0) {
    T x = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T u = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x = op(x, u);
    }
    s_warp[lane] = x;
  }
  __syncthreads();
  if (w > 0) v = op(v, s_warp[w - 1]);
  v = op(v, carry);
  const T tot = s_warp[31];
  __syncthreads();
  carry = op(carry, tot);
  return v;
}

// Block-wide reduction under `op` of one value per thread, for any block
// of whole warps (at most 1024 threads): every thread gets the result.
// s_warp holds 32 values.  Two barriers, every thread must call it.
template <class T, class Op>
__device__ __forceinline__ T block_reduce(T v, T* s_warp, Op op) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) s_warp[w] = v;
  __syncthreads();
  T x = s_warp[0];
  for (int i = 1; i < nw; ++i) x = op(x, s_warp[i]);
  __syncthreads();
  return x;
}

// Python's // on integers: the quotient rounded toward minus infinity
// (CUDA's / truncates toward zero).
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

}  // namespace blasr
