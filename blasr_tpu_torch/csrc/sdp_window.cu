// K4: the short-tuple SDP window pass of the band guide.
//
// Replaces blasr_tpu/kernels/sdp.py::window_fragment_diags_banded, an XLA
// fori_loop over the D diagonals of a slab (no Pallas kernel on the TPU;
// eager torch pays ~10 launches per 32-diagonal chunk).  It computes
// exactly what kernels/sdp.py::window_fragment_diags_banded_plain
// computes: for row n and query position q, the first and the second
// s in [0, D), in ascending order, with wslice[n, q + s] == rk[n, q],
// reported as diagonal dlo[n] + s (0 and invalid where there is none).
// wslice[n, j] is the window key at dlo[n] + j, or 0xFFFFFFFF outside
// [0, W): the JAX package's padded dynamic slice, whose start clamp is a
// no-op for dlo in [-(L + D), W].  The wrapper passes the keys already
// masked (invalid window k-mers 0xFFFFFFFF, invalid read k-mers
// 0xFFFFFFFE) as uint32 bit patterns, and dlo.
//
// Layout: one CTA of 256 threads per row.  The row's L + D slab keys are
// staged in shared memory once (10 KB at L = 2048, D = 512); each thread
// owns q = tid, tid + 256, ... and walks s upward from 0, stopping at its
// occ-th hit.  Neighbouring lanes read neighbouring words, so the slab
// reads are free of bank conflicts.  Where L + D keys exceed what a block
// can hold (bucket 65536: 264 KB), the query positions go in tiles of TQ
// and each tile stages its own TQ + D slab keys; with TQ = L it is the
// single stage above, so the result does not depend on the tiling.
//
// What bounds it on an H100: the compares, at most N * L * D of them (one
// shared-memory load and one integer compare each), are ~3 us of the
// card's integer rate; the bytes (keys in, diagonals and flags out) ~2 us
// of HBM time.  Positions with no hit walk all D diagonals, so the time
// follows the share of read positions without a match in their slab.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t INVALID_WINDOW = 0xFFFFFFFFu;

__global__ void __launch_bounds__(THREADS) sdp_window_kernel(
    const uint32_t* __restrict__ rk, const uint32_t* __restrict__ wk,
    const int32_t* __restrict__ dlo_in, int L, int W, int D, int occ,
    int TQ, int32_t* __restrict__ diag, uint8_t* __restrict__ valid) {
  extern __shared__ uint32_t s_w[];
  const int n = blockIdx.x;
  const int dlo = dlo_in[n];
  const uint32_t* wrow = wk + (size_t)n * W;
  const uint32_t* rrow = rk + (size_t)n * L;
  for (int q0 = 0; q0 < L; q0 += TQ) {
    const int nq = min(TQ, L - q0);
    __syncthreads();  // the previous tile's slab is no longer read
    for (int j = threadIdx.x; j < nq + D; j += THREADS) {
      const int pos = dlo + q0 + j;
      s_w[j] = (pos >= 0 && pos < W) ? wrow[pos] : INVALID_WINDOW;
    }
    __syncthreads();
    for (int q = q0 + threadIdx.x; q < q0 + nq; q += THREADS) {
      const uint32_t key = rrow[q];
      const uint32_t* slab = s_w + (q - q0);
      int d0 = 0, d1 = 0, hits = 0;
      for (int s = 0; s < D; ++s) {
        if (slab[s] == key) {
          if (hits == 0) {
            d0 = dlo + s;
          } else {
            d1 = dlo + s;
          }
          if (++hits == occ) break;
        }
      }
      const size_t o = ((size_t)n * L + q) * occ;
      diag[o] = d0;
      valid[o] = hits >= 1;
      if (occ == 2) {
        diag[o + 1] = d1;
        valid[o + 1] = hits >= 2;
      }
    }
  }
}

}  // namespace

extern "C" int blasr_sdp_window(const uint32_t* rkeys, const uint32_t* wkeys,
                                const int32_t* dlo, int N, int L, int W,
                                int D, int occ, int32_t* diag, uint8_t* valid,
                                void* stream) {
  // query positions per tile: all L where the slab fits in the shared
  // memory a block may opt into (less a margin), else as many as fit
  const int max_keys = (232448 - 1024) / (int)sizeof(uint32_t);
  if (D + THREADS > max_keys) return (int)cudaErrorInvalidValue;
  const int TQ = L + D <= max_keys ? L : (max_keys - D) / THREADS * THREADS;
  const size_t smem = (size_t)(TQ + D) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sdp_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sdp_window_kernel<<<N, THREADS, smem, (cudaStream_t)stream>>>(
      rkeys, wkeys, dlo, L, W, D, occ, TQ, diag, valid);
  return (int)cudaGetLastError();
}
