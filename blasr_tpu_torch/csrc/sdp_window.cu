// K4: the short-tuple SDP window pass of the band guide, the whole function
// in one launch.
//
// Replaces blasr_tpu/kernels/sdp.py::window_fragment_diags_banded, one XLA
// program: the window k-mer keys, the per-row slab start and a fori_loop
// over the D diagonals of the slab (no Pallas kernel on the TPU).  It
// computes exactly what kernels/sdp.py::window_fragment_diags_banded_plain
// computes, from the function's own inputs (read keys int64 holding uint32
// and their flags, window bases int8, window lengths, guide offsets): for
// row n and query position q, the first and the second s in [0, D), in
// ascending order, with wslice[n, q + s] == rk[n, q], reported as diagonal
// dlo[n] + s (0 and invalid where there is none).
//   * dlo[n] = clamp((min + max of offs[n, q] + w_b/2 - q) // 2 - D // 2,
//     -(L + D), W), a block reduction over the row, floor division on int64;
//   * wslice[n, j] is the window key at p = dlo[n] + j: the k <= 32 bases
//     p..p+k-1 shifted in two bits at a time (uint32, so k = 16 uses the top
//     bit), valid iff every base is < 4 and p + k <= wlens[n]; an invalid
//     key, and every p outside [0, W), is 0xFFFFFFFF (the JAX package's
//     padded dynamic slice, whose start clamp is a no-op for dlo in
//     [-(L + D), W]);
//   * the read key is 0xFFFFFFFE where rvalid is false.  The sentinels
//     compare like any key, as in JAX (an all-T 16-mer read key meets the
//     invalid window positions).
//
// Layout: a grid over (row, tile of TQ query positions), 256 threads.
// Each CTA reduces its row's offsets for dlo itself (16 KB of L2 reads at
// L = 2048, 512 KB at L = 65536), stages the window bytes its tile's slab
// touches (TQ + D + k - 2, plain coalesced loads: the span starts at any
// byte, which a 16-byte-aligned bulk copy cannot express), and builds the
// TQ + D - 1 slab keys in shared memory.  A warp then takes 32 query
// positions at a time, one at a time: lane i compares slab[q + s0 + i]
// with the position's key, and __ballot_sync with __ffs gives the first
// (and the second) hit among 32 diagonals in one step, four steps per
// round, stopping at the occ-th hit: at most D/32 steps instead of D.
// The lowest diagonal wins, as in JAX.  Neighbouring lanes read
// neighbouring words, so the slab reads are free of bank conflicts.  Lane
// j keeps position j's result, so the int64 diagonals and flags leave in
// coalesced stores.
//
// What bounds it on an H100: the bytes of the function (read keys and
// flags, windows, offsets in; diagonals and flags out: 14.4 MB at N = 192,
// L = 2048) over HBM, ~4 us; the compares this run needs are below that at
// the card's integer rate.  Positions with no hit walk all D diagonals, so
// the time follows the share of read positions without a match in their
// slab.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "setup.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr uint32_t INVALID_WINDOW = 0xFFFFFFFFu;
constexpr uint32_t INVALID_READ = 0xFFFFFFFEu;

struct Args {
  const int64_t* rkeys;
  const uint8_t* rvalid;
  const int8_t* windows;
  const void* wlens;
  const void* offs;
  int wlens64, offs64;
  int N, L, W, k, D, occ, half_wb, TQ, tiles;
  int64_t* diag;
  uint8_t* valid;
};

__device__ __forceinline__ long long load_int(const void* p, int is64,
                                              size_t i) {
  return is64 ? (long long)__ldg(static_cast<const long long*>(p) + i)
              : (long long)__ldg(static_cast<const int*>(p) + i);
}

// Hits of one 32-diagonal step (ballot b, diagonals s0..s0+31) folded into
// the running (hits, d0, d1); true once the occ-th hit is found.
__device__ __forceinline__ bool take_hits(unsigned b, int s0, int occ,
                                          int& hits, int& d0, int& d1) {
  if (b == 0u) return false;
  if (hits == 0) {
    d0 = s0 + __ffs(b) - 1;
    hits = 1;
    if (occ == 1) return true;
    b &= b - 1u;
    if (b == 0u) return false;
  }
  d1 = s0 + __ffs(b) - 1;
  hits = 2;
  return true;
}

__global__ void __launch_bounds__(THREADS) sdp_window_kernel(Args a) {
  extern __shared__ uint32_t s_key[];  // TQ + D + 128 keys, then the bytes
  __shared__ long long s_red[32];
  const int n = blockIdx.x / a.tiles;
  const int q0 = (blockIdx.x % a.tiles) * a.TQ;
  const int L = a.L, W = a.W, D = a.D, k = a.k;
  const int nq = min(a.TQ, L - q0);
  int8_t* s_byte = reinterpret_cast<int8_t*>(s_key + a.TQ + D + 128);

  // 1. the row's slab start
  long long lo = LLONG_MAX, hi = LLONG_MIN;
  for (int q = threadIdx.x; q < L; q += THREADS) {
    const long long d = load_int(a.offs, a.offs64, (size_t)n * L + q) +
                        a.half_wb - q;
    lo = min(lo, d);
    hi = max(hi, d);
  }
  lo = blasr::block_reduce(lo, s_red, blasr::MinOp());
  hi = blasr::block_reduce(hi, s_red, blasr::MaxOp());
  long long dl = blasr::floordiv(lo + hi, 2) - D / 2;
  dl = min(max(dl, -(long long)(L + D)), (long long)W);
  const int dlo = (int)dl;

  // 2. the tile's slab keys: window positions p0 .. p0 + nq + D - 2
  const int p0 = dlo + q0;
  const int nkeys = nq + D - 1;
  const int8_t* wrow = a.windows + (size_t)n * W;
  for (int j = threadIdx.x; j < nkeys + k - 1; j += THREADS) {
    const int p = p0 + j;
    s_byte[j] = (p >= 0 && p < W) ? wrow[p] : (int8_t)4;
  }
  const long long wlen = load_int(a.wlens, a.wlens64, n);
  __syncthreads();
  for (int j = threadIdx.x; j < nkeys; j += THREADS) {
    const int p = p0 + j;
    uint32_t key = INVALID_WINDOW;
    if (p >= 0 && p < W && (long long)p + k <= wlen) {
      uint32_t x = 0;
      bool ok = true;
      for (int b = 0; b < k; ++b) {
        const int v = s_byte[j + b];
        ok &= v < 4;
        x = (x << 2) | (uint32_t)(v & 3);
      }
      if (ok) key = x;
    }
    s_key[j] = key;
  }
  __syncthreads();

  // 3. the compares: a warp per 32 query positions, a lane per diagonal
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int occ = a.occ;
  for (int g0 = warp * 32; g0 < nq; g0 += WARPS * 32) {
    const int q = q0 + g0 + lane;
    const bool has = g0 + lane < nq;
    const size_t rq = (size_t)n * L + q;
    uint32_t key = 0;
    if (has) key = a.rvalid[rq] ? (uint32_t)a.rkeys[rq] : INVALID_READ;
    int my_hits = 0, my_d0 = 0, my_d1 = 0;
    const int npos = min(32, nq - g0);
    for (int j = 0; j < npos; ++j) {
      const uint32_t kj = __shfl_sync(0xffffffffu, key, j);
      const uint32_t* slab = s_key + g0 + j;
      int hits = 0, d0 = 0, d1 = 0;
      bool done = false;
      for (int s0 = 0; s0 < D && !done; s0 += 128) {
        unsigned b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = s0 + 32 * u + lane;
          b[u] = __ballot_sync(0xffffffffu, s < D && slab[s] == kj);
        }
        if ((b[0] | b[1] | b[2] | b[3]) == 0u) continue;
#pragma unroll
        for (int u = 0; u < 4 && !done; ++u)
          done = take_hits(b[u], s0 + 32 * u, occ, hits, d0, d1);
      }
      if (lane == j) {
        my_hits = hits;
        my_d0 = d0;
        my_d1 = d1;
      }
    }
    if (has) {
      const size_t o = rq * occ;
      a.diag[o] = my_hits >= 1 ? (int64_t)dlo + my_d0 : 0;
      a.valid[o] = my_hits >= 1;
      if (occ == 2) {
        a.diag[o + 1] = my_hits >= 2 ? (int64_t)dlo + my_d1 : 0;
        a.valid[o + 1] = my_hits >= 2;
      }
    }
  }
}

}  // namespace

// Query positions per CTA: TQ = 512 (1024 past L = 8192, so that a long
// row's CTAs re-read its offsets fewer times), never more than L.
static int query_tile(int L) {
  const int TQ = L <= 8192 ? 512 : 1024;
  return TQ < L ? TQ : L;
}

extern "C" size_t blasr_sdp_window_smem(int L, int D, int k) {
  const int TQ = query_tile(L);
  return (size_t)(TQ + D + 128) * sizeof(uint32_t) + (size_t)(TQ + D + k + 16);
}

// The opt-in to all the dynamic shared memory a block can take beside the
// kernel's static arrays, on the current device, so that a launch of any
// (L, D, k) the wrapper admits needs no attribute call of its own (one
// that lowered it would fail a captured launch of a larger tile); called
// once per device before any launch (blasr_setup_kernels), never while a
// stream is captured.
extern "C" int blasr_sdp_window_setup() {
  return (int)blasr::opt_in_max(
      reinterpret_cast<const void*>(sdp_window_kernel));
}

extern "C" int blasr_sdp_window(const int64_t* rkeys, const uint8_t* rvalid,
                                const int8_t* windows, const void* wlens,
                                int wlens64, const void* offs, int offs64,
                                int N, int L, int W, int k, int D, int occ,
                                int half_wb, int64_t* diag, uint8_t* valid,
                                void* stream) {
  Args a{rkeys, rvalid, windows, wlens, offs, wlens64, offs64, N, L, W, k,
         D, occ, half_wb, 0, 0, diag, valid};
  a.TQ = query_tile(L);
  a.tiles = (L + a.TQ - 1) / a.TQ;
  const size_t smem = blasr_sdp_window_smem(L, D, k);
  sdp_window_kernel<<<N * a.tiles, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
