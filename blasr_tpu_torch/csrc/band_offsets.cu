// K6: the band offsets of the guided banded DP, one launch per call.
//
// Replaces blasr_tpu/pipeline/map_read.py::_band_offsets, an XLA program
// inside the jitted map_batch on the TPU (no Pallas kernel; eager torch
// pays ~45 launches per call, two calls per batch).  It computes exactly
// what pipeline/map_read.py::_band_offsets_plain computes, per item n and
// query row r:
//
//   arr[r]  = max over chain members m with row(m) == r of
//             (mq << 15) | (clamp(mt - ws - mq, -16383, 16382) + 16384),
//             -1 where there is none (invalid members: mq == BIG32);
//   fills:  ff = prefix max of arr (the nearest member at <= r),
//           nx = suffix min of (arr >= 0 ? arr : SENT) (the one at >= r),
//           each unpacked to (ok, row, diagonal);
//   fold (with fragments): rows without a member take the max packed
//           (r, fd) over the fragments within one band of the flanking
//           diagonal range (both flanks under between_only), then fill
//           again;
//   d = the flanks' floor-division interpolation, or the one flank, or 0;
//   off = cummax(clamp(r + d - w_b / 2, 0, W - w_b)),
//   out = 2 r + cummin(off - 2 r)  (monotone, slope 0..2 per row).
//
// Layout: one CTA of 1024 threads per item.  The row's packed array and
// its suffix fill live in an int32 scratch row in global memory (L2 at the
// main path's shapes: 16 KB an item at L = 2048), so any L up to 65536
// runs; every scan walks the row in chunks of 1024, one element a thread,
// with the block's running max or min carried from chunk to chunk
// (backward for the suffix fill).  Members scatter with atomicMax.  The
// floor division is written out (CUDA's / truncates toward zero and the
// interpolation's numerators go negative).
//
// What bounds it on an H100: bytes.  The fragments (int64 diagonal and a
// flag per slot, 9 B x O per row) dominate: ~12 MB for the first call of a
// bench batch (640 items, L = 2048, O = 3), ~4 us of HBM time; the members
// and the int64 offsets add ~11 MB.  The scratch row stays in L2, and the
// chunked scans cost ~4 barriers per 1024 rows.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

using blasr::block_scan;
using blasr::floordiv;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int DBITS = 15;
constexpr int DBIAS = 1 << (DBITS - 1);
constexpr int DMASK = 2 * DBIAS - 1;
constexpr int SENT = 0x7FFFFFFF;
constexpr long long BIG32 = 0x3FFFFFFF;

struct Args {
  int L, W, w_b, MC, F, between_only;
};

struct Flank {
  bool ok;
  int row, diag;
};

__device__ __forceinline__ Flank unpack(int packed, bool ok) {
  return Flank{ok, packed >> DBITS, (packed & DMASK) - DBIAS};
}

// nx[r] = suffix min of (arr >= 0 ? arr : SENT), walking the row backward
__device__ void suffix_fill(const int* arr, int* nx, int L, int* s_warp) {
  int carry = INT_MAX;
  for (int c0 = 0; c0 < L; c0 += THREADS) {
    const int r = L - 1 - (c0 + (int)threadIdx.x);
    int v = INT_MAX;
    if (r >= 0) v = arr[r] >= 0 ? arr[r] : SENT;
    v = block_scan(v, carry, s_warp, blasr::MinOp());
    if (r >= 0) nx[r] = v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) band_offsets_kernel(
    const int64_t* __restrict__ mq, const int64_t* __restrict__ mt,
    const int64_t* __restrict__ ws, const int64_t* __restrict__ frag_diag,
    const uint8_t* __restrict__ frag_valid, Args a, int* __restrict__ scratch,
    int64_t* __restrict__ out) {
  __shared__ int s_warp[WARPS];
  const int n = blockIdx.x;
  const int L = a.L, F = a.F;
  int* arr = scratch + (size_t)n * 2 * L;
  int* nx = arr + L;

  // scatter-max of the chain members
  for (int r = threadIdx.x; r < L; r += THREADS) arr[r] = -1;
  __syncthreads();
  const long long wsn = ws[n];
  for (int j = threadIdx.x; j < a.MC; j += THREADS) {
    const long long q = mq[(size_t)n * a.MC + j];
    if (q >= BIG32) continue;
    long long d = mt[(size_t)n * a.MC + j] - wsn - q;
    d = d < -DBIAS + 1 ? -DBIAS + 1 : (d > DBIAS - 2 ? DBIAS - 2 : d);
    const int packed = (int)((q << DBITS) | (d + DBIAS));
    const long long row = q < 0 ? 0 : (q > L - 1 ? L - 1 : q);
    atomicMax(&arr[row], packed);
  }
  __syncthreads();
  suffix_fill(arr, nx, L, s_warp);

  if (F > 0) {
    // fragment fold: rows without a member take the best fragment within
    // one band of the flanking diagonals
    int carry = INT_MIN;
    for (int c0 = 0; c0 < L; c0 += THREADS) {
      const int r = c0 + threadIdx.x;
      const int a0 = r < L ? arr[r] : INT_MIN;
      const int ff = block_scan(a0, carry, s_warp, blasr::MaxOp());
      if (r < L) {
        const int nxr = nx[r];
        const Flank p = unpack(ff, ff >= 0), x = unpack(nxr, nxr < SENT);
        const int lo_d = (p.ok && x.ok) ? min(p.diag, x.diag)
                                        : (p.ok ? p.diag : x.diag);
        const int hi_d = (p.ok && x.ok) ? max(p.diag, x.diag)
                                        : (p.ok ? p.diag : x.diag);
        const bool flank = a.between_only ? (p.ok && x.ok) : (p.ok || x.ok);
        int fp = -1;
        const size_t fb = ((size_t)n * L + r) * F;
        for (int f = 0; f < F; ++f) {
          long long fd = frag_diag[fb + f];
          fd = fd < -DBIAS + 1 ? -DBIAS + 1 : (fd > DBIAS - 2 ? DBIAS - 2 : fd);
          if (frag_valid[fb + f] && flank && fd >= (long long)lo_d - a.w_b &&
              fd <= (long long)hi_d + a.w_b) {
            fp = max(fp, (r << DBITS) | ((int)fd + DBIAS));
          }
        }
        if (a0 < 0) arr[r] = fp;
      }
    }
    __syncthreads();
    suffix_fill(arr, nx, L, s_warp);
  }

  // interpolation, clamp, cummax and the slope limit
  int c_ff = INT_MIN, c_off = INT_MIN, c_lim = INT_MAX;
  const int half = a.w_b / 2;
  for (int c0 = 0; c0 < L; c0 += THREADS) {
    const int r = c0 + threadIdx.x;
    const int ff = block_scan(r < L ? arr[r] : INT_MIN, c_ff, s_warp,
                              blasr::MaxOp());
    int off = INT_MIN;
    if (r < L) {
      const int nxr = nx[r];
      const Flank p = unpack(ff, ff >= 0), x = unpack(nxr, nxr < SENT);
      long long d;
      if (p.ok && x.ok) {
        const long long denom = max(x.row - p.row, 1);
        d = p.diag + floordiv((long long)(r - p.row) * (x.diag - p.diag),
                              denom);
      } else {
        d = p.ok ? p.diag : (x.ok ? x.diag : 0);
      }
      long long o = r + d - half;
      o = o < 0 ? 0 : o;
      o = o > a.W - a.w_b ? a.W - a.w_b : o;
      off = (int)o;
    }
    off = block_scan(off, c_off, s_warp, blasr::MaxOp());
    const int lim = block_scan(r < L ? off - 2 * r : INT_MAX, c_lim, s_warp,
                               blasr::MinOp());
    if (r < L) out[(size_t)n * L + r] = 2LL * r + lim;
  }
}

}  // namespace

extern "C" int blasr_band_offsets(const int64_t* mq, const int64_t* mt,
                                  const int64_t* ws, const int64_t* frag_diag,
                                  const uint8_t* frag_valid, int N, int MC,
                                  int L, int W, int w_b, int F,
                                  int between_only, int* scratch, int64_t* out,
                                  void* stream) {
  const Args a{L, W, w_b, MC, F, between_only};
  band_offsets_kernel<<<N, THREADS, 0, (cudaStream_t)stream>>>(
      mq, mt, ws, frag_diag, frag_valid, a, scratch, out);
  return (int)cudaGetLastError();
}
