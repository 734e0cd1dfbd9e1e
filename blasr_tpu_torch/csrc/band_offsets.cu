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
// Layout: one CTA of 256 threads per item; thread t owns the R = ceil(L / 256)
// consecutive rows [t R, t R + R) (R = 1, 2, 4, 8 unrolled at compile time).
// Each fill or scan is a serial pass over a thread's own rows, one block-wide
// exclusive scan of the threads' aggregates (one barrier: warp shuffles, then
// each thread folds the warp totals before its own), and a second serial pass
// that applies the carry.  The prefix max and the suffix min of a fill share
// one block scan, so an item costs four of them (the members' fills, the
// folded fills, the offsets' cummax, the slope limit; three without fragments)
// and ten barriers in all, where one row a thread costs ~12 scans of three
// barriers per 1024 rows.  The rows' three int32 arrays (arr, nx, and ff or
// the running offsets) live in shared memory, each padded by one word in 32 so
// that the threads' strided passes do not collide in the banks: 25 KB an item
// at L = 2048, so several CTAs share an SM and call 1's 640 items fill the
// card in one wave.  Members scatter with atomicMax and mark their rows in a
// bitmask.  The fragment fold stages the item's slot flags in shared memory by
// 16-byte loads (while the members scatter), walks the L * F slots in flat
// order, gathers the diagonal of a flagged slot only (four in flight per
// thread) and folds each slot that counts into its row with a shared
// atomicMax.  Above SMEM_MAX_ROWS rows (L = 16384 to 65536, the long reads'
// buckets) band_offsets_rows keeps the row-parallel layout, which measured
// half the time of the thread-owned rows there: 1024 threads, the rows in a
// global scratch, every scan in chunks of 1024 rows, one row a thread.
//
// What bounds it on an H100: bytes.  Read whole, the fragments (an int64
// diagonal and a flag per slot, 9 B x F per row) would dominate: ~35 MB for
// the first call of a bench batch (640 items, L = 2048, F = 3), ~10 us of HBM
// time, and the earlier layouts read them at about that rate.  The result
// depends only on the flagged slots' diagonals, so the kernel reads the flags
// (1 B a slot), those diagonals, the members and writes the int64 offsets: ~15
// MB on that call.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

using blasr::block_scan;

constexpr int DBITS = 15;
constexpr int DBIAS = 1 << (DBITS - 1);
constexpr int DMASK = 2 * DBIAS - 1;
constexpr int SENT = 0x7FFFFFFF;
constexpr long long BIG32 = 0x3FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_THREADS = 256;
constexpr int GLOBAL_THREADS = 1024;
// rows kept in shared memory at most (cuda_ops.BAND_SMEM_ROWS); above,
// the wrapper allocates 2 * L int32 words of scratch an item
constexpr int SMEM_MAX_ROWS = 8192;
constexpr int FOLD_LOADS = 4;   // fragment slots in flight per thread
// dynamic shared memory a CTA may take: the 227 KB of sm_90 less the
// static arrays and a margin
constexpr int SMEM_DYNAMIC_MAX = 232448 - 4096;

struct Args {
  int L, W, w_b, MC, F, between_only, R, S, stage_flags;
};

struct Flank {
  bool ok;
  int row, diag;
};

__device__ __forceinline__ Flank unpack(int packed, bool ok) {
  return Flank{ok, packed >> DBITS, (packed & DMASK) - DBIAS};
}

// the three padded int32 row arrays' bytes, rounded up to 16
__host__ __device__ constexpr size_t rows_bytes(int S) {
  return (3 * (size_t)S * 4 + 15) / 16 * 16;
}

// one word of padding in 32: row r's slot in a padded array
__device__ __forceinline__ int pad(int r) { return r + (r >> 5); }

__host__ __device__ constexpr int padded_len(int L) {
  return L + (L >> 5) + 1;
}

// Exclusive scans over the threads of the block, in thread order: the max
// of the values of the threads before this one (INT_MIN for thread 0) and
// the min of the values of the threads after it (INT_MAX for the last).
// One barrier; s_w (64 ints) must not be rewritten before every thread
// has passed one more barrier (the rounds alternate two buffers).
__device__ __forceinline__ void scan_both(int vmax, int vmin, int& before,
                                          int& after, int* s_w) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int pm = vmax, sm = vmin;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, pm, o);
    const int d = __shfl_down_sync(FULL, sm, o);
    if (lane >= o) pm = max(pm, u);
    if (lane + o < 32) sm = min(sm, d);
  }
  if (lane == 31) s_w[w] = pm;
  if (lane == 0) s_w[32 + w] = sm;
  __syncthreads();
  int b = __shfl_up_sync(FULL, pm, 1);
  int a = __shfl_down_sync(FULL, sm, 1);
  if (lane == 0) b = INT_MIN;
  if (lane == 31) a = INT_MAX;
  for (int i = 0; i < w; ++i) b = max(b, s_w[i]);
  for (int i = w + 1; i < nw; ++i) a = min(a, s_w[32 + i]);
  before = b;
  after = a;
}

// Exclusive prefix max (MAX) or min over the threads of the block, in
// thread order; the same one barrier and buffer rule as scan_both.
template <bool MAX>
__device__ __forceinline__ int scan_before(int v, int* s_w) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ident = MAX ? INT_MIN : INT_MAX;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = MAX ? max(v, u) : min(v, u);
  }
  if (lane == 31) s_w[w] = v;
  __syncthreads();
  int b = __shfl_up_sync(FULL, v, 1);
  if (lane == 0) b = ident;
  for (int i = 0; i < w; ++i) b = MAX ? max(b, s_w[i]) : min(b, s_w[i]);
  return b;
}

// Backward over the thread's rows [r0, r0 + R) (those below L): nx[r] =
// the suffix min of (arr >= 0 ? arr : SENT) within them; returns the rows'
// max of arr and that min.  RT > 0: R == RT at compile time (unrolled).
template <int RT>
__device__ __forceinline__ void fill_back(const int* arr, int* nx, int r0,
                                          int R, int L, int& vmax,
                                          int& vmin) {
  vmax = INT_MIN;
  vmin = INT_MAX;
#pragma unroll
  for (int i = (RT > 0 ? RT : R) - 1; i >= 0; --i) {
    const int r = r0 + i;
    if (r < L) {
      const int v = arr[pad(r)];
      vmax = max(vmax, v);
      vmin = min(vmin, v >= 0 ? v : SENT);
      nx[pad(r)] = vmin;
    }
  }
}

__device__ __forceinline__ int clamp_diag(long long d) {
  return (int)(d < -DBIAS + 1 ? -DBIAS + 1 : (d > DBIAS - 2 ? DBIAS - 2 : d));
}

// The flanking diagonal range of a row from its fills; false if the row
// has no flank (both needed under between_only).
__device__ __forceinline__ bool flank_range(int f0, int x0, bool between_only,
                                            int& lo_d, int& hi_d) {
  const Flank p = unpack(f0, f0 >= 0), x = unpack(x0, x0 < SENT);
  lo_d = (p.ok && x.ok) ? min(p.diag, x.diag) : (p.ok ? p.diag : x.diag);
  hi_d = (p.ok && x.ok) ? max(p.diag, x.diag) : (p.ok ? p.diag : x.diag);
  return between_only ? (p.ok && x.ok) : (p.ok || x.ok);
}

// The band offset of row r from its fills (the interpolation and clamp).
__device__ __forceinline__ int row_offset(int r, int ffr, int nxr,
                                          const Args& a) {
  const Flank p = unpack(ffr, ffr >= 0), x = unpack(nxr, nxr < SENT);
  int d;
  if (p.ok && x.ok) {
    // |r - p.row| < 2^16 and |x.diag - p.diag| < 2^15: the product fits
    // 32 bits; the quotient rounds toward minus infinity (den > 0)
    const int num = (r - p.row) * (x.diag - p.diag);
    const int den = max(x.row - p.row, 1);
    const int qt = num / den;
    d = p.diag + qt - (num % den != 0 && num < 0 ? 1 : 0);
  } else {
    d = p.ok ? p.diag : (x.ok ? x.diag : 0);
  }
  long long o = (long long)r + d - a.w_b / 2;
  o = o < 0 ? 0 : o;
  o = o > a.W - a.w_b ? a.W - a.w_b : o;
  return (int)o;
}

// Rows in shared memory (L <= SMEM_MAX_ROWS); RT > 0: R == RT.
template <int RT>
__global__ void __launch_bounds__(SMEM_THREADS) band_offsets_kernel(
    const int64_t* __restrict__ mq, const int64_t* __restrict__ mt,
    const int64_t* __restrict__ ws, const int64_t* __restrict__ frag_diag,
    const uint8_t* __restrict__ frag_valid, Args a,
    int64_t* __restrict__ out) {
  extern __shared__ int s_rows[];
  __shared__ int s_w[2][64];
  __shared__ uint32_t s_member[SMEM_MAX_ROWS / 32];   // rows with a member
  const int n = blockIdx.x;
  const int L = a.L, F = a.F, T = SMEM_THREADS;
  const int R = RT > 0 ? RT : a.R;
  int* arr = s_rows;
  int* nx = arr + a.S;
  int* ff = nx + a.S;
  const int r0 = threadIdx.x * R;
  const long long LF = (long long)L * F;
  const uint8_t* fv_n = frag_valid + (size_t)n * LF;
  const uint8_t* flags = fv_n;
  if (F > 0 && a.stage_flags) {
    // the item's slot flags into shared memory, 16 bytes a load where the
    // row is so aligned; read while the members scatter
    uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_rows) + rows_bytes(a.S);
    long long e = threadIdx.x;
    if ((reinterpret_cast<uintptr_t>(fv_n) & 15) == 0) {
      for (; e < LF / 16; e += T)
        reinterpret_cast<uint4*>(s_flag)[e] =
            __ldg(reinterpret_cast<const uint4*>(fv_n) + e);
      e = LF / 16 * 16 + threadIdx.x;
    }
    for (; e < LF; e += T) s_flag[e] = fv_n[e];
    flags = s_flag;
  }

  // scatter-max of the chain members
  for (int r = threadIdx.x; r < L; r += T) arr[pad(r)] = -1;
  for (int i = threadIdx.x; i < (L + 31) / 32; i += T) s_member[i] = 0u;
  __syncthreads();
  const long long wsn = ws[n];
  for (int j = threadIdx.x; j < a.MC; j += T) {
    const long long q = mq[(size_t)n * a.MC + j];
    const long long t = mt[(size_t)n * a.MC + j];
    if (q >= BIG32) continue;
    const int d = clamp_diag(t - wsn - q);
    const int packed = (int)((q << DBITS) | (d + DBIAS));
    const long long row = q < 0 ? 0 : (q > L - 1 ? L - 1 : q);
    atomicMax(&arr[pad((int)row)], packed);
  }
  __syncthreads();

  int vmax, vmin, cmax, cmin;
  if (F > 0) {
    // round 1: the fills of the members alone, kept per row
    fill_back<RT>(arr, nx, r0, R, L, vmax, vmin);
    scan_both(vmax, vmin, cmax, cmin, s_w[0]);
#pragma unroll
    for (int i = 0; i < (RT > 0 ? RT : R); ++i) {
      const int r = r0 + i;
      if (r < L) {
        const int v = arr[pad(r)];
        cmax = max(cmax, v);
        ff[pad(r)] = cmax;
        nx[pad(r)] = min(nx[pad(r)], cmin);
        if (v >= 0) atomicOr(&s_member[r >> 5], 1u << (r & 31));
      }
    }
    __syncthreads();
    // fragment fold over the item's L * F slots in flat order: a slot
    // counts if its flag is set, its row has no member and a flank, and
    // its diagonal lies within one band of the flanking diagonals; the row
    // keeps the max packed (r, fd).  Only the flagged slots' diagonals are
    // read, FOLD_LOADS of them in flight per thread, each issued as soon
    // as its flag is seen (the row's tests come after)
    const int64_t* fd_n = frag_diag + (size_t)n * LF;
    const int drow = T / F, df = T - drow * F;
    int row = threadIdx.x / F, f = threadIdx.x - row * F;
    for (long long e0 = threadIdx.x; e0 < LF; e0 += (long long)T * FOLD_LOADS) {
      long long fd[FOLD_LOADS];
      int fr[FOLD_LOADS];
      bool set[FOLD_LOADS];
#pragma unroll
      for (int u = 0; u < FOLD_LOADS; ++u) {
        const long long e = e0 + (long long)u * T;
        fr[u] = row;
        set[u] = e < LF && flags[e];
        if (set[u]) fd[u] = fd_n[e];
        row += drow;
        f += df;
        if (f >= F) {
          f -= F;
          ++row;
        }
      }
#pragma unroll
      for (int u = 0; u < FOLD_LOADS; ++u) {
        const int r = fr[u];
        int lo_d, hi_d;
        if (!set[u] || ((s_member[r >> 5] >> (r & 31)) & 1u) ||
            !flank_range(ff[pad(r)], nx[pad(r)], a.between_only, lo_d, hi_d))
          continue;
        const int d = clamp_diag(fd[u]);
        if (d >= lo_d - a.w_b && d <= hi_d + a.w_b)
          atomicMax(&arr[pad(r)], (r << DBITS) | (d + DBIAS));
      }
    }
    __syncthreads();
  }

  // round 2: the fills, the interpolation and the clamp; ff keeps the
  // running max of the offsets over the thread's rows
  fill_back<RT>(arr, nx, r0, R, L, vmax, vmin);
  scan_both(vmax, vmin, cmax, cmin, s_w[1]);
  int omax = INT_MIN;
#pragma unroll
  for (int i = 0; i < (RT > 0 ? RT : R); ++i) {
    const int r = r0 + i;
    if (r < L) {
      cmax = max(cmax, arr[pad(r)]);
      omax = max(omax, row_offset(r, cmax, min(nx[pad(r)], cmin), a));
      ff[pad(r)] = omax;
    }
  }
  // round 3: cummax of the offsets; the running min of off - 2 r
  const int c3 = scan_before<true>(omax, s_w[0]);
  int lmin = INT_MAX;
#pragma unroll
  for (int i = 0; i < (RT > 0 ? RT : R); ++i) {
    const int r = r0 + i;
    if (r < L) {
      lmin = min(lmin, max(c3, ff[pad(r)]) - 2 * r);
      nx[pad(r)] = lmin;
    }
  }
  // round 4: the slope limit
  const int c4 = scan_before<false>(lmin, s_w[1]);
#pragma unroll
  for (int i = 0; i < (RT > 0 ? RT : R); ++i) {
    const int r = r0 + i;
    if (r < L) arr[pad(r)] = 2 * r + min(c4, nx[pad(r)]);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < L; r += T)
    out[(size_t)n * L + r] = arr[pad(r)];
}

// nx[r] = suffix min of (arr >= 0 ? arr : SENT), walking the row backward
// in chunks of one element a thread
__device__ void suffix_fill(const int* arr, int* nx, int L, int* s_warp) {
  int carry = INT_MAX;
  for (int c0 = 0; c0 < L; c0 += GLOBAL_THREADS) {
    const int r = L - 1 - (c0 + (int)threadIdx.x);
    int v = INT_MAX;
    if (r >= 0) v = arr[r] >= 0 ? arr[r] : SENT;
    v = block_scan(v, carry, s_warp, blasr::MinOp());
    if (r >= 0) nx[r] = v;
  }
  __syncthreads();
}

// Rows beyond shared memory (L > SMEM_MAX_ROWS): one CTA
// of 1024 threads per item, the row's packed array and its suffix fill in
// an int32 scratch row in global memory, every scan over the row in
// chunks of 1024, one row a thread (coalesced), with the block's running
// max or min carried from chunk to chunk (backward for the suffix fill).
__global__ void __launch_bounds__(GLOBAL_THREADS) band_offsets_rows(
    const int64_t* __restrict__ mq, const int64_t* __restrict__ mt,
    const int64_t* __restrict__ ws, const int64_t* __restrict__ frag_diag,
    const uint8_t* __restrict__ frag_valid, Args a,
    int* __restrict__ scratch, int64_t* __restrict__ out) {
  __shared__ int s_warp[32];
  const int n = blockIdx.x;
  const int L = a.L, F = a.F;
  int* arr = scratch + (size_t)n * 2 * L;
  int* nx = arr + L;

  for (int r = threadIdx.x; r < L; r += GLOBAL_THREADS) arr[r] = -1;
  __syncthreads();
  const long long wsn = ws[n];
  for (int j = threadIdx.x; j < a.MC; j += GLOBAL_THREADS) {
    const long long q = mq[(size_t)n * a.MC + j];
    const long long t = mt[(size_t)n * a.MC + j];
    if (q >= BIG32) continue;
    const int d = clamp_diag(t - wsn - q);
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
    for (int c0 = 0; c0 < L; c0 += GLOBAL_THREADS) {
      const int r = c0 + threadIdx.x;
      const int a0 = r < L ? arr[r] : INT_MIN;
      const int f0 = block_scan(a0, carry, s_warp, blasr::MaxOp());
      int lo_d, hi_d;
      if (r < L && a0 < 0 &&
          flank_range(f0, nx[r], a.between_only, lo_d, hi_d)) {
        int fp = -1;
        const size_t fb = ((size_t)n * L + r) * F;
        for (int f = 0; f < F; ++f) {
          const int d = clamp_diag(frag_diag[fb + f]);
          if (frag_valid[fb + f] && d >= lo_d - a.w_b && d <= hi_d + a.w_b)
            fp = max(fp, (r << DBITS) | (d + DBIAS));
        }
        arr[r] = fp;
      }
    }
    __syncthreads();
    suffix_fill(arr, nx, L, s_warp);
  }

  // interpolation, clamp, cummax and the slope limit
  int c_ff = INT_MIN, c_off = INT_MIN, c_lim = INT_MAX;
  for (int c0 = 0; c0 < L; c0 += GLOBAL_THREADS) {
    const int r = c0 + threadIdx.x;
    const int f0 = block_scan(r < L ? arr[r] : INT_MIN, c_ff, s_warp,
                              blasr::MaxOp());
    int off = r < L ? row_offset(r, f0, nx[r], a) : INT_MIN;
    off = block_scan(off, c_off, s_warp, blasr::MaxOp());
    const int lim = block_scan(r < L ? off - 2 * r : INT_MAX, c_lim, s_warp,
                               blasr::MinOp());
    if (r < L) out[(size_t)n * L + r] = 2LL * r + lim;
  }
}

template <int RT>
cudaError_t launch_smem(int N, size_t smem, cudaStream_t st,
                        const int64_t* mq, const int64_t* mt,
                        const int64_t* ws, const int64_t* frag_diag,
                        const uint8_t* frag_valid, const Args& a,
                        int64_t* out) {
  band_offsets_kernel<RT><<<N, SMEM_THREADS, smem, st>>>(
      mq, mt, ws, frag_diag, frag_valid, a, out);
  return cudaGetLastError();
}

}  // namespace

// Every instance's opt-in to the most dynamic shared memory, on the
// current device; called once per device before any launch
// (blasr_setup_kernels), never while a stream is captured.
extern "C" int blasr_band_offsets_setup() {
  const void* fns[] = {reinterpret_cast<const void*>(band_offsets_kernel<0>),
                       reinterpret_cast<const void*>(band_offsets_kernel<1>),
                       reinterpret_cast<const void*>(band_offsets_kernel<2>),
                       reinterpret_cast<const void*>(band_offsets_kernel<4>),
                       reinterpret_cast<const void*>(band_offsets_kernel<8>)};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYNAMIC_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int blasr_band_offsets(const int64_t* mq, const int64_t* mt,
                                  const int64_t* ws, const int64_t* frag_diag,
                                  const uint8_t* frag_valid, int N, int MC,
                                  int L, int W, int w_b, int F,
                                  int between_only, int* scratch, int64_t* out,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int R = (L + SMEM_THREADS - 1) / SMEM_THREADS;
  // the slot flags join the rows in shared memory where both fit
  size_t smem = rows_bytes(padded_len(L));
  const size_t flag_bytes = ((size_t)L * F + 15) / 16 * 16;
  const int stage_flags = F > 0 && smem + flag_bytes <= SMEM_DYNAMIC_MAX;
  if (stage_flags) smem += flag_bytes;
  const Args a{L, W, w_b, MC, F, between_only, R, padded_len(L),
               stage_flags};
  if (L > SMEM_MAX_ROWS) {
    band_offsets_rows<<<N, GLOBAL_THREADS, 0, st>>>(
        mq, mt, ws, frag_diag, frag_valid, a, scratch, out);
    return (int)cudaGetLastError();
  }
  switch (R) {
    case 1: return (int)launch_smem<1>(N, smem, st, mq, mt, ws, frag_diag,
                                       frag_valid, a, out);
    case 2: return (int)launch_smem<2>(N, smem, st, mq, mt, ws, frag_diag,
                                       frag_valid, a, out);
    case 4: return (int)launch_smem<4>(N, smem, st, mq, mt, ws, frag_diag,
                                       frag_valid, a, out);
    case 8: return (int)launch_smem<8>(N, smem, st, mq, mt, ws, frag_diag,
                                       frag_valid, a, out);
    default: return (int)launch_smem<0>(N, smem, st, mq, mt, ws, frag_diag,
                                        frag_valid, a, out);
  }
}
