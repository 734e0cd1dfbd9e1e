// K5: the anchor search of the mapping path, two kernels in one call.
//
// Replaces blasr_tpu/kernels/anchor.py::find_anchors, one jitted XLA
// program on the TPU (no Pallas kernel; eager torch pays ~330 launches per
// call).  It computes exactly what kernels/anchor.py::find_anchors_plain
// computes, every field of Anchors:
//
//   per read position q (candidate kernel, one thread each):
//     the k-mer key and its validity; the occurrence range [lo, hi) from
//     the paired LUT rows, the LUT, or a binary search of the sorted keys;
//     nocc = hi - lo, pos_ok = valid & 0 < nocc <= max_anchors_per_pos;
//     per occurrence slot o < O: the strided rotating index
//       idx = clamp(lo + (nocc > O ? (o*(nocc/O) + o*(nocc%O)/O + q)
//                                      % max(nocc, 1) : o), 0, M - 1),
//     or, in the block mode (occ_block_sample, the JAX branch at
//     blasr_tpu/kernels/anchor.py:167-192), a contiguous window from
//       base = lo + (nocc > O ? int32(q * 97) mod (nocc - O + 1) : 0),
//       idx = clamp(base + o, 0, M - 1), and the record of row
//       clamp(base, 0, rec_rows - O) + o (one O-row slice, RECORDS_PAD
//       rows included in rec_rows),
//     the 24-byte record (or the separate gathers), the containment prune
//     (periodic representatives every E/2), the 16-base XOR/ctz extension,
//     the length (clamped to max_lcp), hits_t / hits_valid, and
//     nlogp = fma(len - k, LOG4, log(M / max(nocc, 1)));
//     and the row's seed counts (its valid k-mers, the sum of their nocc,
//     those with nocc > O, the sum of min(nocc, O)), per 256-position
//     block, summed per row by the selection kernel, which adds the
//     row's anchors kept, min(n_total, A);
//   per row (selection kernel, one CTA each):
//     the advance_exact suppression (a prefix max over positions), n_total,
//     the top-A by the rank (-len << nbits) + bitrev(flat) with the invalid
//     candidates in flat order after the valid ones, then the stable sort
//     of the A selected by (valid ? t : BIG).
//
// Selection without a sort of L * O candidates: valid ranks are unique, so
// the top-A valid set is {len > Lt} plus the `need` smallest bit-reversed
// indices among {len == Lt}, where Lt comes from a histogram of the valid
// lengths and the bit-reversed threshold from a radix select (8-bit digits,
// <= 4 passes).  If fewer than A are valid, the first invalid candidates in
// flat order fill the rest (a block-wide ordered compaction).  The A
// selected are then sorted by one 64-bit key: (valid ? t : BIG) in the top
// 31 bits, then the candidate's position in the first order: ((lmax - len)
// << nbits | bitrev) for a valid one, 2^32 + its rank in flat order for an
// invalid one.  That is the stable two-sort order of the plain version, a
// valid anchor at t >= BIG included.
//
// Rounding: the division M / nocc is __fdiv_rn, the log is the Cephes
// polynomial of kernels/xla_math.py step for step, and each of its fused
// multiply-adds is computed as the plain version computes it (a float64
// product, exact, a float64 sum, one rounding to float32); every other
// float op is an _rn intrinsic, so nvcc contracts nothing.  Keys are uint32
// bit patterns, positions int32 as in the JAX package; the kernels write
// the port's int64 fields directly.
//
// What bounds it on an H100: bytes, and of those the dependent gathers:
// one LUT row and one 24-byte record (1-2 DRAM sectors) per candidate
// slot; the reads, anchors and raw hits are a few MB.  Counting only the
// hits that survive, the bench shapes (2B = 64 rows, L = 2048, O = 3) need
// ~10 MB, ~3 us of HBM time; but every slot's record is gathered (hits_t
// holds every slot's position, and the first invalid candidates' lengths
// can be output), ~33 MB of sectors, ~10 us at the HBM rate, which the
// candidate kernel nearly reaches.  What the design does about it:
//
//   candidates: a CTA stages its 256 positions' read bytes in shared
//     memory once (the k-mer, the previous base and the extension words
//     come from there); the O record gathers of a position are all issued
//     before any is used (O = 1..4 unrolled at compile time, larger O in
//     groups of four); the strided index is 32-bit (one division by O and
//     one modulo by nocc per position, then a subtraction per slot) when
//     M < 2^31 and O < 2^16, the 64-bit floor arithmetic otherwise;
//   selection: one CTA of 1024 threads per row whose chain of barriers is
//     short: the row's meta words staged in shared memory when they fit (the
//     bench shapes; the long reads' 196,608 a row stay in L2, swept with
//     eight loads in flight a thread), warp-aggregated shared atomics for
//     the histograms, one warp (not one thread) for the total, the clip sum,
//     the threshold length and each radix digit, warp-aggregated slot
//     reservation in the collect, and a sort of the A keys that orders each
//     32 in registers by shuffles and then merges runs pairwise by rank (a
//     binary search a key; 5 barriers at A = 512, where the bitonic
//     network's stage per barrier took 45).  Each row stays on one SM: at
//     the bench shape 64 rows take 64 SMs for ~10 us; the long reads' two
//     rows sweep their candidates from L2 a few times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

using blasr::block_scan;
using blasr::floordiv;

constexpr int CAND_THREADS = 256;
constexpr int SEL_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t ALL_N = 0xFFFFFFFFu;
constexpr uint32_t VALID_BIT = 0x10000u;   // meta word: length | valid << 16
constexpr long long BIG = 0x3FFFFFFF;
constexpr int CACHED_WORDS = 4;            // read words kept per thread
constexpr int SWEEP_LOADS = 8;             // meta words in flight a thread
constexpr int MERGE_MAX = 4096;            // the most keys merge-sorted
// dynamic shared memory the selection CTA may take: sm_90's 227 KB less
// its static arrays (cuda_ops.ANCHOR_SELECT_STATIC bounds them)
constexpr int SELECT_DYNAMIC_MAX = 232448 - 10560;
// a row's meta words are staged in the selection CTA's shared memory when
// all of its dynamic arrays fit in this many bytes
constexpr size_t STAGE_BYTES = 160 * 1024;
// a row's seed counts: valid k-mers, their occurrences, those with more
// than O, the occurrences examined (a block's share of each: SEED_PARTS),
// then the anchors kept
constexpr int SEED_PARTS = 4;
constexpr int SEED_COUNTS = 5;

// float32 constants as the plain version rounds them (decimal -> float64
// -> float32)
constexpr float LOG4 = (float)1.3862944;
constexpr float P0 = (float)7.0376836292E-2, P1 = (float)-1.1514610310E-1,
                P2 = (float)1.1676998740E-1, P3 = (float)-1.2420140846E-1,
                P4 = (float)1.4249322787E-1, P5 = (float)-1.6668057665E-1,
                P6 = (float)2.0000714765E-1, P7 = (float)-2.4999993993E-1,
                P8 = (float)3.3333331174E-1;
constexpr float Q1 = (float)-2.12194440e-4, Q2 = (float)0.693359375;
constexpr float SQRTHF = (float)0.707106781186547524;
constexpr float MIN_NORM = 0x1p-126f;

struct Index {
  const int8_t* genome;
  const int64_t* keys_sorted;
  const int64_t* pos_sorted;
  const int32_t* bucket_starts;
  const int32_t* bucket_pairs;
  const int32_t* records;
  const int64_t* gwords;
  const int64_t* gnwords;
  long long G, M;
  int lookup;   // 0 paired LUT rows, 1 LUT, 2 sorted-key search
  int use_rec;  // fused 24-byte records
  int block;    // occ_block_sample: a contiguous occurrence window
  long long rec_rows;  // rows of the records table (>= M)
};

struct Shape {
  int B, L, O, k, E, min_match, max_lcp, advance_exact;
  int A_out, nbits, lmax, nblk, P, span, stage;
  long long mapp;
  float m_total;
};

__device__ __forceinline__ long long floormod(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// xla_math.fma_f32: round_f32(a * b + c) through float64
__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// xla_math.log_f32: XLA's CPU float32 log, step for step
__device__ float log_f32(float x) {
  x = fmaxf(x, MIN_NORM);
  const int bits = __float_as_int(x);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 0x7F), 1.0f);
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
  const bool mask = m < SQRTHF;
  const float tmp = mask ? m : 0.0f;
  m = __fsub_rn(m, 1.0f);
  e = __fsub_rn(e, mask ? 1.0f : 0.0f);
  m = __fadd_rn(m, tmp);
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(x2, m);
  float y = fma_f32(m, P0, P1);
  float y1 = fma_f32(m, P3, P4);
  float y2 = fma_f32(m, P6, P7);
  y = fma_f32(y, m, P2);
  y1 = fma_f32(y1, m, P5);
  y2 = fma_f32(y2, m, P8);
  y = fma_f32(y, x3, y1);
  y = fma_f32(y, x3, y2);
  y = fma_f32(y, x3, __fmul_rn(e, Q1));
  m = fma_f32(x2, -0.5f, m);
  m = __fadd_rn(m, y);
  return fma_f32(e, Q2, m);
}

// the read's 16-base word at staged byte i (2 bits a base, LSB first) and
// its N mask; the staged bytes past the read's end are N
__device__ __forceinline__ void read_word(const int8_t* s_read, int i,
                                          uint32_t& rw, uint32_t& rn) {
  rw = 0u;
  rn = 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = s_read[i + j];
    rw |= (uint32_t)(r & 3) << (2 * j);
    rn |= (r >= 4 ? 3u : 0u) << (2 * j);
  }
}

__device__ __forceinline__ void lookup(const Index& ix, uint32_t key,
                                       long long& lo, long long& hi) {
  if (ix.lookup == 0) {
    const int2 pr = __ldg(reinterpret_cast<const int2*>(ix.bucket_pairs) +
                          key);
    lo = pr.x;
    hi = pr.y;
  } else if (ix.lookup == 1) {
    lo = __ldg(ix.bucket_starts + key);
    hi = __ldg(ix.bucket_starts + (size_t)key + 1);
  } else {  // searchsorted, sides left and right
    long long a = 0, b = ix.M;
    while (a < b) {
      const long long mid = (a + b) >> 1;
      if (ix.keys_sorted[mid] < (long long)key) a = mid + 1; else b = mid;
    }
    lo = a;
    b = ix.M;
    while (a < b) {
      const long long mid = (a + b) >> 1;
      if (ix.keys_sorted[mid] <= (long long)key) a = mid + 1; else b = mid;
    }
    hi = a;
  }
}

// One position's occurrence slots [o0, o0 + G) (those below O): their
// indices, then every gather, then the extension of each.  OT > 0: O ==
// OT at compile time; WIDE: the 64-bit floor arithmetic of the index.
template <int G, int OT, bool WIDE>
__device__ __forceinline__ void slots(
    const Index& ix, const Shape& s, int q, int o0, long long lo,
    long long nocc, long long bbase, uint32_t n_div, uint32_t n_mod,
    uint32_t q_mod,
    bool pos_ok, bool periodic, int rprev, float seed, const int8_t* s_read,
    int sq, const uint32_t* c_rw, const uint32_t* c_rn, size_t gbase,
    int64_t* __restrict__ hits_t, uint8_t* __restrict__ hits_valid,
    uint32_t* __restrict__ meta, float* __restrict__ cnlogp) {
  const int O = OT > 0 ? OT : s.O;
  const int k = s.k;
  const int n_words = (s.E + 15) / 16;
  long long t[G], gprev[G];
  int2 r01[G], r23[G], r45[G];
  bool live[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int o = o0 + g;
    live[g] = OT > 0 || o < O;
    long long occ_off = o, row;
    if (ix.block) {
      // the window's slot o; its record from the clipped slice start
      occ_off = bbase - lo + o;
      row = min(max(bbase, 0LL), ix.rec_rows - O) + o;
    } else if (nocc > O) {
      if (WIDE) {
        const long long st0 = (long long)o * floordiv(nocc, O) +
                              floordiv((long long)o * floormod(nocc, O), O);
        occ_off = floormod(st0 + q, nocc);
      } else {
        // st0 < nocc and q % nocc < nocc: one subtraction wraps the sum
        uint32_t off = (uint32_t)o * n_div + ((uint32_t)o * n_mod) / O + q_mod;
        if (off >= (uint32_t)nocc) off -= (uint32_t)nocc;
        occ_off = off;
      }
    }
    const long long idx = clampll(lo + occ_off, 0, ix.M - 1);
    if (!ix.block) row = idx;
    if (ix.use_rec) {
      const int2* rec = reinterpret_cast<const int2*>(ix.records) + 3 * row;
      if (live[g]) {
        r01[g] = __ldg(rec);
        r23[g] = __ldg(rec + 1);
        r45[g] = n_words > 1 ? __ldg(rec + 2) : make_int2(0, 0);
      }
    } else if (live[g]) {
      t[g] = __ldg(ix.pos_sorted + idx);
    }
  }
  if (!ix.use_rec) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (live[g]) gprev[g] = ix.genome[clampll(t[g] - 1, 0, ix.G - 1)];
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (!live[g]) continue;
    const int o = o0 + g;
    if (ix.use_rec) {
      t[g] = (long long)(uint32_t)r01[g].x;
      gprev[g] = (long long)(uint32_t)r01[g].y;
    }
    bool cv = pos_ok && o < nocc;
    const bool contained =
        q > 0 && t[g] > 0 && gprev[g] == rprev && rprev < 4 && !periodic;
    cv = cv && !contained;
    int ext = 0, full = 1;
    for (int j = 0; j < n_words; ++j) {
      const long long off = k + 16 * j;
      uint32_t gw, gn, rw, rn;
      if (ix.use_rec) {
        const int2 w = j == 0 ? r23[g] : r45[g];
        gw = (uint32_t)w.x;
        gn = (uint32_t)w.y;
      } else {
        const long long gi = clampll(t[g] + off, 0, ix.G - 1);
        gw = (uint32_t)ix.gwords[gi];
        gn = t[g] + off < ix.G ? (uint32_t)ix.gnwords[gi] : ALL_N;
      }
      if (j < CACHED_WORDS) {
        rw = c_rw[j];
        rn = c_rn[j];
      } else {
        read_word(s_read, sq + (int)off, rw, rn);
      }
      const uint32_t diff = (gw ^ rw) | gn | rn;
      const int tz = diff ? __ffs((int)diff) - 1 : 32;
      const int mlen = tz >> 1;
      ext += mlen * full;
      full = full * (mlen == 16 ? 1 : 0);
    }
    int length = k + (ext < s.E ? ext : s.E);
    if (s.max_lcp > 0 && length > s.max_lcp) length = s.max_lcp;
    const bool long_enough = length >= s.min_match;
    hits_t[gbase + o] = t[g];
    hits_valid[gbase + o] = (pos_ok && o < nocc && long_enough) ? 1 : 0;
    cv = cv && long_enough;
    meta[gbase + o] = ((uint32_t)length & 0xFFFFu) | (cv ? VALID_BIT : 0u);
    cnlogp[gbase + o] = fma_f32(__int2float_rn(length - k), LOG4, seed);
  }
}

template <int OT, bool WIDE>
__global__ void __launch_bounds__(CAND_THREADS) anchor_candidates(
    Index ix, Shape s, const int8_t* __restrict__ reads,
    const int32_t* __restrict__ read_len, int64_t* __restrict__ hits_t,
    uint8_t* __restrict__ hits_valid, uint32_t* __restrict__ meta,
    float* __restrict__ cnlogp, uint32_t* __restrict__ clip_part,
    unsigned long long* __restrict__ seed_part) {
  extern __shared__ int8_t s_read[];   // bytes [q0 - 1, q0 - 1 + span)
  __shared__ uint32_t s_clip[CAND_THREADS / 32];
  __shared__ unsigned long long s_seeds[CAND_THREADS / 32][SEED_PARTS];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * CAND_THREADS;
  const int q = q0 + threadIdx.x;
  const int L = s.L, O = OT > 0 ? OT : s.O, k = s.k;
  const int8_t* row = reads + (size_t)b * L;
  for (int i = threadIdx.x; i < s.span; i += CAND_THREADS) {
    const long long p = (long long)q0 - 1 + i;
    s_read[i] = (p >= 0 && p < L) ? row[p] : (int8_t)4;
  }
  __syncthreads();
  uint32_t clip = 0;
  unsigned long long seeds[SEED_PARTS] = {0, 0, 0, 0};
  if (q < L) {
    const int sq = threadIdx.x + 1;   // q's staged byte
    uint32_t key = 0;
    bool kok = true;
    for (int j = 0; j < k; ++j) {
      const int r = s_read[sq + j];
      key = (key << 2) | (uint32_t)(r & 3);
      kok = kok && r < 4;
    }
    kok = kok && (long long)q + k <= (long long)read_len[b];
    long long lo, hi;
    lookup(ix, key, lo, hi);
    const long long nocc = hi - lo;
    const bool pos_ok = kok && nocc > 0 && nocc <= s.mapp;
    if (pos_ok && nocc > O) clip = (uint32_t)(nocc - O);
    if (kok) {
      seeds[0] = 1;
      seeds[1] = (unsigned long long)nocc;
      seeds[2] = nocc > O ? 1 : 0;
      seeds[3] = (unsigned long long)(nocc < O ? nocc : O);
    }
    const float seed = log_f32(
        __fdiv_rn(s.m_total, __ll2float_rn(nocc > 1 ? nocc : 1)));
    const int rprev = q > 0 ? (int)s_read[sq - 1] : 4;
    const int keep_stride = s.E / 2 > 1 ? s.E / 2 : 1;
    const bool periodic = q % keep_stride == 0;
    const int n_words = (s.E + 15) / 16;
    uint32_t c_rw[CACHED_WORDS], c_rn[CACHED_WORDS];
#pragma unroll
    for (int j = 0; j < CACHED_WORDS; ++j) {
      if (j < n_words) read_word(s_read, sq + k + 16 * j, c_rw[j], c_rn[j]);
    }
    // the block mode's window base; the 32-bit strided index: nocc / O,
    // nocc % O and q % nocc, once
    long long bbase = lo;
    uint32_t n_div = 0, n_mod = 0, q_mod = 0;
    if (ix.block) {
      if (nocc > O)
        bbase += floormod((long long)(int)((uint32_t)q * 97u), nocc - O + 1);
    } else if (!WIDE && nocc > O) {
      n_div = (uint32_t)nocc / (uint32_t)O;
      n_mod = (uint32_t)nocc - n_div * (uint32_t)O;
      q_mod = (uint32_t)q % (uint32_t)nocc;
    }
    const size_t gbase = ((size_t)b * L + q) * O;
    if constexpr (OT > 0) {
      slots<OT, OT, WIDE>(ix, s, q, 0, lo, nocc, bbase, n_div, n_mod, q_mod,
                          pos_ok, periodic, rprev, seed, s_read, sq, c_rw,
                          c_rn, gbase, hits_t, hits_valid, meta, cnlogp);
    } else {
      for (int o0 = 0; o0 < O; o0 += 4)
        slots<4, 0, WIDE>(ix, s, q, o0, lo, nocc, bbase, n_div, n_mod,
                          q_mod, pos_ok, periodic, rprev, seed, s_read, sq,
                          c_rw, c_rn, gbase, hits_t, hits_valid, meta,
                          cnlogp);
    }
  }
  // the block's share of n_clipped (unsigned: wraps as the int32 sum does)
  // and of the seed counts
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    clip += __shfl_down_sync(FULL, clip, o);
#pragma unroll
    for (int i = 0; i < SEED_PARTS; ++i)
      seeds[i] += __shfl_down_sync(FULL, seeds[i], o);
  }
  if ((threadIdx.x & 31) == 0) {
    s_clip[threadIdx.x >> 5] = clip;
#pragma unroll
    for (int i = 0; i < SEED_PARTS; ++i)
      s_seeds[threadIdx.x >> 5][i] = seeds[i];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const bool w = threadIdx.x < CAND_THREADS / 32;
    uint32_t c = w ? s_clip[threadIdx.x] : 0u;
#pragma unroll
    for (int i = 0; i < SEED_PARTS; ++i)
      seeds[i] = w ? s_seeds[threadIdx.x][i] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      c += __shfl_down_sync(FULL, c, o);
#pragma unroll
      for (int i = 0; i < SEED_PARTS; ++i)
        seeds[i] += __shfl_down_sync(FULL, seeds[i], o);
    }
    if (threadIdx.x == 0) {
      const size_t blk = (size_t)b * s.nblk + blockIdx.x;
      clip_part[blk] = c;
#pragma unroll
      for (int i = 0; i < SEED_PARTS; ++i)
        seed_part[blk * SEED_PARTS + i] = seeds[i];
    }
  }
}

__device__ __forceinline__ uint32_t bitrev(uint32_t flat, int nbits) {
  return __brev(flat) >> (32 - nbits);
}

// fn(u, f) for every meta word u = mv[f] of a row of n, by all the
// threads in lockstep (past n: u = 0, an invalid candidate), with
// SWEEP_LOADS loads in flight per thread
template <class Fn>
__device__ __forceinline__ void sweep(const uint32_t* mv, long long n,
                                      Fn fn) {
  for (long long f0 = 0; f0 < n; f0 += (long long)SEL_THREADS * SWEEP_LOADS) {
    uint32_t u[SWEEP_LOADS];
#pragma unroll
    for (int i = 0; i < SWEEP_LOADS; ++i) {
      const long long f = f0 + (long long)i * SEL_THREADS + threadIdx.x;
      u[i] = f < n ? mv[f] : 0u;
    }
#pragma unroll
    for (int i = 0; i < SWEEP_LOADS; ++i)
      fn(u[i], f0 + (long long)i * SEL_THREADS + threadIdx.x);
  }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Warp 0: the first of `nb` counts, taken in the order c(0), c(1), ...,
// at which the running sum reaches `need` (1 <= need <= the sum of all).
// Returns that index; `before` is the sum of the counts before it.
template <class Count>
__device__ __forceinline__ int warp_find(int nb, int need, Count c,
                                         int& before) {
  const int lane = threadIdx.x & 31;
  int cum = 0;
  for (int i0 = 0; i0 < nb; i0 += 32) {
    const int i = i0 + lane;
    const int v = i < nb ? c(i) : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += u;
    }
    const unsigned hit = __ballot_sync(FULL, cum + incl >= need);
    if (hit) {
      const int first = __ffs(hit) - 1;
      before = cum + __shfl_sync(FULL, incl - v, first);
      return i0 + first;
    }
    cum += __shfl_sync(FULL, incl, 31);
  }
  before = cum;
  return nb - 1;
}

// one bitonic compare-exchange of stage (kk, j < 32) between lanes; the
// direction bit of index i is (i & kk & dir_mask)
__device__ __forceinline__ unsigned long long bitonic_lane(
    unsigned long long key, int i, int kk, int j, int dir_mask) {
  const unsigned long long other = __shfl_xor_sync(FULL, key, j);
  const bool up = (i & kk & dir_mask) == 0;
  const bool lower = (i & j) == 0;
  return (lower == up) ? (key < other ? key : other)
                       : (key > other ? key : other);
}

// the stages (kk, j < 32) of kk = kk_lo .. kk_hi (doubling) on every
// 32-key segment of s_keys[0, P), in registers; then one barrier.  With
// dir_mask = 31 the stages up to kk = 32 sort every segment ascending
// (the full network's alternates them: dir_mask = -1)
__device__ __forceinline__ void bitonic_warps(unsigned long long* s_keys,
                                              int P, int kk_lo, int kk_hi,
                                              int dir_mask) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int seg = warp; seg < P / 32; seg += SEL_THREADS / 32) {
    const int i = seg * 32 + lane;
    unsigned long long key = s_keys[i];
    for (int kk = kk_lo; kk <= kk_hi; kk <<= 1)
      for (int j = (kk < 32 ? kk : 32) >> 1; j > 0; j >>= 1)
        key = bitonic_lane(key, i, kk, j, dir_mask);
    s_keys[i] = key;
  }
  __syncthreads();
}

// Sorts s_keys[0, P) ascending, P a power of two >= 32.  Up to MERGE_MAX
// keys: every 32-key segment in registers (bitonic by shuffles), then
// log2(P / 32) rounds that merge runs pairwise through the buffer s_tmp
// [P], each key moving to its index in its run plus its count of keys
// below it in the partner run (a binary search; the first run's keys go
// before equal ones of the second), one barrier a round.  Above, the
// bitonic network in place (the stages across warps through shared
// memory).  Returns the buffer that holds the sorted keys.
__device__ __forceinline__ unsigned long long* sort_keys(unsigned long long* s_keys,
                                                        unsigned long long* s_tmp,
                                                        int P) {
  const int tid = threadIdx.x;
  if (P > MERGE_MAX) {
    bitonic_warps(s_keys, P, 2, 32, -1);
    for (int kk = 64; kk <= P; kk <<= 1) {
      for (int j = kk >> 1; j >= 32; j >>= 1) {
        for (int p = tid; p < P / 2; p += SEL_THREADS) {
          const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          const unsigned long long a = s_keys[i], c = s_keys[i + j];
          if ((a > c) == ((i & kk) == 0)) {
            s_keys[i] = c;
            s_keys[i + j] = a;
          }
        }
        __syncthreads();
      }
      bitonic_warps(s_keys, P, kk, kk, -1);
    }
    return s_keys;
  }
  bitonic_warps(s_keys, P, 2, 32, 31);
  unsigned long long* src = s_keys;
  unsigned long long* dst = s_tmp;
  for (int run = 32; run < P; run <<= 1) {
    for (int i = tid; i < P; i += SEL_THREADS) {
      const unsigned long long key = src[i];
      const int base = i & ~(2 * run - 1);
      const bool second = (i - base) >= run;
      const unsigned long long* other = src + base + (second ? 0 : run);
      int lo = 0, hi = run;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const unsigned long long o = other[mid];
        if (o < key || (second && o == key)) lo = mid + 1; else hi = mid;
      }
      dst[base + (i & (run - 1)) + lo] = key;
    }
    __syncthreads();
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

__global__ void __launch_bounds__(SEL_THREADS) anchor_select(
    Shape s, const int64_t* __restrict__ hits_t, uint32_t* __restrict__ meta,
    const float* __restrict__ cnlogp, const uint32_t* __restrict__ clip_part,
    const unsigned long long* __restrict__ seed_part,
    int64_t* __restrict__ out_q, int64_t* __restrict__ out_t,
    int64_t* __restrict__ out_l, uint8_t* __restrict__ out_valid,
    float* __restrict__ out_nlogp, int32_t* __restrict__ n_total_out,
    int32_t* __restrict__ n_clipped_out, int64_t* __restrict__ seed_out) {
  extern __shared__ unsigned long long s_keys[];     // [P]
  // [P] for the merge sort (P <= MERGE_MAX), then [A_out], [lmax + 1]
  unsigned long long* s_tmp = s_keys + s.P;
  int32_t* s_inv =
      reinterpret_cast<int32_t*>(s_tmp + (s.P <= MERGE_MAX ? s.P : 0));
  int32_t* s_hist = s_inv + s.A_out;                            // [lmax + 1]
  uint32_t* s_meta = reinterpret_cast<uint32_t*>(s_hist + s.lmax + 1);
  __shared__ long long s_warp[32];
  __shared__ long long s_scan[SEL_THREADS];
  __shared__ int s_dig[2][256];
  __shared__ int s_total, s_lt, s_need, s_cnt;
  __shared__ uint32_t s_prefix;

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x;
  const int L = s.L, O = s.O, nbits = s.nbits, A_out = s.A_out;
  const long long n = (long long)L * O;
  uint32_t* m = meta + (size_t)b * n;
  const int64_t* ht = hits_t + (size_t)b * n;
  const float* np_ = cnlogp + (size_t)b * n;

  // advance_exact: drop positions inside an earlier anchor's exact run
  if (s.advance_exact > 0) {
    long long carry = -1;
    for (int q0 = 0; q0 < L; q0 += SEL_THREADS) {
      const int q = q0 + tid;
      long long reach = -1;
      if (q < L) {
        int maxlen = 0;
        for (int o = 0; o < O; ++o) {
          const uint32_t u = m[(size_t)q * O + o];
          const int len = (u & VALID_BIT) ? (int)(u & 0xFFFFu) : 0;
          maxlen = len > maxlen ? len : maxlen;
        }
        if (maxlen > 0) reach = (long long)q + maxlen - s.advance_exact;
      }
      const long long before = carry;
      s_scan[tid] = block_scan(reach, carry, s_warp, blasr::MaxOp());
      __syncthreads();
      // exclusive prefix max: the previous thread's inclusive one
      const long long prev = tid > 0 ? s_scan[tid - 1] : before;
      __syncthreads();
      if (q < L && q < prev) {
        for (int o = 0; o < O; ++o) m[(size_t)q * O + o] &= ~VALID_BIT;
      }
    }
    __syncthreads();
  }

  // warp 1: the row's seed counts, the sum of its blocks' shares
  if (tid >= 32 && tid < 64) {
    unsigned long long c[SEED_PARTS] = {0, 0, 0, 0};
    for (int i = lane; i < s.nblk; i += 32) {
      const unsigned long long* p =
          seed_part + ((size_t)b * s.nblk + i) * SEED_PARTS;
#pragma unroll
      for (int j = 0; j < SEED_PARTS; ++j) c[j] += p[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < SEED_PARTS; ++j)
        c[j] += __shfl_xor_sync(FULL, c[j], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < SEED_PARTS; ++j)
        seed_out[(size_t)b * SEED_COUNTS + j] = (int64_t)c[j];
    }
  }
  // warp 0's share of the row's clip sums, loaded ahead of its use
  uint32_t clip = 0;
  if (tid < 32) {
    for (int i = lane; i < s.nblk; i += 32)
      clip += clip_part[(size_t)b * s.nblk + i];
  }
  // the row's meta words in shared memory when they fit (the bench
  // shapes), read from L2 otherwise (the long reads' 196,608 a row)
  const uint32_t* mv = m;
  if (s.stage) {
    sweep(m, n, [&](uint32_t u, long long f) {
      if (f < n) s_meta[f] = u;
    });
    mv = s_meta;
  }
  // histogram of the valid lengths, one shared atomic per length a warp
  for (int i = tid; i <= s.lmax; i += SEL_THREADS) s_hist[i] = 0;
  if (tid < 256) s_dig[0][tid] = 0;
  if (tid == 0) s_cnt = 0;
  __syncthreads();
  sweep(mv, n, [&](uint32_t u, long long) {
    const bool v = (u & VALID_BIT) != 0;
    const unsigned peers = __match_any_sync(FULL, v ? (int)(u & 0xFFFFu) : -1);
    if (v && lane == __ffs(peers) - 1)
      atomicAdd(&s_hist[u & 0xFFFFu], __popc(peers));
  });
  __syncthreads();
  // warp 0: the total, the clip sum, the threshold length
  if (tid < 32) {
    int tot = 0;
    for (int i = lane; i <= s.lmax; i += 32) tot += s_hist[i];
    tot = warp_sum(tot);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) clip += __shfl_xor_sync(FULL, clip, o);
    int lt = -1, need = 0;
    if (tot > A_out) {
      // lengths from the longest down: the one at which A is reached
      int before;
      const int i = warp_find(s.lmax + 1, A_out,
                              [&](int i) { return s_hist[s.lmax - i]; },
                              before);
      lt = s.lmax - i;
      need = A_out - before;
    }
    if (lane == 0) {
      s_total = tot;
      s_lt = lt;
      s_need = need;
      s_prefix = 0u;
      n_clipped_out[b] = (int32_t)clip;
      n_total_out[b] = tot;
      seed_out[(size_t)b * SEED_COUNTS + SEED_PARTS] = tot < A_out ? tot
                                                                   : A_out;
    }
  }
  __syncthreads();
  const int total = s_total;
  const int lt = s_lt;   // -1: every valid candidate is selected

  // radix select of the `need` smallest bit-reversed indices at length lt
  if (lt >= 0) {
    int buf = 0;
    for (int shift = ((nbits - 1) / 8) * 8; shift >= 0; shift -= 8) {
      const uint32_t prefix = s_prefix;
      if (tid < 256) s_dig[buf ^ 1][tid] = 0;   // the next pass's counts
      sweep(mv, n, [&](uint32_t u, long long f) {
        if ((u & VALID_BIT) && (int)(u & 0xFFFFu) == lt) {
          const uint32_t rev = bitrev((uint32_t)f, nbits);
          if ((uint32_t)((unsigned long long)rev >> (shift + 8)) == prefix)
            atomicAdd(&s_dig[buf][(rev >> shift) & 255u], 1);
        }
      });
      __syncthreads();
      if (tid < 32) {
        int before;
        const int d = warp_find(256, s_need,
                                [&](int i) { return s_dig[buf][i]; }, before);
        if (lane == 0) {
          s_need -= before;
          s_prefix = (prefix << 8) | (uint32_t)d;
        }
      }
      __syncthreads();
      buf ^= 1;
    }
  }
  const uint32_t rthr = s_prefix;

  // collect the selected valid candidates as sort keys, one shared atomic
  // a warp for their slots
  const int nsel = total < A_out ? total : A_out;
  sweep(mv, n, [&](uint32_t u, long long f) {
    const int len = (int)(u & 0xFFFFu);
    const uint32_t rev = bitrev((uint32_t)f, nbits);
    const bool sel = (u & VALID_BIT) &&
                     !(lt >= 0 && (len < lt || (len == lt && rev > rthr)));
    const unsigned ball = __ballot_sync(FULL, sel);
    if (ball == 0u) return;
    int base = 0;
    if (lane == __ffs(ball) - 1) base = atomicAdd(&s_cnt, __popc(ball));
    base = __shfl_sync(FULL, base, __ffs(ball) - 1);
    if (sel) {
      const int slot = base + __popc(ball & ((1u << lane) - 1u));
      const unsigned long long low =
          ((unsigned long long)(s.lmax - len) << nbits) | rev;
      s_keys[slot] = ((unsigned long long)ht[f] << 33) | low;
    }
  });
  // the first A_out - total invalid candidates in flat order
  if (nsel < A_out) {
    const long long m_inv = A_out - nsel;
    long long carry = 0;
    for (long long f0 = 0; f0 < n && carry < m_inv; f0 += SEL_THREADS) {
      const long long f = f0 + tid;
      const long long flag = (f < n && !(mv[f] & VALID_BIT)) ? 1 : 0;
      const long long rank =
          block_scan(flag, carry, s_warp, blasr::AddOp()) - flag;
      if (flag && rank < m_inv) {
        s_inv[rank] = (int32_t)f;
        s_keys[nsel + rank] = ((unsigned long long)BIG << 33) |
                              (1ull << 32) | (unsigned long long)rank;
      }
    }
  }
  for (int i = A_out + tid; i < s.P; i += SEL_THREADS) s_keys[i] = ~0ull;
  __syncthreads();

  const unsigned long long* sorted = sort_keys(s_keys, s_tmp, s.P);

  // write the A_out slots
  const size_t orow = (size_t)b * A_out;
  for (int i = tid; i < A_out; i += SEL_THREADS) {
    const unsigned long long key = sorted[i];
    const unsigned long long low = key & ((1ull << 33) - 1);
    long long f;
    bool v;
    if (low >> 32) {
      f = s_inv[low & 0xFFFFFFFFull];
      v = false;
    } else {
      const uint32_t rev = (uint32_t)(low & ((1ull << nbits) - 1));
      f = bitrev(rev, nbits);
      v = true;
    }
    const uint32_t u = mv[f];
    out_q[orow + i] = f / O;
    out_t[orow + i] = ht[f];
    out_l[orow + i] = (int64_t)(u & 0xFFFFu);
    out_valid[orow + i] = v ? 1 : 0;
    out_nlogp[orow + i] = np_[f];
  }
}

template <int OT, bool WIDE>
cudaError_t launch_candidates(const Index& ix, const Shape& s,
                              cudaStream_t st, const int8_t* reads,
                              const int32_t* read_len, int64_t* hits_t,
                              uint8_t* hits_valid, uint32_t* meta,
                              float* cnlogp, uint32_t* clip_part,
                              unsigned long long* seed_part) {
  anchor_candidates<OT, WIDE>
      <<<dim3(s.nblk, s.B), CAND_THREADS, s.span, st>>>(
          ix, s, reads, read_len, hits_t, hits_valid, meta, cnlogp,
          clip_part, seed_part);
  return cudaGetLastError();
}

template <bool WIDE>
cudaError_t candidates_for(const Index& ix, const Shape& s, cudaStream_t st,
                           const int8_t* reads, const int32_t* read_len,
                           int64_t* hits_t, uint8_t* hits_valid,
                           uint32_t* meta, float* cnlogp,
                           uint32_t* clip_part,
                           unsigned long long* seed_part) {
  switch (s.O) {
    case 1: return launch_candidates<1, WIDE>(ix, s, st, reads, read_len,
                                              hits_t, hits_valid, meta,
                                              cnlogp, clip_part,
                                              seed_part);
    case 2: return launch_candidates<2, WIDE>(ix, s, st, reads, read_len,
                                              hits_t, hits_valid, meta,
                                              cnlogp, clip_part,
                                              seed_part);
    case 3: return launch_candidates<3, WIDE>(ix, s, st, reads, read_len,
                                              hits_t, hits_valid, meta,
                                              cnlogp, clip_part,
                                              seed_part);
    case 4: return launch_candidates<4, WIDE>(ix, s, st, reads, read_len,
                                              hits_t, hits_valid, meta,
                                              cnlogp, clip_part,
                                              seed_part);
    default: return launch_candidates<0, WIDE>(ix, s, st, reads, read_len,
                                               hits_t, hits_valid, meta,
                                               cnlogp, clip_part,
                                              seed_part);
  }
}

int anchor_search(
    int block, long long rec_rows,
    const int8_t* reads, const int32_t* read_len, const int8_t* genome,
    const int64_t* keys_sorted, const int64_t* pos_sorted,
    const int32_t* bucket_starts, const int32_t* bucket_pairs,
    const int32_t* records, const int64_t* gwords, const int64_t* gnwords,
    long long G, long long M, int lookup_mode, int use_rec, int B, int L,
    int O, int k, int E, int min_match, long long mapp, int max_lcp,
    int advance_exact, int A_out, int nbits, int lmax, float m_total,
    int64_t* hits_t, uint8_t* hits_valid, uint32_t* meta, float* cnlogp,
    uint32_t* clip_part, unsigned long long* seed_part, int64_t* out_q,
    int64_t* out_t, int64_t* out_l, uint8_t* out_valid, float* out_nlogp,
    int32_t* n_total, int32_t* n_clipped, int64_t* seed_counts,
    void* stream) {
  const Index ix{genome, keys_sorted, pos_sorted, bucket_starts, bucket_pairs,
                 records, gwords, gnwords, G, M, lookup_mode, use_rec,
                 block, rec_rows};
  int P = 32;
  while (P < A_out) P <<= 1;
  const int nblk = (L + CAND_THREADS - 1) / CAND_THREADS;
  // staged read bytes: the previous base, 256 positions, a k-mer and the
  // extension words past the last
  const int span = 1 + CAND_THREADS + k + 16 * ((E + 15) / 16);
  size_t smem = (size_t)P * (P <= MERGE_MAX ? 16 : 8) + (size_t)A_out * 4 +
                (size_t)(lmax + 1) * 4;
  const long long n = (long long)L * O;
  const int stage = smem + 4 * (size_t)n <= STAGE_BYTES;
  if (stage) smem += 4 * (size_t)n;
  const Shape s{B, L, O, k, E, min_match, max_lcp, advance_exact,
                A_out, nbits, lmax, nblk, P, span, stage, mapp, m_total};
  cudaStream_t st = (cudaStream_t)stream;
  const bool narrow = M < (1LL << 31) && O < (1 << 16);
  cudaError_t err =
      narrow ? candidates_for<false>(ix, s, st, reads, read_len, hits_t,
                                     hits_valid, meta, cnlogp, clip_part,
                                     seed_part)
             : candidates_for<true>(ix, s, st, reads, read_len, hits_t,
                                    hits_valid, meta, cnlogp, clip_part,
                                    seed_part);
  if (err != cudaSuccess) return (int)err;
  anchor_select<<<B, SEL_THREADS, smem, st>>>(
      s, hits_t, meta, cnlogp, clip_part, seed_part, out_q, out_t, out_l,
      out_valid, out_nlogp, n_total, n_clipped, seed_counts);
  return (int)cudaGetLastError();
}

}  // namespace

// The selection kernel's opt-in to the most dynamic shared memory, on the
// current device; called once per device before any launch
// (blasr_setup_kernels), never while a stream is captured.
extern "C" int blasr_anchor_search_setup() {
  return (int)cudaFuncSetAttribute(anchor_select,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SELECT_DYNAMIC_MAX);
}

#define ANCHOR_SEARCH_ARGS                                                    \
  const int8_t *reads, const int32_t *read_len, const int8_t *genome,         \
      const int64_t *keys_sorted, const int64_t *pos_sorted,                  \
      const int32_t *bucket_starts, const int32_t *bucket_pairs,              \
      const int32_t *records, const int64_t *gwords, const int64_t *gnwords,  \
      long long G, long long M, int lookup_mode, int use_rec, int B, int L,   \
      int O, int k, int E, int min_match, long long mapp, int max_lcp,        \
      int advance_exact, int A_out, int nbits, int lmax, float m_total,       \
      int64_t *hits_t, uint8_t *hits_valid, uint32_t *meta, float *cnlogp,    \
      uint32_t *clip_part, unsigned long long *seed_part, int64_t *out_q,     \
      int64_t *out_t, int64_t *out_l, uint8_t *out_valid, float *out_nlogp,   \
      int32_t *n_total, int32_t *n_clipped, int64_t *seed_counts,             \
      void *stream
#define ANCHOR_SEARCH_PASS                                                    \
  reads, read_len, genome, keys_sorted, pos_sorted, bucket_starts,            \
      bucket_pairs, records, gwords, gnwords, G, M, lookup_mode, use_rec, B,  \
      L, O, k, E, min_match, mapp, max_lcp, advance_exact, A_out, nbits,      \
      lmax, m_total, hits_t, hits_valid, meta, cnlogp, clip_part, seed_part,  \
      out_q, out_t, out_l, out_valid, out_nlogp, n_total, n_clipped,          \
      seed_counts, stream

// the default strided occurrence sampling
extern "C" int blasr_anchor_search(ANCHOR_SEARCH_ARGS) {
  return anchor_search(0, M, ANCHOR_SEARCH_PASS);
}

// the block mode (occ_block_sample): the same arguments, then the rows of
// the records table (its slices are clipped to them)
extern "C" int blasr_anchor_search_block(ANCHOR_SEARCH_ARGS,
                                         long long rec_rows) {
  return anchor_search(1, rec_rows, ANCHOR_SEARCH_PASS);
}
