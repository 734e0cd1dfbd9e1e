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
//     the 24-byte record (or the separate gathers), the containment prune
//     (periodic representatives every E/2), the 16-base XOR/ctz extension,
//     the length (clamped to max_lcp), hits_t / hits_valid, and
//     nlogp = fma(len - k, LOG4, log(M / max(nocc, 1)));
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
// selected are then sorted in shared memory (bitonic) by one 64-bit key:
// (valid ? t : BIG) in the top 31 bits, then the candidate's position in
// the first order: ((lmax - len) << nbits | bitrev) for a valid one, 2^32 +
// its rank in flat order for an invalid one.  That is the stable two-sort
// order of the plain version, a valid anchor at t >= BIG included.
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
// slot; the reads, anchors and raw hits are a few MB.  At the bench shapes
// (2B = 64 rows, L = 2048, O = 3) that is ~10 MB, ~3 us of HBM time; the
// candidate kernel puts 131,072 threads in flight to hide the gather
// latency, and the selection reads the row's 6,144 candidates from L2 a
// few times (histogram, radix passes, collection) inside one CTA.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

using blasr::block_scan;
using blasr::floordiv;

constexpr int CAND_THREADS = 256;
constexpr int SEL_THREADS = 1024;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr uint32_t ALL_N = 0xFFFFFFFFu;
constexpr uint32_t VALID_BIT = 0x10000u;   // meta word: length | valid << 16
constexpr long long BIG = 0x3FFFFFFF;
constexpr int CACHED_WORDS = 4;            // read words kept per thread

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
};

struct Shape {
  int B, L, O, k, E, min_match, max_lcp, advance_exact;
  int A_out, nbits, lmax, nblk, P;
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

__device__ __forceinline__ int base_at(const int8_t* row, int L, long long p) {
  return p < L ? (int)row[p] : 4;
}

// the read's 16-base word at p (2 bits a base, LSB first) and its N mask;
// past the read's end the word is 0 and the mask all N
__device__ __forceinline__ void read_word(const int8_t* row, int L,
                                          long long p, uint32_t& rw,
                                          uint32_t& rn) {
  if (p >= L) {
    rw = 0u;
    rn = ALL_N;
    return;
  }
  rw = 0u;
  rn = 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = base_at(row, L, p + j);
    rw |= (uint32_t)(r & 3) << (2 * j);
    rn |= (r >= 4 ? 3u : 0u) << (2 * j);
  }
}

__device__ __forceinline__ void lookup(const Index& ix, uint32_t key,
                                       long long& lo, long long& hi) {
  if (ix.lookup == 0) {
    lo = ix.bucket_pairs[2 * (size_t)key];
    hi = ix.bucket_pairs[2 * (size_t)key + 1];
  } else if (ix.lookup == 1) {
    lo = ix.bucket_starts[key];
    hi = ix.bucket_starts[(size_t)key + 1];
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

__global__ void __launch_bounds__(CAND_THREADS) anchor_candidates(
    Index ix, Shape s, const int8_t* __restrict__ reads,
    const int32_t* __restrict__ read_len, int64_t* __restrict__ hits_t,
    uint8_t* __restrict__ hits_valid, uint32_t* __restrict__ meta,
    float* __restrict__ cnlogp, uint32_t* __restrict__ clip_part) {
  __shared__ uint32_t s_clip[CAND_THREADS / 32];
  const int b = blockIdx.y;
  const int q = blockIdx.x * CAND_THREADS + threadIdx.x;
  const int L = s.L, O = s.O, k = s.k;
  uint32_t clip = 0;
  if (q < L) {
    const int8_t* row = reads + (size_t)b * L;
    uint32_t key = 0;
    bool kok = true;
    for (int j = 0; j < k; ++j) {
      const int r = base_at(row, L, (long long)q + j);
      key = (key << 2) | (uint32_t)(r & 3);
      kok = kok && r < 4;
    }
    kok = kok && (long long)q + k <= (long long)read_len[b];
    long long lo, hi;
    lookup(ix, key, lo, hi);
    const long long nocc = hi - lo;
    const bool pos_ok = kok && nocc > 0 && nocc <= s.mapp;
    if (pos_ok && nocc > O) clip = (uint32_t)(nocc - O);
    const float seed = log_f32(
        __fdiv_rn(s.m_total, __ll2float_rn(nocc > 1 ? nocc : 1)));
    const long long rprev = q > 0 ? (long long)row[q - 1] : 4;
    const int keep_stride = s.E / 2 > 1 ? s.E / 2 : 1;
    const bool periodic = q % keep_stride == 0;
    const int n_words = (s.E + 15) / 16;
    uint32_t c_rw[CACHED_WORDS], c_rn[CACHED_WORDS];
#pragma unroll
    for (int j = 0; j < CACHED_WORDS; ++j) {
      if (j < n_words) read_word(row, L, (long long)q + k + 16 * j, c_rw[j],
                                 c_rn[j]);
    }
    const long long nmod = nocc > 1 ? nocc : 1;
    const size_t gbase = ((size_t)b * L + q) * O;
    for (int o = 0; o < O; ++o) {
      long long occ_off = o;
      if (nocc > O) {
        const long long st0 = (long long)o * floordiv(nocc, O) +
                              floordiv((long long)o * floormod(nocc, O), O);
        occ_off = floormod(st0 + q, nmod);
      }
      const long long idx = clampll(lo + occ_off, 0, ix.M - 1);
      bool cv = pos_ok && o < nocc;
      long long t, gprev;
      const int32_t* rec = nullptr;
      if (ix.use_rec) {
        rec = ix.records + 6 * (size_t)idx;
        t = (long long)(uint32_t)rec[0];
        gprev = (long long)(uint32_t)rec[1];
      } else {
        t = ix.pos_sorted[idx];
        gprev = ix.genome[clampll(t - 1, 0, ix.G - 1)];
      }
      const bool contained =
          q > 0 && t > 0 && gprev == rprev && rprev < 4 && !periodic;
      cv = cv && !contained;
      int ext = 0, full = 1;
      for (int j = 0; j < n_words; ++j) {
        const long long off = k + 16 * j;
        uint32_t gw, gn, rw, rn;
        if (ix.use_rec) {
          gw = (uint32_t)rec[2 + 2 * j];
          gn = (uint32_t)rec[3 + 2 * j];
        } else {
          const long long gi = clampll(t + off, 0, ix.G - 1);
          gw = (uint32_t)ix.gwords[gi];
          gn = t + off < ix.G ? (uint32_t)ix.gnwords[gi] : ALL_N;
        }
        if (j < CACHED_WORDS) {
          rw = c_rw[j];
          rn = c_rn[j];
        } else {
          read_word(row, L, (long long)q + off, rw, rn);
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
      hits_t[gbase + o] = t;
      hits_valid[gbase + o] = (pos_ok && o < nocc && long_enough) ? 1 : 0;
      cv = cv && long_enough;
      meta[gbase + o] = ((uint32_t)length & 0xFFFFu) | (cv ? VALID_BIT : 0u);
      cnlogp[gbase + o] = fma_f32(__int2float_rn(length - k), LOG4, seed);
    }
  }
  // the block's share of n_clipped (unsigned: wraps as the int32 sum does)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) clip += __shfl_down_sync(0xffffffffu, clip, o);
  if ((threadIdx.x & 31) == 0) s_clip[threadIdx.x >> 5] = clip;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t sum = 0;
    for (int w = 0; w < CAND_THREADS / 32; ++w) sum += s_clip[w];
    clip_part[(size_t)b * s.nblk + blockIdx.x] = sum;
  }
}

__device__ __forceinline__ uint32_t bitrev(uint32_t flat, int nbits) {
  return __brev(flat) >> (32 - nbits);
}

__global__ void __launch_bounds__(SEL_THREADS) anchor_select(
    Shape s, const int64_t* __restrict__ hits_t, uint32_t* __restrict__ meta,
    const float* __restrict__ cnlogp, const uint32_t* __restrict__ clip_part,
    int64_t* __restrict__ out_q, int64_t* __restrict__ out_t,
    int64_t* __restrict__ out_l, uint8_t* __restrict__ out_valid,
    float* __restrict__ out_nlogp, int32_t* __restrict__ n_total_out,
    int32_t* __restrict__ n_clipped_out) {
  extern __shared__ unsigned long long s_keys[];     // [P]
  int32_t* s_inv = reinterpret_cast<int32_t*>(s_keys + s.P);   // [A_out]
  int32_t* s_hist = s_inv + s.A_out;                            // [lmax + 1]
  __shared__ long long s_warp[SEL_WARPS];
  __shared__ long long s_scan[SEL_THREADS];
  __shared__ int s_dig[256];
  __shared__ int s_total, s_lt, s_need, s_cnt;
  __shared__ uint32_t s_prefix;

  const int tid = threadIdx.x;
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

  // histogram of the valid lengths
  for (int i = tid; i <= s.lmax; i += SEL_THREADS) s_hist[i] = 0;
  __syncthreads();
  for (long long f = tid; f < n; f += SEL_THREADS) {
    const uint32_t u = m[f];
    if (u & VALID_BIT) atomicAdd(&s_hist[u & 0xFFFFu], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int i = 0; i <= s.lmax; ++i) total += s_hist[i];
    s_total = total;
    int lt = -1, need = 0;
    if (total > A_out) {
      int cum = 0;
      for (int len = s.lmax; len >= 0; --len) {
        if (cum + s_hist[len] >= A_out) {
          lt = len;
          need = A_out - cum;
          break;
        }
        cum += s_hist[len];
      }
    }
    s_lt = lt;
    s_need = need;
    s_prefix = 0u;
    s_cnt = 0;
    uint32_t clip = 0;
    for (int i = 0; i < s.nblk; ++i) clip += clip_part[(size_t)b * s.nblk + i];
    n_clipped_out[b] = (int32_t)clip;
    n_total_out[b] = total;
  }
  __syncthreads();
  const int total = s_total;
  const int lt = s_lt;   // -1: every valid candidate is selected

  // radix select of the `need` smallest bit-reversed indices at length lt
  if (lt >= 0) {
    for (int shift = ((nbits - 1) / 8) * 8; shift >= 0; shift -= 8) {
      if (tid < 256) s_dig[tid] = 0;
      __syncthreads();
      const uint32_t prefix = s_prefix;
      for (long long f = tid; f < n; f += SEL_THREADS) {
        const uint32_t u = m[f];
        if ((u & VALID_BIT) && (int)(u & 0xFFFFu) == lt) {
          const uint32_t rev = bitrev((uint32_t)f, nbits);
          if ((uint32_t)((unsigned long long)rev >> (shift + 8)) == prefix)
            atomicAdd(&s_dig[(rev >> shift) & 255u], 1);
        }
      }
      __syncthreads();
      if (tid == 0) {
        int need = s_need, cum = 0, d = 0;
        for (; d < 255; ++d) {
          if (cum + s_dig[d] >= need) break;
          cum += s_dig[d];
        }
        s_need = need - cum;
        s_prefix = (prefix << 8) | (uint32_t)d;
      }
      __syncthreads();
    }
  }
  const uint32_t rthr = s_prefix;

  // collect the selected valid candidates as sort keys
  const int nsel = total < A_out ? total : A_out;
  for (long long f = tid; f < n; f += SEL_THREADS) {
    const uint32_t u = m[f];
    if (!(u & VALID_BIT)) continue;
    const int len = (int)(u & 0xFFFFu);
    const uint32_t rev = bitrev((uint32_t)f, nbits);
    if (lt >= 0 && (len < lt || (len == lt && rev > rthr))) continue;
    const int slot = atomicAdd(&s_cnt, 1);
    const unsigned long long low =
        ((unsigned long long)(s.lmax - len) << nbits) | rev;
    s_keys[slot] = ((unsigned long long)ht[f] << 33) | low;
  }
  // the first A_out - total invalid candidates in flat order
  if (nsel < A_out) {
    const long long m_inv = A_out - nsel;
    long long carry = 0;
    for (long long f0 = 0; f0 < n && carry < m_inv; f0 += SEL_THREADS) {
      const long long f = f0 + tid;
      const long long flag = (f < n && !(m[f] & VALID_BIT)) ? 1 : 0;
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

  // bitonic sort of the P keys, ascending
  for (int kk = 2; kk <= s.P; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < s.P; i += SEL_THREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = s_keys[i], c = s_keys[ixj];
          const bool up = (i & kk) == 0;
          if ((a > c) == up) {
            s_keys[i] = c;
            s_keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // write the A_out slots
  const size_t orow = (size_t)b * A_out;
  for (int i = tid; i < A_out; i += SEL_THREADS) {
    const unsigned long long key = s_keys[i];
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
    const uint32_t u = m[f];
    out_q[orow + i] = f / O;
    out_t[orow + i] = ht[f];
    out_l[orow + i] = (int64_t)(u & 0xFFFFu);
    out_valid[orow + i] = v ? 1 : 0;
    out_nlogp[orow + i] = np_[f];
  }
}

}  // namespace

extern "C" int blasr_anchor_search(
    const int8_t* reads, const int32_t* read_len, const int8_t* genome,
    const int64_t* keys_sorted, const int64_t* pos_sorted,
    const int32_t* bucket_starts, const int32_t* bucket_pairs,
    const int32_t* records, const int64_t* gwords, const int64_t* gnwords,
    long long G, long long M, int lookup_mode, int use_rec, int B, int L,
    int O, int k, int E, int min_match, long long mapp, int max_lcp,
    int advance_exact, int A_out, int nbits, int lmax, float m_total,
    int64_t* hits_t, uint8_t* hits_valid, uint32_t* meta, float* cnlogp,
    uint32_t* clip_part, int64_t* out_q, int64_t* out_t, int64_t* out_l,
    uint8_t* out_valid, float* out_nlogp, int32_t* n_total,
    int32_t* n_clipped, void* stream) {
  const Index ix{genome, keys_sorted, pos_sorted, bucket_starts, bucket_pairs,
                 records, gwords, gnwords, G, M, lookup_mode, use_rec};
  int P = 1;
  while (P < A_out) P <<= 1;
  const int nblk = (L + CAND_THREADS - 1) / CAND_THREADS;
  const Shape s{B, L, O, k, E, min_match, max_lcp, advance_exact,
                A_out, nbits, lmax, nblk, P, mapp, m_total};
  cudaStream_t st = (cudaStream_t)stream;
  anchor_candidates<<<dim3(nblk, B), CAND_THREADS, 0, st>>>(
      ix, s, reads, read_len, hits_t, hits_valid, meta, cnlogp, clip_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)P * 8 + (size_t)A_out * 4 + (size_t)(lmax + 1) * 4;
  err = cudaFuncSetAttribute(anchor_select,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  anchor_select<<<B, SEL_THREADS, smem, st>>>(
      s, hits_t, meta, cnlogp, clip_part, out_q, out_t, out_l, out_valid,
      out_nlogp, n_total, n_clipped);
  return (int)cudaGetLastError();
}
