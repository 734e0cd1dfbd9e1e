// K2-W: run-length traceback walk over the banded DP's cell words at any
// band width.
//
// Replaces blasr_tpu/kernels/banded.py::banded_traceback (banded.py:424,
// an XLA while_loop of 64-step chunks) at band widths other than 128, the
// walk over K1-W's cell words (csrc/banded_dp_wide.cu).
//
// Each step follows `rl_step` exactly: one cell word, a whole M run
// consumed per step via the in-cell run counters, single I/D bases,
// leading-deletion boundary runs capped at CNT_CAP (re-looping), and stall
// steps (op 1, count 0) after a saturated band jump, which re-derive the
// band column from the offsets row.  Output layout is the JAX one:
// halfword pairs op | count << 2, packed two per int32 word (low half
// first), zeros after the stop (written by the kernel, so the wrapper
// allocates the pair buffer without a fill); the four counts; overflow =
// the walk did not finish within P steps.  The JAX chunked loop stops only
// once every row is done, which changes no row's output, so one lane
// walking its row to done (or P) reproduces it.
//
// Items: as K2's.  Walk n walks DP row m = rows[n] (m = n where `rows` is
// null), reading its cell words in place at tbbits + m * L * w_b, its
// offsets row and its per-row inputs at m, and writing its outputs at n,
// so no gathered copy of the traced rows precedes the walk.
//
// Layout: K2's (banded_traceback.cu) at any width.  One warp per item
// (one CTA); lane 0 walks from a ring of `slots` tiles of `rows` rows in
// shared memory that it fills itself, one cp.async.bulk copy per tile with
// one mbarrier per slot, in decreasing row order from the tile of qb - 1,
// re-arming the slot of each tile the walk leaves with the tile `slots`
// below; the walk's rows never go up, so the ring runs ahead of it.  The
// other lanes zero the pair words after the stop.  The ring is planned
// from w_b (ring_plan): five 16-row tiles where they fit in K2's ~44 KB
// (five walks share an SM; w_b up to ~140), else 8-row tiles, three to
// five of them in 44 KB, or in 113 KB (two walks an SM; w_b up to ~1,200),
// or two to five in the SM's whole 227 KB (w_b up to 3,615 with
// two 8-row tiles).  Above that width no ring of two tiles fits, and the
// first design (kept unchanged) walks: one thread per item, 64 a CTA,
// each step's cell word read from global memory.
//
// A bulk copy needs 16-byte aligned addresses and a size in 16-byte units,
// which a row of an odd width, or a row start (n * L + r) * w_b * 4, need
// not give.  Each tile's slot is skewed by the tile's address mod 16, and
// its copy is widened to the whole 16-byte units around its rows (at most
// three words more at each end, read from the same allocation: the caching
// allocator hands out whole 512-byte blocks), so every copy lands aligned;
// at a width that is a multiple of 4, on an aligned tensor, nothing is
// widened.
//
// What bounds it on an H100: each step is a dependent chain (the next
// cell's address comes from this cell's word): a shared-memory read and
// the step's integer arithmetic, ~350 cycles a step on K2.  Below that
// sits the copy stream, w_b * 4 bytes a row over the rows [qa, qb) of the
// item, which the ring keeps in flight ahead of the walk.  The kernel
// takes as long as its longest walk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CNT_CAP = 16383;
constexpr int ST_M = 0, ST_I = 1, ST_D = 2, ST_H = 3;
constexpr int THREADS = 64;  // the first design's threads a CTA
constexpr int MAX_SLOTS = 5;
// the ring's shared-memory budgets: five walks an SM, two, one (beside
// the kernel's static shared memory)
constexpr int BUDGET_5 = 45056, BUDGET_2 = 115712;
constexpr int BUDGET_1 = 232448 - 1024;

struct RingPlan {
  int rows, slots;  // 0, 0: no ring fits, the first design walks
};

// a slot's words: one tile of `rows` rows after a skew of up to three
// words and its copy's up to three words past its end, in whole 16-byte
// units
__host__ __device__ __forceinline__ int slot_words(int rows, int w_b) {
  return (rows * w_b + 6 + 3) & ~3;
}

__host__ __device__ __forceinline__ RingPlan ring_plan(int w_b) {
  if (5 * slot_words(16, w_b) * 4 <= BUDGET_5) return RingPlan{16, 5};
  const int tile = slot_words(8, w_b) * 4;
  const int budgets[3] = {BUDGET_5, BUDGET_2, BUDGET_1};
  const int least[3] = {3, 3, 2};
  for (int k = 0; k < 3; ++k) {
    const int slots = min(MAX_SLOTS, budgets[k] / tile);
    if (slots >= least[k]) return RingPlan{8, slots};
  }
  return RingPlan{0, 0};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The ring of one item: tile k (rows rows * k ..) is the (top - k)-th
// tile issued, into slot (top - k) % slots, on that slot's use (top - k) /
// slots.  Tile k sits in its slot after a skew of its address mod 16.
struct Ring {
  const int32_t* src;  // the item's tbbits
  int32_t* words;      // slot 0
  unsigned bars;       // shared address of the slots' mbarriers
  int w_b, rows, slots, stride;
  int top, bot;        // tiles of rows need_hi and need_lo
  int need_lo, need_hi;

  __device__ __forceinline__ int skew(int k) const {
    return (int)((reinterpret_cast<uintptr_t>(src + (size_t)k * rows * w_b) >>
                  2) & 3u);
  }

  // where row rc of tile k starts in shared memory, as an offset from
  // words: words[base(k) + rc * w_b + col] is that row's cell col
  __device__ __forceinline__ int base(int k) const {
    return ((top - k) % slots) * stride + skew(k) - k * rows * w_b;
  }

  // The copy of tile k's rows [lo, hi]: their span widened to whole 16-byte
  // units (at most three words before and three after, inside the
  // allocation, whose start and size the allocator keeps in such units),
  // landing where words[base(k) + ...] expects it.
  __device__ __forceinline__ void issue(int k) const {
    const int ord = top - k;
    const int slot = ord % slots;
    const int lo = max(k * rows, need_lo);
    const int hi = min(k * rows + rows - 1, need_hi);
    const int32_t* g = src + (size_t)lo * w_b;
    const int ga = (int)((reinterpret_cast<uintptr_t>(g) >> 2) & 3u);
    const int nw = ((ga + (hi - lo + 1) * w_b + 3) & ~3);
    const int at = base(k) + lo * w_b - ga;
    const unsigned bar = bars + 8 * slot;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"((unsigned)nw * 4)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(words) + 4u * (unsigned)at),
        "l"(g - ga), "r"((unsigned)nw * 4), "r"(bar)
        : "memory");
  }

  __device__ __forceinline__ void wait(int k) const {
    const int ord = top - k;
    mbar_wait(bars + 8 * (ord % slots), (unsigned)(ord / slots) & 1u);
  }
};

__global__ void __launch_bounds__(32) banded_traceback_wide_ring_kernel(
    const int32_t* __restrict__ tbbits, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ qa_a, const int32_t* __restrict__ qb_a,
    const int32_t* __restrict__ ta_a, const int32_t* __restrict__ tb_a,
    const int32_t* __restrict__ fstate, const uint8_t* __restrict__ fvalid,
    const int64_t* __restrict__ rows, int L, int w_b, int P, RingPlan plan,
    int32_t* __restrict__ pairs,
    int32_t* __restrict__ n_pairs, int32_t* __restrict__ n_match,
    int32_t* __restrict__ n_mismatch, int32_t* __restrict__ n_ins,
    int32_t* __restrict__ n_del, uint8_t* __restrict__ overflow) {
  extern __shared__ __align__(128) int32_t ring_words[];
  __shared__ __align__(8) unsigned long long bar[MAX_SLOTS];
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  int32_t* out = pairs + (size_t)n * (P / 2);
  int written = 0;  // pair words the walk stored

  if (lane == 0) {
    const size_t m = rows ? (size_t)rows[n] : (size_t)n;  // the DP row
    const int qa = qa_a[m], qb = qb_a[m], ta = ta_a[m], tb = tb_a[m];
    const int32_t* off = offsets + m * L;
    int r = qb - 1, t = tb - 1;
    int w = tb - 1 - off[min(max(qb - 1, 0), L - 1)];
    bool wbad = false;
    int st = fstate[m];
    bool done = fvalid[m] == 0;

    // the rows whose cells the walk may read: rc = clamp(r, 0, L - 1) for
    // r in [qa, qb - 1]
    Ring ring;
    ring.src = tbbits + m * L * (size_t)w_b;
    ring.words = ring_words;
    ring.bars = smem_addr(bar);
    ring.w_b = w_b;
    ring.rows = plan.rows;
    ring.slots = plan.slots;
    ring.stride = slot_words(plan.rows, w_b);
    ring.need_lo = min(max(qa, 0), L - 1);
    ring.need_hi = min(max(qb - 1, 0), L - 1);
    ring.top = ring.need_hi / plan.rows;
    ring.bot = ring.need_lo / plan.rows;
    const bool reads = !done && qb - 1 >= qa;
    int cur = ring.top;  // the tile whose rows are ready (if reads)
    int row_off = ring.base(cur);
    if (reads) {
      for (int s = 0; s < plan.slots; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         ring.bars + 8 * s)
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int k = ring.top; k >= max(ring.bot, ring.top - plan.slots + 1);
           --k)
        ring.issue(k);
      ring.wait(cur);
    }

    int nm = 0, nmm = 0, nins = 0, ndel = 0, npairs = 0;
    uint32_t lo = 0;  // the pair of the last even step
    int step = 0;
    // cell steps, while r >= qa (rows only go down, so the boundary
    // steps all come after them)
    for (; step < P && !done && r >= qa; ++step) {
      const int rc = min(max(r, 0), L - 1);
      // enter rc's tile: each tile left re-arms its slot `slots` tiles down
      if (rc < cur * plan.rows) {
        const int tile = rc / plan.rows;
        do {
          if (cur - plan.slots >= ring.bot) ring.issue(cur - plan.slots);
          --cur;
          ring.wait(cur);
        } while (cur > tile);
        row_off = ring.base(cur);
      }
      uint32_t pair;
      if (wbad) {  // stall: op 1, count 0, the band column re-derived
        pair = 1u;
        w = t - off[rc];
        wbad = false;
      } else {
        const bool w_ok = (w >= 0) && (w < w_b);
        const int cell =
            ring_words[row_off + rc * w_b + min(max(w, 0), w_b - 1)];
        const int mrun = max((cell >> 9) & 63, 1);
        const int meq = (cell >> 15) & 63;
        const int s_r = (cell >> 21) & 3;
        const int ssum = (cell >> 23) & 127;
        const bool is_m = st == ST_M;
        const bool is_d = st == ST_D;
        const bool is_i = !is_m && !is_d;  // ST_I or ST_H
        const int cnt = is_m ? mrun : 1;
        pair = (uint32_t)((is_m ? 1 : (is_i ? 2 : 3)) | (cnt << 2));
        const int nr = r - (is_m ? mrun : (is_i ? 1 : 0));
        t -= is_m ? mrun : (is_d ? 1 : 0);
        w = is_m ? w - mrun + ssum : (is_i ? w + s_r : w - 1);
        const bool sat = is_m ? ssum == 127 : (is_i && s_r == 3);
        wbad = sat && nr >= qa;
        // next state: M exits by the cell's rexit; I / H close on
        // i_open / h_open; D on d_open, to M or I by d_from_m
        const int opened = (cell >> (is_d ? 3 : (st == ST_H ? 6 : 2))) & 1;
        const int nst_idh =
            opened ? (is_d && !((cell >> 4) & 1) ? ST_I : ST_M) : st;
        st = is_m ? (cell >> 7) & 3 : nst_idh;
        nm += is_m ? meq : 0;
        nmm += is_m ? mrun - meq : 0;
        nins += is_i ? 1 : 0;
        ndel += is_d ? 1 : 0;
        npairs += 1;
        done = !w_ok;
        r = nr;
      }
      if (step & 1) out[step >> 1] = (int32_t)(lo | (pair << 16));
      lo = pair;
    }
    // the leading-deletion boundary: runs of up to CNT_CAP columns
    for (; step < P && !done; ++step) {
      uint32_t pair = 0;
      if (t < ta) {
        done = true;
      } else {
        const int b_cnt = min(t - ta + 1, CNT_CAP);
        pair = 3u | ((uint32_t)b_cnt << 2);
        t -= b_cnt;
        ndel += b_cnt;
        npairs += 1;
      }
      if (step & 1) out[step >> 1] = (int32_t)(lo | (pair << 16));
      lo = pair;
    }
    if (step & 1) out[step >> 1] = (int32_t)lo;  // half-filled last word
    written = (step + 1) >> 1;
    if (reads) {  // every issued copy lands before the CTA exits
      for (int k = cur - 1; k >= max(ring.bot, cur - plan.slots + 1); --k)
        ring.wait(k);
    }
    n_pairs[n] = npairs;
    n_match[n] = nm;
    n_mismatch[n] = nmm;
    n_ins[n] = nins;
    n_del[n] = ndel;
    overflow[n] = done ? 0 : 1;
  }
  written = __shfl_sync(0xffffffffu, written, 0);
  for (int k = written + lane; k < P / 2; k += 32) out[k] = 0;
}

// ------------------------------------------------------------------------
// The first design, where no ring of two 8-row tiles fits.

__global__ void __launch_bounds__(THREADS) banded_traceback_wide_global_kernel(
    const int32_t* __restrict__ tbbits, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ qa_a, const int32_t* __restrict__ qb_a,
    const int32_t* __restrict__ ta_a, const int32_t* __restrict__ tb_a,
    const int32_t* __restrict__ fstate, const uint8_t* __restrict__ fvalid,
    const int64_t* __restrict__ rows, int N, int L, int w_b, int P,
    int32_t* __restrict__ pairs,
    int32_t* __restrict__ n_pairs, int32_t* __restrict__ n_match,
    int32_t* __restrict__ n_mismatch, int32_t* __restrict__ n_ins,
    int32_t* __restrict__ n_del, uint8_t* __restrict__ overflow) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t m = rows ? (size_t)rows[n] : (size_t)n;  // the DP row
  const int qa = qa_a[m], qb = qb_a[m], ta = ta_a[m], tb = tb_a[m];
  const int32_t* cells = tbbits + m * L * (size_t)w_b;
  const int32_t* off = offsets + m * L;
  int32_t* out = pairs + (size_t)n * (P / 2);

  int r = qb - 1, t = tb - 1;
  int w = tb - 1 - off[min(max(qb - 1, 0), L - 1)];
  bool wbad = false;
  int st = fstate[m];
  bool done = fvalid[m] == 0;
  int nm = 0, nmm = 0, nins = 0, ndel = 0, npairs = 0;
  uint32_t lo = 0;  // the pair of the last even step
  int step = 0;
  for (; step < P && !done; ++step) {
    const bool at_b = r < qa;
    const int rc = min(max(r, 0), L - 1);
    const bool w_ok = (w >= 0) && (w < w_b);
    const int cell = cells[(size_t)rc * w_b + min(max(w, 0), w_b - 1)];
    const int i_open = (cell >> 2) & 1;
    const int d_open = (cell >> 3) & 1;
    const int d_from_m = (cell >> 4) & 1;
    const int h_open = (cell >> 6) & 1;
    const int rexit = (cell >> 7) & 3;
    const int mrun = max((cell >> 9) & 63, 1);
    const int meq = (cell >> 15) & 63;
    const int s_r = (cell >> 21) & 3;
    const int ssum = (cell >> 23) & 127;

    const bool b_more = at_b && (t >= ta);
    const bool b_done = at_b && (t < ta);
    const bool stall = wbad && !at_b;  // done is false inside the loop
    const bool is_m = !at_b && st == ST_M && !stall;
    const bool is_i = !at_b && (st == ST_I || st == ST_H) && !stall;
    const bool is_d = !at_b && st == ST_D && !stall;
    const bool is_h = !at_b && st == ST_H && !stall;
    const bool emit = !(b_done || stall);

    const int b_cnt = min(t - ta + 1, CNT_CAP);
    uint32_t pair = 0;
    if (stall) {
      pair = 1u;  // op 1, count 0: a no-op every decoder skips
    } else if (emit) {
      const int op = b_more ? 3 : (is_m ? 1 : (is_i ? 2 : 3));
      const int cnt = b_more ? b_cnt : (is_m ? mrun : 1);
      pair = (uint32_t)(op | (cnt << 2));
    }
    if (step & 1) {
      out[step >> 1] = (int32_t)(lo | (pair << 16));
    } else {
      lo = pair;
    }

    int nr = r, nt = t, nw = w;
    if (emit && (is_m || is_i)) nr = r - (is_m ? mrun : 1);
    if (emit) nt = t - (b_more ? b_cnt : (is_m ? mrun : (is_d ? 1 : 0)));
    if (stall) {
      nw = t - off[rc];
    } else if (emit) {
      nw = is_m ? w - mrun + ssum : (is_i ? w + s_r : (is_d ? w - 1 : w));
    }
    const bool sat = (is_i && s_r == 3) || (is_m && ssum == 127);
    const bool nwbad = stall ? false : (wbad || (emit && sat && nr >= qa));
    int nst = st;
    if (is_m) {
      nst = rexit;
    } else if (is_h) {
      nst = h_open == 1 ? ST_M : ST_H;
    } else if (is_i) {
      nst = i_open == 1 ? ST_M : ST_I;
    } else if (is_d) {
      nst = d_open == 1 ? (d_from_m == 1 ? ST_M : ST_I) : ST_D;
    }
    if (emit && is_m) {
      nm += meq;
      nmm += mrun - meq;
    }
    if (emit && is_i) nins += 1;
    if (emit && is_d) ndel += 1;
    if (emit && b_more) ndel += b_cnt;
    if (emit) npairs += 1;
    done = b_done || (!at_b && !w_ok && emit);
    r = nr;
    t = nt;
    w = nw;
    wbad = nwbad;
    st = nst;
  }
  if (step & 1) out[step >> 1] = (int32_t)lo;  // half-filled last word
  for (int k = (step + 1) >> 1; k < P / 2; ++k) out[k] = 0;
  n_pairs[n] = npairs;
  n_match[n] = nm;
  n_mismatch[n] = nmm;
  n_ins[n] = nins;
  n_del[n] = ndel;
  overflow[n] = done ? 0 : 1;
}

}  // namespace

// The ring a width takes, as rows << 8 | slots; 0 where none fits and the
// first design walks.
extern "C" int blasr_banded_traceback_wide_plan(int w_b) {
  const RingPlan p = ring_plan(w_b);
  return p.rows << 8 | p.slots;
}

// The ring kernel's opt-in to the SM's whole shared memory and its
// carveout, on the current device; called once per device before any
// launch (blasr_setup_kernels), never while a stream is captured.
extern "C" int blasr_banded_traceback_wide_setup() {
  cudaError_t e = cudaFuncSetAttribute(
      banded_traceback_wide_ring_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, BUDGET_1);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(
      banded_traceback_wide_ring_kernel,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

// N walks, of the DP rows `rows` (int64, N of them) or, where it is null,
// of rows 0..N-1; the outputs have N rows.
extern "C" int blasr_banded_traceback_wide(
    const int32_t* tbbits, const int32_t* offsets, const int32_t* qa,
    const int32_t* qb, const int32_t* ta, const int32_t* tb,
    const int32_t* final_state, const uint8_t* valid, const int64_t* rows,
    int N, int L, int w_b, int P, int32_t* pairs, int32_t* n_pairs,
    int32_t* n_match, int32_t* n_mismatch, int32_t* n_ins, int32_t* n_del,
    uint8_t* overflow, void* stream) {
  if (w_b < 1) return (int)cudaErrorInvalidValue;
  const RingPlan plan = ring_plan(w_b);
  if (plan.slots > 0) {
    const size_t smem = (size_t)plan.slots * slot_words(plan.rows, w_b) * 4;
    banded_traceback_wide_ring_kernel<<<N, 32, smem, (cudaStream_t)stream>>>(
        tbbits, offsets, qa, qb, ta, tb, final_state, valid, rows, L, w_b, P,
        plan, pairs, n_pairs, n_match, n_mismatch, n_ins, n_del, overflow);
  } else {
    const int blocks = (N + THREADS - 1) / THREADS;
    banded_traceback_wide_global_kernel<<<blocks, THREADS, 0,
                                          (cudaStream_t)stream>>>(
        tbbits, offsets, qa, qb, ta, tb, final_state, valid, rows, N, L, w_b,
        P, pairs, n_pairs, n_match, n_mismatch, n_ins, n_del, overflow);
  }
  return (int)cudaGetLastError();
}
