// K2: run-length traceback walk over the banded DP's cell words.
//
// Replaces blasr_tpu/kernels/banded.py::banded_traceback, an XLA
// while_loop of 64-step lax.scan chunks (no Pallas kernel on the TPU; on
// the GPU eager torch would pay ~60 launches per step and a host sync per
// chunk).  Each step follows `rl_step` exactly: one cell word, a whole M
// run consumed per step via the in-cell run counters, single I/D bases,
// leading-deletion boundary runs capped at _CNT_CAP (re-looping), and
// stall steps (op 1, count 0) after a saturated band jump, which re-derive
// the band column from the offsets row.
//
// Output layout is the JAX one: halfword pairs op | count << 2, packed
// two per int32 word (low half first), zeros after the stop; the four
// counts; overflow = the walk did not finish within P steps.  The JAX
// chunked loop stops only once every row is done, which changes no row's
// output, so one thread walking its row to done (or P) reproduces it.
//
// Items: walk n (CTA n) walks DP row m = rows[n], or m = n where `rows`
// is null.  It reads row m's cell words in place, at tbbits + m * L * 128
// (the bulk copies' source; every block starts a multiple of 512 B past
// the tensor's 16-byte aligned base), its offsets row and qa, qb, ta, tb,
// final_state and valid at m, and writes its outputs (pairs, the five
// counts, overflow) at n.  So the traced rows of a batch need no gathered
// copy of K1's result before the walk: the index is all the walk takes.
//
// Layout: one warp per item (one CTA), lane 0 walks.  The walk's rows
// never go up (an M step climbs mrun <= 63 rows, an I step one, D and
// boundary steps none), so the rows it reads are a non-increasing
// sequence from qb - 1 down to qa, and rows R..R+15 of an item are one
// contiguous 8 KB span of tbbits.  The item's rows [qa, qb) arrive in
// TILE = 16-row tiles through a ring of NSLOT = 5 slots in shared memory:
// the walking lane itself issues one cp.async.bulk copy per tile (1-D bulk
// copy, completion on the slot's mbarrier), in decreasing row order,
// starting at the tile of qb - 1, and when the walk enters a lower tile it
// re-arms the slot of the tile it left with the tile NSLOT below.  The
// ring so holds at least 64 rows at and below the current row, the most
// one M step can climb.  A tile the walk skips is still fetched (and
// waited for before its slot is re-armed), which keeps the ring in order.
// Only the item's rows [qa, qb) of a tile are copied.  Before the warp
// exits, every copy it issued has landed.  Stall steps read offsets[rc]
// from global memory (they are rare).
//
// What bounds it on an H100: each step is a dependent chain (the next
// cell's address comes from this cell's word).  The chain's load is now a
// shared-memory read (~30 cycles) instead of an L2 / HBM round trip
// (~300-700 cycles); the rest is the step's own integer arithmetic,
// written as selects on fields decoded once, in a loop of cell steps with
// no boundary test (the boundary steps follow in a loop of their own, as
// rows only go down).  Below that sits the copy
// stream: ~512 B x (qb - qa) per item, which the ring keeps in flight
// ahead of the walk.  The kernel takes as long as its longest walk.  The
// warp's other lanes zero the pair words after the stop, so the wrapper
// allocates the pair buffer without a fill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WB = 128;
constexpr int CNT_CAP = 16383;
constexpr int ST_M = 0, ST_I = 1, ST_D = 2, ST_H = 3;
constexpr int TILE = 16;                 // rows per tile
constexpr int NSLOT = 5;                 // tiles in flight per item
constexpr int TILE_WORDS = TILE * WB;    // 8 KB
constexpr int SMEM_BYTES = NSLOT * TILE_WORDS * 4;

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

// The ring of one item: tile k (row 16k..16k+15) is the (top - k)-th tile
// issued, into slot (top - k) % NSLOT, on that slot's use (top - k) / NSLOT.
struct Ring {
  const int32_t* src;   // the item's tbbits
  unsigned smem;        // shared address of slot 0
  unsigned bars;        // shared address of the slots' mbarriers
  int top, bot;         // tiles of rows need_hi and need_lo
  int need_lo, need_hi;

  __device__ __forceinline__ void issue(int k) const {
    const int ord = top - k;
    const int slot = ord % NSLOT;
    const int lo = max(k * TILE, need_lo);
    const int hi = min(k * TILE + TILE - 1, need_hi);
    const unsigned bytes = (unsigned)(hi - lo + 1) * WB * 4;
    const unsigned bar = bars + 8 * slot;
    const unsigned dst =
        smem + (unsigned)(slot * TILE_WORDS + (lo - k * TILE) * WB) * 4;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst),
        "l"(src + (size_t)lo * WB), "r"(bytes), "r"(bar)
        : "memory");
  }

  __device__ __forceinline__ void wait(int k) const {
    const int ord = top - k;
    mbar_wait(bars + 8 * (ord % NSLOT), (unsigned)(ord / NSLOT) & 1u);
  }
};

__global__ void __launch_bounds__(32) banded_traceback_kernel(
    const int32_t* __restrict__ tbbits, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ qa_a, const int32_t* __restrict__ qb_a,
    const int32_t* __restrict__ ta_a, const int32_t* __restrict__ tb_a,
    const int32_t* __restrict__ fstate, const uint8_t* __restrict__ fvalid,
    const int64_t* __restrict__ rows, int L, int P,
    int32_t* __restrict__ pairs,
    int32_t* __restrict__ n_pairs, int32_t* __restrict__ n_match,
    int32_t* __restrict__ n_mismatch, int32_t* __restrict__ n_ins,
    int32_t* __restrict__ n_del, uint8_t* __restrict__ overflow) {
  extern __shared__ __align__(128) int32_t ring_words[];
  __shared__ __align__(8) unsigned long long bar[NSLOT];
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
    ring.src = tbbits + m * L * WB;
    ring.smem = smem_addr(ring_words);
    ring.bars = smem_addr(bar);
    ring.need_lo = min(max(qa, 0), L - 1);
    ring.need_hi = min(max(qb - 1, 0), L - 1);
    ring.top = ring.need_hi / TILE;
    ring.bot = ring.need_lo / TILE;
    const bool reads = !done && qb - 1 >= qa;
    int cur = ring.top;  // the tile whose rows are ready (if reads)
    // ring_words[row_off + rc * WB + col] is the cell of row rc of tile cur
    int row_off = -cur * TILE_WORDS;
    if (reads) {
#pragma unroll
      for (int s = 0; s < NSLOT; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         ring.bars + 8 * s)
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int k = ring.top; k >= max(ring.bot, ring.top - NSLOT + 1); --k)
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
      // enter rc's tile: each tile left re-arms its slot NSLOT tiles down
      if (rc < cur * TILE) {
        const int tile = rc / TILE;
        do {
          if (cur - NSLOT >= ring.bot) ring.issue(cur - NSLOT);
          --cur;
          ring.wait(cur);
        } while (cur > tile);
        row_off = ((ring.top - cur) % NSLOT - cur) * TILE_WORDS;
      }
      uint32_t pair;
      if (wbad) {  // stall: op 1, count 0, the band column re-derived
        pair = 1u;
        w = t - off[rc];
        wbad = false;
      } else {
        const bool w_ok = (w >= 0) && (w < WB);
        const int cell =
            ring_words[row_off + rc * WB + min(max(w, 0), WB - 1)];
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
      for (int k = cur - 1; k >= max(ring.bot, cur - NSLOT + 1); --k)
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

}  // namespace

// The carveout that holds five 40 KB rings per SM, on the current device;
// called once per device before any launch (blasr_setup_kernels), never
// while a stream is captured.
extern "C" int blasr_banded_traceback_setup() {
  return (int)cudaFuncSetAttribute(
      banded_traceback_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

// N walks, of the DP rows `rows` (int64, N of them) or, where it is null,
// of rows 0..N-1; the outputs have N rows.
extern "C" int blasr_banded_traceback(
    const int32_t* tbbits, const int32_t* offsets, const int32_t* qa,
    const int32_t* qb, const int32_t* ta, const int32_t* tb,
    const int32_t* final_state, const uint8_t* valid, const int64_t* rows,
    int N, int L, int P, int32_t* pairs, int32_t* n_pairs, int32_t* n_match,
    int32_t* n_mismatch, int32_t* n_ins, int32_t* n_del, uint8_t* overflow,
    void* stream) {
  banded_traceback_kernel<<<N, 32, SMEM_BYTES, (cudaStream_t)stream>>>(
      tbbits, offsets, qa, qb, ta, tb, final_state, valid, rows, L, P, pairs,
      n_pairs, n_match, n_mismatch, n_ins, n_del, overflow);
  return (int)cudaGetLastError();
}
