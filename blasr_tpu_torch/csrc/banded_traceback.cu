// K2: run-length traceback walk over the banded DP's cell words.
//
// Replaces blasr_tpu/kernels/banded.py::banded_traceback, an XLA
// while_loop of 64-step lax.scan chunks (no Pallas kernel on the TPU; on
// the GPU eager torch would pay ~60 launches per step and a host sync per
// chunk).  Each step follows `rl_step` exactly: one cell-word gather, a
// whole M run consumed per step via the in-cell run counters, single I/D
// bases, leading-deletion boundary runs capped at _CNT_CAP (re-looping),
// and stall steps (op 1, count 0) after a saturated band jump, which
// re-derive the band column from the offsets row.
//
// Output layout is the JAX one: halfword pairs op | count << 2, packed
// two per int32 word (low half first), zeros after the stop; the four
// counts; overflow = the walk did not finish within P steps.  The JAX
// chunked loop stops only once every row is done, which changes no row's
// output, so one thread walking its row to done (or P) reproduces it.
//
// Layout: one thread per item, a plain loop of at most P dependent steps.
// What bounds it on an H100: the latency of the dependent cell gather per
// step (each step's address comes from the previous step's word) — a few
// hundred nanoseconds from L2/HBM, times the number of steps (about twice
// the indel events of the alignment).  The design issues exactly one
// dependent load per step (the offsets load is taken only on stall steps)
// and writes pairs as whole int32 words; the pair buffer is zeroed by the
// wrapper, so the walk stores only up to its stop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WB = 128;
constexpr int CNT_CAP = 16383;
constexpr int ST_M = 0, ST_I = 1, ST_D = 2, ST_H = 3;

__global__ void banded_traceback_kernel(
    const int32_t* __restrict__ tbbits, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ qa_a, const int32_t* __restrict__ qb_a,
    const int32_t* __restrict__ ta_a, const int32_t* __restrict__ tb_a,
    const int32_t* __restrict__ fstate, const uint8_t* __restrict__ fvalid,
    int N, int L, int P, int32_t* __restrict__ pairs,
    int32_t* __restrict__ n_pairs, int32_t* __restrict__ n_match,
    int32_t* __restrict__ n_mismatch, int32_t* __restrict__ n_ins,
    int32_t* __restrict__ n_del, uint8_t* __restrict__ overflow) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int qa = qa_a[n], qb = qb_a[n], ta = ta_a[n], tb = tb_a[n];
  const int32_t* cells = tbbits + (size_t)n * L * WB;
  const int32_t* off = offsets + (size_t)n * L;
  int32_t* out = pairs + (size_t)n * (P / 2);

  int r = qb - 1, t = tb - 1;
  int w = tb - 1 - off[min(max(qb - 1, 0), L - 1)];
  bool wbad = false;
  int st = fstate[n];
  bool done = fvalid[n] == 0;
  int nm = 0, nmm = 0, nins = 0, ndel = 0, npairs = 0;
  uint32_t lo = 0;
  int step = 0;
  for (; step < P && !done; ++step) {
    const bool at_b = r < qa;
    const int rc = min(max(r, 0), L - 1);
    const bool w_ok = (w >= 0) && (w < WB);
    const int cell = cells[(size_t)rc * WB + min(max(w, 0), WB - 1)];
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
    if (emit && is_m) { nm += meq; nmm += mrun - meq; }
    if (emit && is_i) nins += 1;
    if (emit && is_d) ndel += 1;
    if (emit && b_more) ndel += b_cnt;
    if (emit) npairs += 1;
    done = b_done || (!at_b && !w_ok && emit);
    r = nr; t = nt; w = nw; wbad = nwbad; st = nst;
  }
  if (step & 1) out[step >> 1] = (int32_t)lo;  // half-filled last word
  n_pairs[n] = npairs;
  n_match[n] = nm;
  n_mismatch[n] = nmm;
  n_ins[n] = nins;
  n_del[n] = ndel;
  overflow[n] = done ? 0 : 1;
}

}  // namespace

extern "C" int blasr_banded_traceback(
    const int32_t* tbbits, const int32_t* offsets, const int32_t* qa,
    const int32_t* qb, const int32_t* ta, const int32_t* tb,
    const int32_t* final_state, const uint8_t* valid, int N, int L, int P,
    int32_t* pairs, int32_t* n_pairs, int32_t* n_match, int32_t* n_mismatch,
    int32_t* n_ins, int32_t* n_del, uint8_t* overflow, void* stream) {
  const int threads = 64;
  const int blocks = (N + threads - 1) / threads;
  banded_traceback_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      tbbits, offsets, qa, qb, ta, tb, final_state, valid, N, L, P, pairs,
      n_pairs, n_match, n_mismatch, n_ins, n_del, overflow);
  return (int)cudaGetLastError();
}
