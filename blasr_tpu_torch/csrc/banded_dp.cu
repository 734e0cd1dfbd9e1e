// K1: guided banded DP, forward pass, in compile-time modes.
//
// Replaces blasr_tpu/kernels/pallas_banded.py::pallas_banded_align (the
// Pallas TPU kernel, `_kernel` / `_block_body`, defined at
// pallas_banded.py:388) in both of its modes, and the XLA forward pass
// blasr_tpu/kernels/banded.py::banded_align (banded.py:362) in the forms
// the Pallas kernel does not take (the hp band, a general matrix); it
// reproduces banded.py::_align_one bit for bit: the same M/I/D (and H)
// min-cost recurrence, the same <= tie-breaks in the order M, I, D, H,
// INF = 1e30, and the same int32 cell word per banded cell (layout in
// blasr_tpu_torch/kernels/banded.py).
//   * distance mode (QV = false, "K1"): affine gaps from the arguments.
//     Every cost is an integer below 2^24, so fused or unfused float32
//     arithmetic gives the same bits.
//   * QV mode (QV = true, "K1-QV", the --useQuality path): per-row costs
//     from the packed tracks qv1/qv2 (int32 [N, L], layout in
//     kernels/banded.py::unpack_qv) -- mismatch subQV/prior by the
//     substitution tag, insertion insQV (linear), and a per-cell linear
//     deletion cost cd = delQV/prior by the deletion tag.  The in-row
//     deletion closed form runs on the prefix sum S of cd:
//     D = S + excl_prefix_min(base - S).  Every cost is an integer below
//     256 and S <= 128*255, so every float32 sum is exact in any order.
//     At the first row the boundary deletion profile is the running sum
//     of row qa's cd over the window from ta (the XLA kernel's cumz form):
//     the sum over ta..o_r-1 plus the in-band scan of cd at the cells'
//     own window positions t_abs < W.
//   * HP (HP = true, "K1-HP", the --affineAlign path, distance costs only):
//     a fourth state H, the homopolymer-insertion band.  An inserted base
//     equal to the previous read base (read[r] == read[r-1] < 4; code 4
//     before row 0, and at r == qa > 0 a base outside the aligned range)
//     opens from M at hp_open or extends H at hp_ext; H is a fourth
//     diagonal source (last in the tie order), base = min(M, I, H) feeds
//     D, and the final state is chosen four ways.  d_from_m still compares
//     M with I only, as the reference does; h_open is cell bit 6.  H is
//     finite only on hp_ok rows, so the recurrence runs each row as one of
//     four cases by whether it and the row before are hp_ok (see
//     recurrence), and a row where neither is costs a K1 row.
//   * GEN (GEN = true, "K1-GEN", a general --scoreMatrix, in the distance,
//     HP and QV forms): sub = submat[rb * 5 + tgt] for any 5x5 matrix, the
//     N row (read N) and N column (window N, the pad past W) included; eq
//     stays rb == tgt < 4.  In QV form a match costs the matrix's diagonal
//     entry of its base and a mismatch still comes from the tracks.
//
// Contract (as the Pallas kernel's): band width 128 and a band offset that
// advances by 0, 1 or 2 per active row; without GEN a two-valued score
// matrix (match on the ACGT diagonal, one mismatch value elsewhere).  The
// wrappers (kernels/cuda_ops.py, kernels/pallas_banded.py) check them and
// pick the mode.
//
// Layout: one CTA of three warps per item, decoupled through shared
// memory by double-buffered rings of R = 16-row tiles, each slot with a
// "full" and an "empty" mbarrier.
//   * Warp 0, the row-input stage, loads a tile's offsets, read bytes and
//     QV words (lane i holds row r0 + i) and, per row, the window bytes
//     under the band, and writes one 32-bit word per cell: eq, in_t,
//     in_t_i, in QV mode the substitution and deletion tag matches and
//     the prefix sum S of cd (its own 5-step shuffle scan), in HP mode
//     in_t_i & hp_ok, in GEN mode the target code; plus the row's offset,
//     shift s and QV costs, (GEN) the read base's five matrix entries in
//     a ring of their own past the others, and at row qa the boundary
//     deletion profile.
//   * Warp 1, the recurrence, runs only what crosses rows: lane l holds
//     band cells 4l..4l+3 and their M/I/D carries; per row one 16-byte
//     shared load of its four cell words, the diagonal / vertical
//     predecessors (eight shuffles a row, whatever the shift, then
//     selects: no branch around a shuffle), M and I, the exclusive
//     prefix-min of the deletion closed form (a 4-cell serial scan, then a
//     5-step __shfl_up scan), D, and a byte per cell of what the cell word
//     needs from them.  HP mode carries H beside them (one more pair of
//     shifts a row); GEN mode reads each cell's cost from the row's five
//     entries in shared memory by its target code.
//   * Warp 2 packs the cell words: it carries the M-run counter (a chain of
//     its own, one integer add or select per cell and row), and each tile's
//     words (R * 512 bytes) leave through shared memory in one
//     cp.async.bulk store, so no store waits on the chain.
// The row inputs arrive with plain loads: the window span under a tile
// starts at any byte, which a 16-byte-aligned bulk copy cannot express,
// and the stage runs a tile ahead of the recurrence, so their latency is
// off the chain.  Rows outside [qa, qb) are written as zeros, as both JAX
// kernels do.
//
// What bounds it on an H100: the per-row chain of dependent shuffles (the
// neighbour exchange and the prefix-min scan) -- one warp advances one item
// one row at a time -- and the cell-word stream, N*L*512 bytes per call
// (671 MB at N=640, L=2048), plus N*L*8 bytes of QV words in QV mode.
// Every intermediate stays on chip, so the stream is the only device-memory
// traffic of size; the chain's latency is hidden only by running many items
// (CTAs of 38 KB shared memory: five per SM), whose three warps each share
// the SM's issue slots, so at N = 640 a row takes about twice the chain's
// own latency: the instruction streams together set the pace.  The
// recurrence warp is the one that waits least (3% of its time, against
// 43-55% for the other two, tools/torch_kernel_phases.py --k1), so its
// row sets the pace of every mode.  In K1-HP the hp band added a fourth
// shifted state, the H terms and a four-way source to every row, 16% on
// the recurrence's row; the row cases keep that work to the rows that can
// carry H (on reads of uniform bases, about 44% of rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WB = 128;
constexpr int R = 16;  // rows per tile
constexpr float INF_F = 1e30f;
constexpr float HALF_INF = 1e30f * 0.5f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ST_M = 0, ST_I = 1, ST_D = 2;
constexpr int RUN_CAP = 63;

constexpr int ST_H = 3;

// cell-word flags of the row-input stage: bits 0-5, the target code (GEN)
// at bits 8-10, the QV prefix sum S at bits 16-31
constexpr unsigned F_EQ = 1u, F_IN_T = 2u, F_IN_TI = 4u, F_STAG = 8u,
                   F_DTAG = 16u, F_IN_TH = 32u;
constexpr int F_TGT_SHIFT = 8;

// a row's scalars: offset, shift, QV costs and (HP) whether the row can
// take the hp band, read[r] == read[r-1] < 4
struct RowScalars {
  int o_r, s;
  float insq, dpri, subq, spri, delq;
  int hp_ok;
};

// a double-buffered ring of R-row tiles between each pair of stages
struct Smem {
  int4 out[2][R][32];       // cell words, leaving by bulk store
  uint4 flags[2][R][32];    // row inputs: one word per cell
  RowScalars sc[2][R];
  unsigned code[2][R][32];  // the recurrence's cell codes, a byte per cell
  int shift[2][R];          // the row's shift s
  float bd[WB];             // boundary deletion profile at row qa
  unsigned long long full[2], empty[2];    // row inputs <-> recurrence
  unsigned long long full2[2], empty2[2];  // recurrence <-> cell words
};

// GEN: the rows' matrix entries, sub[tgt] = submat[rb * 5 + tgt] for each
// row of the ring, in the dynamic shared memory past Smem (so the other
// modes keep Smem's layout)
constexpr int GEN_SUB = 5;
__device__ __forceinline__ float* gen_sub(Smem& sm, int slot, int i) {
  return reinterpret_cast<float*>(&sm + 1) + (slot * R + i) * GEN_SUB;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The band of the previous row under this row's shift s in {0, 1, 2}:
// d[j] = x[4*lane + j + s - 1] (the diagonal predecessor) and, with v,
// v[j] = x[4*lane + j + s] (the vertical one), fill outside [0, 128).
// The shuffles do not depend on s, and s picks among registers by selects,
// so the row's code has no branch around a shuffle.
template <typename T>
__device__ __forceinline__ void band_shift(const T x[4], int s, T fill,
                                           int lane, T d[4], T* v = nullptr) {
  T up3 = __shfl_up_sync(FULL, x[3], 1);
  T dn0 = __shfl_down_sync(FULL, x[0], 1);
  if (lane == 0) up3 = fill;
  if (lane == 31) dn0 = fill;
  T dn1 = fill;
  if (v != nullptr) {
    dn1 = __shfl_down_sync(FULL, x[1], 1);
    if (lane == 31) dn1 = fill;
  }
  const T e[7] = {up3, x[0], x[1], x[2], x[3], dn0, dn1};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d[j] = s == 0 ? e[j] : (s == 1 ? e[j + 1] : e[j + 2]);
    if (v != nullptr) v[j] = s == 0 ? e[j + 1] : (s == 1 ? e[j + 2] : e[j + 3]);
  }
}

// value of cell 4*lane - 1 (fill at lane 0): the in-row left neighbour of
// this lane's first cell
__device__ __forceinline__ float left_of(float x3, int lane) {
  float v = __shfl_up_sync(FULL, x3, 1);
  return lane == 0 ? INF_F : v;
}

__device__ __forceinline__ float pick4(const float v[4], int j) {
  return j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
}

// inclusive prefix sum over the 128-cell band of x (4 cells per lane):
// a 4-cell serial sum per lane, then a 5-step __shfl_up scan of the lane
// totals.  Inputs are integers, so the sums are exact in any order.
__device__ __forceinline__ void band_cumsum(const float x[4], int lane,
                                            float out[4]) {
  out[0] = x[0];
  out[1] = out[0] + x[1];
  out[2] = out[1] + x[2];
  out[3] = out[2] + x[3];
  float scan = out[3];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(FULL, scan, d);
    if (lane >= d) scan += y;
  }
  float excl = __shfl_up_sync(FULL, scan, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] += excl;
}

struct Args {
  const int8_t* reads;
  const int8_t* windows;
  const int32_t* offsets;
  const int32_t *qa, *qb, *ta, *tb, *qv1, *qv2;
  int N, L, W;
  float match, mismatch, ins_open, ins_ext, del_open, del_ext;
  float hp_open, hp_ext;
  float submat[25];  // GEN: the whole matrix, read base major
  float* score;
  int32_t* tbbits;
  int32_t* state;
  uint8_t* valid;
};

// Warp 0: the row-input stage of item n.
template <bool QV, bool HP, bool GEN>
__device__ void row_inputs(const Args& a, Smem& sm, int n, int lane) {
  const int L = a.L, W = a.W;
  const int qa = a.qa[n], qb = a.qb[n], ta = a.ta[n], tb = a.tb[n];
  const int8_t* rd = a.reads + (size_t)n * L;
  const int8_t* win = a.windows + (size_t)n * W;
  const int32_t* off = a.offsets + (size_t)n * L;
  const int c0 = 4 * lane;
  const int ntiles = (L + R - 1) / R;
  for (int t = 0; t < ntiles; ++t) {
    const int slot = t & 1, use = t >> 1;
    if (use > 0) mbar_wait(&sm.empty[slot], (use - 1) & 1);
    const int r0 = t * R, nr = min(R, L - r0);
    int my_o = 0, my_prev = 0, my_rb = 4, my_rbp = 4;
    unsigned my_w1 = 0, my_w2 = 0;
    if (lane < nr && r0 + lane >= qa && r0 + lane < qb) {
      const int r = r0 + lane;
      my_o = __ldg(off + r);
      my_prev = r > 0 ? __ldg(off + r - 1) : 0;
      my_rb = __ldg(rd + r);
      if constexpr (HP) my_rbp = r > 0 ? __ldg(rd + r - 1) : 4;
      if constexpr (QV) {
        my_w1 = (unsigned)__ldg(a.qv1 + (size_t)n * L + r);
        my_w2 = (unsigned)__ldg(a.qv2 + (size_t)n * L + r);
      }
    }
    for (int i = 0; i < nr; ++i) {
      const int r = r0 + i;
      const int o_r = __shfl_sync(FULL, my_o, i);
      const int prev = __shfl_sync(FULL, my_prev, i);
      const int rb = __shfl_sync(FULL, my_rb, i);
      if (r < qa || r >= qb) continue;  // uniform
      const bool first = r == qa;
      RowScalars sc{o_r, first ? 0 : o_r - prev, 0.f, 0.f, 0.f, 0.f, 0.f,
                    0};
      int dtag = 7, stag = 7;
      bool hp_ok = false;
      if constexpr (HP) {
        const int rbp = __shfl_sync(FULL, my_rbp, i);
        hp_ok = rb == rbp && rbp < 4;
        sc.hp_ok = hp_ok;
      }
      if constexpr (GEN) {
        if (lane < GEN_SUB)
          gen_sub(sm, slot, i)[lane] = a.submat[rb * GEN_SUB + lane];
      }
      if constexpr (QV) {
        const unsigned w1 = __shfl_sync(FULL, my_w1, i);
        const unsigned w2 = __shfl_sync(FULL, my_w2, i);
        sc.insq = (float)(w1 & 255u);
        sc.delq = (float)((w1 >> 8) & 255u);
        sc.subq = (float)((w1 >> 16) & 255u);
        dtag = (int)((w1 >> 24) & 7u);
        stag = (int)((w1 >> 27) & 7u);
        sc.dpri = (float)(w2 & 255u);
        sc.spri = (float)((w2 >> 8) & 255u);
      }
      const int tstart = min(max(o_r, 0), W);
      unsigned fl[4];
      float cd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ti = tstart + c0 + j;
        const int tgt = ti < W ? (int)__ldg(win + ti) : 4;
        const int t_abs = o_r + c0 + j;
        fl[j] = ((rb == tgt) && (rb < 4) ? F_EQ : 0u) |
                ((t_abs >= ta) && (t_abs < tb) ? F_IN_T : 0u) |
                ((t_abs >= ta - 1) && (t_abs < tb) ? F_IN_TI : 0u);
        if constexpr (QV) {
          fl[j] |= (tgt == stag ? F_STAG : 0u) | (tgt == dtag ? F_DTAG : 0u);
          cd[j] = tgt == dtag ? sc.delq : sc.dpri;
        }
        if constexpr (HP) {
          if (hp_ok && t_abs >= ta - 1 && t_abs < tb) fl[j] |= F_IN_TH;
        }
        if constexpr (GEN) fl[j] |= (unsigned)tgt << F_TGT_SHIFT;
      }
      if constexpr (QV) {
        float S[4];
        band_cumsum(cd, lane, S);
#pragma unroll
        for (int j = 0; j < 4; ++j) fl[j] |= (unsigned)(int)S[j] << 16;
      }
      sm.flags[slot][i][lane] = make_uint4(fl[0], fl[1], fl[2], fl[3]);
      if (lane == 0) sm.sc[slot][i] = sc;
      if (first) {
        // the boundary row qa-1: leading deletions from ta on
        float bd[4];
        if constexpr (QV) {
          // running sum of row qa's cd at the window positions ta..t_abs
          // (t < W): the cells ta..o_r-1 left of the band, then the band
          const int t0 = max(ta, 0);
          float pre = 0.0f;
          for (int t = t0 + lane; t < min(o_r, W); t += 32)
            pre += (int)__ldg(win + t) == dtag ? sc.delq : sc.dpri;
#pragma unroll
          for (int d = 16; d > 0; d >>= 1)
            pre += __shfl_xor_sync(FULL, pre, d);
          float m[4], prof[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t_abs = o_r + c0 + j;
            m[j] = (t_abs >= t0 && t_abs < W)
                       ? ((int)__ldg(win + t_abs) == dtag ? sc.delq : sc.dpri)
                       : 0.0f;
          }
          band_cumsum(m, lane, prof);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bd[j] = o_r + c0 + j >= ta ? pre + prof[j] : INF_F;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t_abs = o_r + c0 + j;
            bd[j] = t_abs >= ta ? a.del_open + a.del_ext * (float)(t_abs - ta)
                                : INF_F;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) sm.bd[c0 + j] = bd[j];
      }
    }
    mbar_arrive(&sm.full[slot]);
  }
}

// cell code of the recurrence, one byte per cell: the cell word's bits
// 0-3 and 5 (msrc, iopen, d_open, eq), at bit 6 M <= I, which is the next
// cell's d_from_m, and at bit 7 (HP) h_open, cell-word bit 6
constexpr unsigned C_MLEI = 64u, C_HOPEN = 128u;

// a compile-time flag for the row cases of the recurrence
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Warp 1: the recurrence of item n.  Only the M/I/D (and H) carries cross
// rows here; the cell word's run counter and packing are warp 2's.
//
// HP: a row takes H only where it is hp_ok, so after a row that is not,
// every H is exactly INF_F, and so is every dH and vH of the next row.  The
// warp carries h_live (the previous active row was hp_ok) and runs each row
// as one of four cases, a branch the whole warp takes together:
//   1. !h_live, !hp_ok: K1's row; H is INF_F and h_open is
//      (vM + hp_open) <= hfh_inf, hfh_inf = INF_F + hp_ext per launch;
//   2. !h_live,  hp_ok: no pH shift, H = fminf(vM + hp_open, hfh_inf);
//   3.  h_live, !hp_ok: pH shifted for dH (the four-way diagonal) and vH
//      (h_open), H is INF_F;
//   4.  h_live,  hp_ok: the whole hp row.
// Each case computes the same floats as the whole row: every value of the
// DP is finite or exactly INF_F (INF_F plus a cost below 2^24 rounds back
// to it, and D is clipped to it), so a min with an INF_F operand is the
// min of the others, and with dH = INF_F the four-way source and final
// state fall to K1's three-way ones.
template <bool QV, bool HP, bool GEN>
__device__ void recurrence(const Args& a, Smem& sm, int n, int lane) {
  const int L = a.L;
  const int qa = a.qa[n], qb = a.qb[n], ta = a.ta[n], tb = a.tb[n];
  const float match = a.match, mismatch = a.mismatch;
  const float ins_open = a.ins_open, ins_ext = a.ins_ext;
  const float del_open = a.del_open, del_ext = a.del_ext;
  const float hp_open = a.hp_open, hp_ext = a.hp_ext;
  const float hfh_inf = INF_F + hp_ext;  // vH + hp_ext where vH is INF_F
  const int c0 = 4 * lane;

  float pM[4], pI[4], pD[4], pH[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pM[j] = INF_F; pI[j] = INF_F; pD[j] = INF_F; pH[j] = INF_F;
  }
  float fin_score = INF_F;
  int fin_state = ST_M;
  bool fin_ok = false;
  bool h_live = false;  // HP: the previous active row was hp_ok

  const int ntiles = (L + R - 1) / R;
  for (int t = 0; t < ntiles; ++t) {
    const int slot = t & 1, use = t >> 1;
    const int r0 = t * R, nr = min(R, L - r0);
    mbar_wait(&sm.full[slot], use & 1);
    if (use > 0) mbar_wait(&sm.empty2[slot], (use - 1) & 1);
    for (int i = 0; i < nr; ++i) {
      const int r = r0 + i;
      if (r < qa || r >= qb) continue;  // uniform
      const RowScalars& sc = sm.sc[slot][i];
      const int o_r = sc.o_r, s = sc.s;  // s in {0, 1, 2} (the wrapper checks)
      const uint4 f4 = sm.flags[slot][i][lane];
      const unsigned fl[4] = {f4.x, f4.y, f4.z, f4.w};
      if (r == qa) {  // boundary row qa-1 replaces the carries
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pM[j] = (o_r + c0 + j == ta - 1) ? 0.0f : INF_F;
          pI[j] = INF_F;
          pD[j] = sm.bd[c0 + j];
        }
        h_live = false;
      }
      // one row; HL: the previous row was hp_ok (its H, shifted, feeds
      // this row), HO: this row is hp_ok (it computes H)
      auto row = [&](auto hl, auto ho) {
        constexpr bool HL = HP && decltype(hl)::value;
        constexpr bool HO = HP && decltype(ho)::value;
        float dM[4], dI[4], dD[4], vM[4], vI[4], dH[4], vH[4];
        band_shift(pM, s, INF_F, lane, dM, vM);
        band_shift(pI, s, INF_F, lane, dI, vI);
        band_shift(pD, s, INF_F, lane, dD);
        if constexpr (HL) band_shift(pH, s, INF_F, lane, dH, vH);

        float M[4], I[4], H[4], base[4], g[4], S[4], cd[4];
        unsigned code[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          const bool in_t = fl[j] & F_IN_T;
          const bool in_t_i = fl[j] & F_IN_TI;
          const bool eq = fl[j] & F_EQ;
          float sub, ifm, ifi;
          if constexpr (GEN) {
            // the row's matrix entry of this cell's target base; in QV form
            // only a match (its base's diagonal entry) takes it
            const float gs =
                gen_sub(sm, slot, i)[(fl[j] >> F_TGT_SHIFT) & 7u];
            if constexpr (QV) {
              sub = eq ? gs : ((fl[j] & F_STAG) ? sc.subq : sc.spri);
            } else {
              sub = gs;
            }
          } else if constexpr (QV) {
            sub = eq ? match : ((fl[j] & F_STAG) ? sc.subq : sc.spri);
          } else {
            sub = eq ? match : mismatch;
          }
          float db = fminf(dM[j], fminf(dI[j], dD[j]));
          int last = ST_D;
          if constexpr (HL) {
            db = fminf(db, dH[j]);
            last = dD[j] <= db ? ST_D : ST_H;
          }
          const int msrc = dM[j] <= db ? ST_M : (dI[j] <= db ? ST_I : last);
          M[j] = in_t ? sub + db : INF_F;
          if constexpr (QV) {
            ifm = vM[j] + sc.insq;
            ifi = vI[j] + sc.insq;
          } else {
            ifm = vM[j] + ins_open;
            ifi = vI[j] + ins_ext;
          }
          I[j] = in_t_i ? fminf(ifm, ifi) : INF_F;
          bool hopen = false;
          if constexpr (HP) {
            const float hfm = vM[j] + hp_open;
            float hfh = hfh_inf;
            if constexpr (HL) hfh = vH[j] + hp_ext;
            hopen = hfm <= hfh;
            if constexpr (HO) {
              H[j] = (fl[j] & F_IN_TH) ? fminf(hfm, hfh) : INF_F;
              base[j] = fminf(fminf(M[j], I[j]), H[j]);
            } else {
              H[j] = INF_F;
              base[j] = fminf(M[j], I[j]);
            }
          } else {
            base[j] = fminf(M[j], I[j]);
          }
          if constexpr (QV) {
            S[j] = (float)(fl[j] >> 16);
            cd[j] = (fl[j] & F_DTAG) ? sc.delq : sc.dpri;
            g[j] = base[j] < HALF_INF ? base[j] - S[j] : INF_F;
          } else {
            g[j] = base[j] < HALF_INF ? base[j] - del_ext * (float)c : INF_F;
          }
          code[j] = (unsigned)msrc | (ifm <= ifi ? 4u : 0u) |
                    (eq ? 32u : 0u) | (M[j] <= I[j] ? C_MLEI : 0u) |
                    (hopen ? C_HOPEN : 0u);
        }
        // exclusive prefix-min of g over the 128-cell band
        float incl[4];
        incl[0] = g[0];
        incl[1] = fminf(incl[0], g[1]);
        incl[2] = fminf(incl[1], g[2]);
        incl[3] = fminf(incl[2], g[3]);
        float scan = incl[3];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float y = __shfl_up_sync(FULL, scan, d);
          if (lane >= d) scan = fminf(scan, y);
        }
        float excl = __shfl_up_sync(FULL, scan, 1);
        if (lane == 0) excl = INF_F;
        const float base_l = left_of(base[3], lane);

        float Dn[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          const bool in_t = fl[j] & F_IN_T;
          const float run_prev = j == 0 ? excl : fminf(excl, incl[j - 1]);
          float D;
          if constexpr (QV) {
            D = in_t ? S[j] + run_prev : INF_F;
          } else {
            D = in_t ? del_ext * (float)c + run_prev + (del_open - del_ext)
                     : INF_F;
          }
          D = fminf(D, INF_F);
          const float bprev = j == 0 ? base_l : base[j - 1];
          if (D >= bprev + (QV ? cd[j] : del_open)) code[j] |= 8u;
          Dn[j] = D;
        }
        sm.code[slot][i][lane] =
            code[0] | (code[1] << 8) | (code[2] << 16) | (code[3] << 24);
        if (lane == 0) sm.shift[slot][i] = s;

        if (r == qb - 1) {  // final (score, state) at cell t = tb-1
          const int wf = tb - 1 - o_r;
          if (wf >= 0 && wf < WB) {
            const int jj = wf & 3;
            const float cM0 = pick4(M, jj), cI0 = pick4(I, jj),
                        cD0 = pick4(Dn, jj);
            const float cM = __shfl_sync(FULL, cM0, wf >> 2);
            const float cI = __shfl_sync(FULL, cI0, wf >> 2);
            const float cD = __shfl_sync(FULL, cD0, wf >> 2);
            float cbest = fminf(cM, fminf(cI, cD));
            int clast = ST_D;
            if constexpr (HP) {
              const float cH = __shfl_sync(FULL, pick4(H, jj), wf >> 2);
              cbest = fminf(cbest, cH);
              clast = cD <= cbest ? ST_D : ST_H;
            }
            if (cbest < HALF_INF) {
              fin_score = cbest;
              fin_state = cM <= cbest ? ST_M : (cI <= cbest ? ST_I : clast);
              fin_ok = true;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pM[j] = M[j]; pI[j] = I[j]; pD[j] = Dn[j];
          if constexpr (HO) pH[j] = H[j];
        }
      };
      if constexpr (HP) {
        const bool hp_ok = sc.hp_ok != 0;
        if (h_live) {
          if (hp_ok) row(Flag<true>(), Flag<true>());
          else row(Flag<true>(), Flag<false>());
        } else {
          if (hp_ok) row(Flag<false>(), Flag<true>());
          else row(Flag<false>(), Flag<false>());
        }
        h_live = hp_ok;
      } else {
        row(Flag<false>(), Flag<false>());
      }
    }
    mbar_arrive(&sm.empty[slot]);  // the row inputs of the slot are read
    mbar_arrive(&sm.full2[slot]);  // its cell codes are written
  }
  if (lane == 0) {
    a.score[n] = fin_score;
    a.state[n] = fin_state;
    a.valid[n] = fin_ok ? 1 : 0;
  }
}

// Warp 2: the cell words of item n.  It carries the M-run counter, kept at
// its cell-word bits (rexit 7-8, mrun 9-14, meq 15-20, ssum 23-29): a fresh
// run starts at (msrc, 1, eq, s), a continued one adds (0, 1, eq, s) to
// the diagonal predecessor's.  No field overflows: mrun <= RUN_CAP,
// meq <= mrun and, with s <= 2, ssum <= 2 * mrun < 127, so the saturation
// at 127 never applies.  Each tile's words leave in one bulk store.
template <bool HP>
__device__ void cell_words(const Args& a, Smem& sm, int n, int lane) {
  const int L = a.L;
  const int qa = a.qa[n], qb = a.qb[n];
  int pC[4] = {0, 0, 0, 0};
  const int ntiles = (L + R - 1) / R;
  for (int t = 0; t < ntiles; ++t) {
    const int slot = t & 1, use = t >> 1;
    const int r0 = t * R, nr = min(R, L - r0);
    mbar_wait(&sm.full2[slot], use & 1);
    if (t >= 2) {
      // the bulk store of tile t-2 has read this out buffer
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncwarp();
    }
    for (int i = 0; i < nr; ++i) {
      const int r = r0 + i;
      if (r < qa || r >= qb) {
        sm.out[slot][i][lane] = make_int4(0, 0, 0, 0);
        continue;
      }
      const bool first = r == qa;
      const unsigned w = sm.code[slot][i][lane];
      unsigned wl = __shfl_up_sync(FULL, w, 1);
      if (lane == 0) wl = C_MLEI << 24;  // left of cell 0: INF <= INF
      const int s = sm.shift[slot][i];
      {
        int dC[4], bits[4];
        band_shift(pC, s, 0, lane, dC);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned code = (w >> (8 * j)) & 255u;
          const unsigned left = j == 0 ? wl >> 24 : (w >> (8 * j - 8)) & 255u;
          const int msrc = (int)(code & 3u);
          const int add = (1 << 9) | (int)((code & 32u) << 10) | (s << 23);
          const bool fresh =
              msrc != ST_M || first || ((dC[j] >> 9) & 63) >= RUN_CAP;
          pC[j] = fresh ? (msrc << 7) | add : dC[j] + add;
          bits[j] = pC[j] | (int)(code & 47u) |
                    ((left & C_MLEI) ? 16 : 0) | (s << 21);
          if constexpr (HP) bits[j] |= (int)((code & C_HOPEN) >> 1);
        }
        sm.out[slot][i][lane] = make_int4(bits[0], bits[1], bits[2], bits[3]);
      }
    }
    mbar_arrive(&sm.empty2[slot]);  // the slot's cell codes are read
    // the tile's cell words leave in one bulk store
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      int32_t* dst = a.tbbits + ((size_t)n * L + r0) * WB;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n\t"
          "cp.async.bulk.commit_group;" ::"l"(dst),
          "r"(smem_addr(&sm.out[slot][0][0])), "r"(nr * WB * 4)
          : "memory");
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <bool QV, bool HP, bool GEN>
__global__ void __launch_bounds__(96) banded_dp_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(&sm.full[k], 32);
      mbar_init(&sm.empty[k], 32);
      mbar_init(&sm.full2[k], 32);
      mbar_init(&sm.empty2[k], 32);
    }
  }
  __syncthreads();
  if (warp == 0) {
    row_inputs<QV, HP, GEN>(a, sm, n, lane);
  } else if (warp == 1) {
    recurrence<QV, HP, GEN>(a, sm, n, lane);
  } else {
    cell_words<HP>(a, sm, n, lane);
  }
}

// the dynamic shared memory of a mode
template <bool QV, bool HP, bool GEN>
constexpr size_t smem_bytes() {
  return sizeof(Smem) + (GEN ? 2 * R * GEN_SUB * sizeof(float) : 0);
}

template <bool QV, bool HP, bool GEN>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(banded_dp_kernel<QV, HP, GEN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<QV, HP, GEN>());
}

template <bool QV, bool HP = false, bool GEN = false>
int launch(const Args& a, void* stream) {
  banded_dp_kernel<QV, HP, GEN>
      <<<a.N, 96, smem_bytes<QV, HP, GEN>(), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Every mode's opt-in to its dynamic shared memory, on the current device;
// called once per device before any launch (blasr_setup_kernels), never
// while a stream is captured.
extern "C" int blasr_banded_dp_setup() {
  const cudaError_t errs[] = {
      opt_in<false, false, false>(), opt_in<true, false, false>(),
      opt_in<false, true, false>(),  opt_in<false, true, true>(),
      opt_in<true, false, true>(),   opt_in<false, false, true>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

extern "C" int blasr_banded_dp(
    const int8_t* reads, const int8_t* windows, const int32_t* offsets,
    const int32_t* qa, const int32_t* qb, const int32_t* ta,
    const int32_t* tb, int N, int L, int W, float match, float mismatch,
    float ins_open, float ins_ext, float del_open, float del_ext,
    float* score, int32_t* tbbits, int32_t* final_state, uint8_t* valid,
    void* stream) {
  const Args a{reads, windows, offsets, qa, qb, ta, tb, nullptr, nullptr,
               N, L, W, match, mismatch, ins_open, ins_ext, del_open,
               del_ext, 0.0f, 0.0f, {}, score, tbbits, final_state, valid};
  return launch<false>(a, stream);
}

// K1-QV: the QV-steered mode; the costs come from qv1/qv2, so of the
// scalar costs only the match value is taken.
extern "C" int blasr_banded_dp_qv(
    const int8_t* reads, const int8_t* windows, const int32_t* offsets,
    const int32_t* qa, const int32_t* qb, const int32_t* ta,
    const int32_t* tb, const int32_t* qv1, const int32_t* qv2, int N, int L,
    int W, float match, float* score, int32_t* tbbits, int32_t* final_state,
    uint8_t* valid, void* stream) {
  const Args a{reads, windows, offsets, qa, qb, ta, tb, qv1, qv2, N, L, W,
               match, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, {}, score,
               tbbits, final_state, valid};
  return launch<true>(a, stream);
}

// K1-HP and the GEN forms: hp != 0 takes the hp band (distance costs, no
// QV tracks), gen != 0 the general matrix ``submat`` (25 floats in host
// memory, read base major; copied into the launch's arguments) in place
// of match / mismatch, qv1/qv2 non-null the QV form (with gen only).
extern "C" int blasr_banded_dp_mode(
    const int8_t* reads, const int8_t* windows, const int32_t* offsets,
    const int32_t* qa, const int32_t* qb, const int32_t* ta,
    const int32_t* tb, const int32_t* qv1, const int32_t* qv2, int N, int L,
    int W, int hp, int gen, const float* submat, float match,
    float mismatch, float ins_open, float ins_ext, float del_open,
    float del_ext, float hp_open, float hp_ext, float* score,
    int32_t* tbbits, int32_t* final_state, uint8_t* valid, void* stream) {
  const bool qv = qv1 != nullptr;
  Args a{reads, windows, offsets, qa, qb, ta, tb, qv1, qv2, N, L, W,
         match, mismatch, ins_open, ins_ext, del_open, del_ext, hp_open,
         hp_ext, {}, score, tbbits, final_state, valid};
  if (gen)
    for (int k = 0; k < 25; ++k) a.submat[k] = submat[k];
  if (hp && !qv) {
    return gen ? launch<false, true, true>(a, stream)
               : launch<false, true, false>(a, stream);
  }
  if (gen && !hp) {
    return qv ? launch<true, false, true>(a, stream)
              : launch<false, false, true>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}
