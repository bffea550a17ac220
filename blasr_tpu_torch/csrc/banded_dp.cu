// Banded affine-gap local alignment over anti-diagonals, with arrow words.
//
// Replaces the Pallas kernel banded_align_pallas (blasr_tpu/ops/
// banded_pallas.py:716, pallas_call at :957, body _make_kernel :200-686)
// in all its modes: unguided, guided W >= 128 (:374-403) and chunked guided
// W = 32/64 (:289-373), with or without quality values (the TPU's per-cell
// quality costs are :537-550), with the default scores or a score matrix
// (:555-559). It computes exactly what
// the plain version (blasr_tpu_torch/ops/banded_align.py, itself the port
// of the XLA-scan oracle blasr_tpu/ops/banded_align.py) computes:
//   cell (a, w): q = qoff[a] + w, t = a - q; guided, qoff[a] is each
//   item's own knot lerp (k0 * (64 - r) + k1 * r) >> 6 with j = a >> 6,
//   r = a & 63, k0 = knots[i][j], k1 = knots[i][min(j + 1, NK - 1)];
//   H = min(min(H(a-2, diag), 0) + sub, H(a-1, up) + ins, H(a-1, left) + del,
//           E, F), clamped at 0; E/F the affine open/extend recurrences;
//   with quality values (QMode single: one uint8 phred stream; dual: uint16
//   phred pairs, low byte sq, high byte iq) the mismatch cost of an ACGT
//   pair and the insertion cost become max(1, floor((base * clip(q, 4, 30)
//   + 7) / 15)) of the cell's query base, phred 15 past the read's row;
//   with a score matrix the substitution score is mat[5 qc + min(tc, 4)]
//   (the quality-scaled insertion cost stays);
//   cells outside qlen, [tlo, thi) or t >= 0 are INF;
//   one uint16 arrow word per cell: 3-bit source, E bit, F bit, 6-bit
//   diagonal run, 5-bit in-run mismatch count, stored (S, I, W);
//   per item the best (score, a, w): lowest score, then earliest step,
//   then smallest w.
//
// Bound on the H100: the S = L + T - 1 steps of an item are serial and
// the main path gives few items (I = 512 windows, about 4 per SM). At
// W = 32 an item is one warp, so each scheduler holds about one warp and
// the kernel is bound by one step's dependency chain and the in-order
// issue of its instructions, not by the card's integer rate: a design
// with its loads on the chain took about 430 cycles a step against the
// 153 that the operation count allows, this one 290-370
// (tools/dp_kernel_times.py, NVIDIA H100 80GB HBM3 at 700 W). At W >= 128
// a step holds W cells for the same chain and the kernel nears the issue
// rate of its integer instructions.
// The arrow stores, 2 bytes per cell, are its only DRAM traffic.
//
// Design: one block per item and one thread per band cell. W = 32 is one
// warp, and the +-1 band shifts are shuffles; at W > 32 each step's H, E,
// F and R | M go to a 3-slot shared ring (step a writes slot a % 3 and
// reads the other two), one barrier per step. (One warp per item with
// W / 32 cells a lane, which drops the ring and the barrier, measured
// 0.8-1.6x this at W >= 64: four warps an SM hide less latency than 8-32.)
// Warps issue in order, so every load's consumer sits a step after it:
// the schedule runs three steps ahead (the shared qoff, or the guided knot
// line advanced by one add per step, whose per-segment slope is read from
// shared memory a step before its add), the query, target and phred loads
// two steps ahead, and the step's costs (substitution, insertion, the
// diagonal increment, the valid range as one unsigned compare) one step
// ahead; the loop runs two steps per pass so that the pipeline's registers
// rotate by renaming. Quality costs come from two 256-entry tables per
// block (one entry per phred byte, filled in the prologue), looked up at
// the top of the step before, so no division is left in the loop. The
// diagonal run R (6 bits) and mismatch count M (5 bits) travel packed as
// R | M << 6, the arrow word's own layout, so one exchange and one add
// carry both, and the five-way minimum is a tree of depth three. Schedules
// with steps outside {0, 1} stay exact: every exchange takes any offset.
// The quality mode, the guided schedule and the score matrix are template
// parameters (48 instances): one flag for both with runtime branches
// inside cost 20-40% a launch at W = 32. Each thread
// tracks its cell's best with a strict '<' (so it keeps its earliest
// step); one block reduction of a packed (score, a, w) key at the end
// gives the oracle's tie order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kSrcDiag = 0, kSrcUp = 1, kSrcLeft = 2, kSrcE = 3, kSrcF = 4,
              kSrcStop = 5, kSrcDiagStart = 6;
constexpr int kMaxSteps = 1 << 22;  // a must fit the 23 bits of the best key
constexpr int kQualNone = 0, kQualSingle = 1, kQualDual = 2;
constexpr int kQvNeutral = 15;
constexpr int kKnotLog2 = 6, kKnotSpacing = 1 << kKnotLog2;
constexpr int kMaxKnots = 8192;  // 32 KB of slopes: with the ring and tables, under 48 KB
constexpr int kRunMask = 63, kMisShift = 6;  // R | M << 6, as in the arrow word
constexpr unsigned kFull = 0xffffffffu;

struct Scores {
  int match, mismatch, n_score, ins, del, open, extend;
  int use_matrix;
  int mat[25];  // row-major query x target code (A C G T N)
};

// max(1, floor((base * clip(q, 4, 30) + 7) / 15)), floor also for a
// negative base
__device__ __forceinline__ int qv_cost(int base, int q) {
  const int n = base * min(max(q, 4), 30) + 7;
  const int d = n >= 0 ? n / 15 : -((14 - n) / 15);
  return max(d, 1);
}

// The kernel's parameters
struct Params {
  const uint8_t* query;
  const int32_t* qlen;
  const uint8_t* target;
  const int32_t *tlo, *thi, *qoff, *knots;
  const void* qual;
  int32_t* best;
  uint16_t* arrows;
  int nk, n_items, L, T, S;
};

// One item's band schedule, called for a = 0, 1, 2, ... in turn: the
// shared qoff, one load; guided, the knot line acc = 64 k_j + r (k_j+1 -
// k_j) at a = 64 j + r, advanced by one add of its segment's slope per
// step (at a segment's end acc is 64 k_j+1 by itself), qoff = acc >> 6.
template <bool Guided>
struct Schedule {
  const int32_t* qoff;
  const int* slope;  // guided: k_min(j+1, nk-1) - k_j per segment j, in shared memory
  int nk, S, acc, next;  // guided: acc at step a, the slope of step a
  __device__ __forceinline__ int operator()(int a) {
    if constexpr (Guided) {
      // the slope of step a + 1 is loaded a call ahead of its add
      const int qo = acc >> kKnotLog2;
      acc += next;
      next = slope[min((a + 1) >> kKnotLog2, nk - 1)];
      return qo;
    } else {
      return __ldg(qoff + min(a, S - 1));
    }
  }
};

// One cell's raw inputs of one step (query and target codes, phred),
// loaded two steps ahead
struct Raw {
  int qc, tc, qv;
};

template <int QMode, bool Guided>
__device__ __forceinline__ Raw load_cell(const uint8_t* qrow, const uint8_t* trow,
                                         const uint8_t* qv8, const uint16_t* qv16, int L,
                                         int T, int a, int q) {
  Raw r;
  const int t = a - q;
  // a guided schedule comes from the caller's knots: keep its reads in the
  // row even if a knot lies outside [0, L - W]
  const bool q_in = Guided ? static_cast<unsigned>(q) < static_cast<unsigned>(L) : q < L;
  r.qc = q_in ? static_cast<int>(__ldg(qrow + q)) : 4;
  r.tc = static_cast<unsigned>(t) < static_cast<unsigned>(T) ? static_cast<int>(__ldg(trow + t))
                                                              : 5;
  r.qv = 0;
  if constexpr (QMode == kQualSingle) {
    r.qv = q_in ? static_cast<int>(__ldg(qv8 + q)) : kQvNeutral;
  } else if constexpr (QMode == kQualDual) {
    r.qv = q_in ? static_cast<int>(__ldg(qv16 + q)) : (kQvNeutral | (kQvNeutral << 8));
  }
  return r;
}

// the cell's costs one step ahead: substitution, insertion, the R | M << 6
// increment of a diagonal move, and whether the cell is in the valid range
struct Cost {
  int sub, ins, inc;
  bool valid;
};

// the quality costs of a cell from the per-block tables: its mismatch and
// insertion costs (the scores themselves without quality values)
struct QCost {
  int x, ins;
};

template <int QMode, bool Matrix>
__device__ __forceinline__ QCost lookup(const Raw& r, const Scores& sc, const int* sXc,
                                        const int* sIc) {
  QCost q{sc.mismatch, sc.ins};
  if constexpr (QMode == kQualSingle) {
    if constexpr (!Matrix) q.x = sXc[r.qv];
    q.ins = sIc[r.qv];
  } else if constexpr (QMode == kQualDual) {
    if constexpr (!Matrix) q.x = sXc[r.qv & 255];
    q.ins = sIc[r.qv >> 8];
  }
  return q;
}

template <bool Matrix>
__device__ __forceinline__ Cost derive(const Raw& r, const QCost& q, const Scores& sc,
                                       const int* sMat, bool valid) {
  Cost c;
  const bool eq = r.qc == r.tc && r.qc < 4;
  c.ins = q.ins;
  if constexpr (Matrix) {
    c.sub = r.qc <= 4 ? sMat[r.qc * 5 + min(r.tc, 4)] : 0;
  } else {
    c.sub = eq ? sc.match : ((r.qc >= 4 || r.tc >= 4) ? sc.n_score : q.x);
  }
  c.inc = eq ? 1 : (1 | (1 << kMisShift));
  c.valid = valid;
  return c;
}

// One cell's recurrence from its neighbours' values of the steps before;
// returns H and sets E, F, R | M << 6 and the arrow word
__device__ __forceinline__ int cell(const Scores& sc, int H1u, int H1l, int E1l, int F1u,
                                    int H2d, int rm2, const Cost& c, int& E, int& F, int& RM,
                                    int& word) {
  const int e_open = H1l + sc.open;
  E = min(E1l, e_open) + sc.extend;
  const int ebit = E1l <= e_open;
  const int f_open = H1u + sc.open;
  F = min(F1u, f_open) + sc.extend;
  const int fbit = F1u <= f_open;
  // the first minimum in the order diag, up, left, E, F, as a tree
  int hA = min(H2d, 0) + c.sub, sA = H2d > 0 ? kSrcDiagStart : kSrcDiag;
  const int hu = H1u + c.ins;
  if (hu < hA) { hA = hu; sA = kSrcUp; }
  int hB = H1l + sc.del, sB = kSrcLeft;
  if (E < hB) { hB = E; sB = kSrcE; }
  if (F < hB) { hB = F; sB = kSrcF; }
  int h = hA, src = sA;
  if (hB < h) { h = hB; src = sB; }
  if (h >= 0) { h = 0; src = kSrcStop; }
  if (!c.valid) {
    h = E = F = kInf;
    src = kSrcStop;
  }
  const bool restart = (rm2 & kRunMask) == kRunMask || rm2 >= (31 << kMisShift);
  RM = src == kSrcDiag ? (restart ? c.inc : rm2 + c.inc) : 0;
  const int emit = src == kSrcDiagStart ? c.inc - 1 : RM;
  word = src | (ebit << 3) | (fbit << 4) | (emit << 5);
  return h;
}

// the value of lane (or band index) w of a step's row, fill off the band
__device__ __forceinline__ int lane_value(int x, int w, int fill) {
  const int v = __shfl_sync(kFull, x, w & 31);
  return static_cast<unsigned>(w) < 32u ? v : fill;
}

template <int W>
__device__ __forceinline__ int row_value(const int* row, int w, int fill) {
  return static_cast<unsigned>(w) < static_cast<unsigned>(W) ? row[w] : fill;
}

// One block per item, one thread per band cell. W = 32: one warp, and the
// +-1 band shifts are shuffles. W > 32: each step's H, E, F and R | M go to
// a 3-slot shared ring (step a writes slot a % 3 and reads the other two),
// one barrier per step.
template <int W, int QMode, bool Guided, bool Matrix>
__global__ void __launch_bounds__(W) banded_dp_kernel(Params p, Scores sc) {
  constexpr int kSlots = W > 32 ? 3 : 1;
  constexpr bool kQual = QMode != kQualNone;
  __shared__ int sH[kSlots][W], sE[kSlots][W], sF[kSlots][W], sRM[kSlots][W];
  __shared__ int sXc[kQual ? 256 : 1], sIc[kQual ? 256 : 1];  // cost per phred byte
  __shared__ int sMat[25];
  __shared__ long long red[W / 32];
  extern __shared__ int sSlope[];  // nk ints when guided
  const int i = blockIdx.x;
  const int w = threadIdx.x;
  const int L = p.L, T = p.T, S = p.S;
  const uint8_t* qrow = p.query + static_cast<size_t>(i) * L;
  const uint8_t* trow = p.target + static_cast<size_t>(i) * T;
  const uint8_t* qv8 = static_cast<const uint8_t*>(p.qual) + static_cast<size_t>(i) * L;
  const uint16_t* qv16 = static_cast<const uint16_t*>(p.qual) + static_cast<size_t>(i) * L;
  // the valid range of step a is the band indexes [vlo, vlo + span) with
  // vlo = a - qo - thi + 1 and vlo + span = min(qlen - qo, a - qo -
  // max(tlo, 0) + 1); the bounds are clamped to +-2^28 where that changes
  // no cell of a band within +-2^27
  constexpr int kClamp = 1 << 28;
  const int ql = min(max(p.qlen[i], -kClamp), kClamp);
  const int tl0 = min(max(p.tlo[i], 0), kClamp);
  const int th = min(max(p.thi[i], 0), kClamp);
  auto valid_at = [&](int a, int qo) {
    const int vlo = a - qo - th + 1;
    const int span = max(min(ql - qo, a - qo - tl0 + 1) - vlo, 0);
    return static_cast<unsigned>(w - vlo) < static_cast<unsigned>(span);
  };

  if constexpr (kQual) {
    for (int v = w; v < 256; v += W) {
      sXc[v] = qv_cost(sc.mismatch, v);
      sIc[v] = qv_cost(sc.ins, v);
    }
  }
  if constexpr (Guided) {
    const int32_t* krow = p.knots + static_cast<size_t>(i) * p.nk;
    for (int j = w; j < p.nk; j += W) sSlope[j] = krow[min(j + 1, p.nk - 1)] - krow[j];
  }
  if constexpr (Matrix) {
    if (w == 0) {
#pragma unroll
      for (int j = 0; j < 25; ++j) sMat[j] = sc.mat[j];
    }
  }
  if constexpr (W > 32) {
    for (int s = 1; s < 3; ++s) {
      sH[s][w] = sE[s][w] = sF[s][w] = kInf;
      sRM[s][w] = 0;
    }
  }
  __syncthreads();

  // the pipeline: the costs of step a, the raw loads of step a + 1, the
  // schedule up to step a + 2
  Schedule<Guided> sched{p.qoff, sSlope, p.nk, S,
                         Guided ? p.knots[static_cast<size_t>(i) * p.nk] * kKnotSpacing : 0,
                         Guided ? sSlope[0] : 0};
  int qo0 = sched(0), qo1 = sched(1), qo2 = sched(2);
  const Raw raw0 = load_cell<QMode, Guided>(qrow, trow, qv8, qv16, L, T, 0, qo0 + w);
  Cost cost = derive<Matrix>(raw0, lookup<QMode, Matrix>(raw0, sc, sXc, sIc), sc, sMat,
                                    valid_at(0, qo0));
  Raw raw1 = load_cell<QMode, Guided>(qrow, trow, qv8, qv16, L, T, 1, qo1 + w);

  int H1 = kInf, H2 = kInf, E1 = kInf, F1 = kInf, RM1 = 0, RM2 = 0;
  int best_v = 0, best_a = 0, s1 = 0, s2 = 0;
  int cur = 0, p1 = 2, p2 = 1;  // ring slots of steps a, a-1, a-2 (W > 32)
  uint16_t* arow = p.arrows != nullptr ? p.arrows + static_cast<size_t>(i) * W + w : nullptr;
  const size_t arow_step = static_cast<size_t>(p.n_items) * W;

  // two steps per pass, so the pipeline's registers rotate by renaming
#pragma unroll 2
  for (int a = 0; a < S; ++a) {
    // ahead of the chain: the schedule of step a + 3, the loads of a + 2
    const int qo3 = sched(a + 3);
    const Raw raw2 = load_cell<QMode, Guided>(qrow, trow, qv8, qv16, L, T, a + 2, qo2 + w);
    const QCost qc1 = lookup<QMode, Matrix>(raw1, sc, sXc, sIc);

    // the neighbours' values of the steps before
    const int dd = s1 + s2 - 1;
    int H1u, H1l, E1l, F1u, H2d, RM2d;
    if constexpr (W == 32) {
      H2d = lane_value(H2, w + dd, kInf);
      RM2d = lane_value(RM2, w + dd, 0);
      H1u = lane_value(H1, w + s1 - 1, kInf);
      H1l = lane_value(H1, w + s1, kInf);
      E1l = lane_value(E1, w + s1, kInf);
      F1u = lane_value(F1, w + s1 - 1, kInf);
    } else {
      H2d = row_value<W>(sH[p2], w + dd, kInf);
      RM2d = row_value<W>(sRM[p2], w + dd, 0);
      H1u = row_value<W>(sH[p1], w + s1 - 1, kInf);
      H1l = row_value<W>(sH[p1], w + s1, kInf);
      E1l = row_value<W>(sE[p1], w + s1, kInf);
      F1u = row_value<W>(sF[p1], w + s1 - 1, kInf);
    }
    int E, F, RM, word;
    const int H = cell(sc, H1u, H1l, E1l, F1u, H2d, RM2d, cost, E, F, RM, word);
    if constexpr (W > 32) {
      sH[cur][w] = H;
      sE[cur][w] = E;
      sF[cur][w] = F;
      sRM[cur][w] = RM;
    }
    if (H < best_v) {
      best_v = H;
      best_a = a;
    }
    if (arow != nullptr) {
      *arow = static_cast<uint16_t>(word);
      arow += arow_step;
    }

    // the next step's costs, from the loads of the step before
    cost = derive<Matrix>(raw1, qc1, sc, sMat, valid_at(a + 1, qo1));
    raw1 = raw2;
    s2 = s1;
    s1 = qo1 - qo0;
    qo0 = qo1;
    qo1 = qo2;
    qo2 = qo3;
    if constexpr (W > 32) {
      __syncthreads();
      const int old2 = p2;
      p2 = p1;
      p1 = cur;
      cur = old2;
    } else {
      H2 = H1;
      H1 = H;
      E1 = E;
      F1 = F;
      RM2 = RM1;
      RM1 = RM;
    }
  }

  // lexicographic (score, a, w) minimum over the band; the low word is
  // non-negative, so int64 order is the lexicographic order
  long long key = static_cast<long long>(best_v) * 4294967296LL +
                  static_cast<long long>((static_cast<unsigned>(best_a) << 9) |
                                         static_cast<unsigned>(w));
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_down_sync(kFull, key, off);
    key = o < key ? o : key;
  }
  if constexpr (W > 32) {
    if ((w & 31) == 0) red[w >> 5] = key;
    __syncthreads();
    if (w == 0) {
      for (int j = 1; j < W / 32; ++j) key = red[j] < key ? red[j] : key;
    }
  }
  if (w == 0) {
    const long long low = key & 0xffffffffLL;
    p.best[i] = static_cast<int32_t>((key - low) / 4294967296LL);
    p.best[p.n_items + i] = static_cast<int32_t>(low >> 9);
    p.best[2 * p.n_items + i] = static_cast<int32_t>(low & 511);
  }
}

template <int W, int QMode, bool Guided>
void launch_scores(const Params& p, const Scores& sc, cudaStream_t stream) {
  const size_t smem = Guided ? sizeof(int) * static_cast<size_t>(p.nk) : 0;
  if (sc.use_matrix)
    banded_dp_kernel<W, QMode, Guided, true><<<p.n_items, W, smem, stream>>>(p, sc);
  else
    banded_dp_kernel<W, QMode, Guided, false><<<p.n_items, W, smem, stream>>>(p, sc);
}

template <int W, int QMode>
void launch_mode(const Params& p, const Scores& sc, cudaStream_t stream) {
  if (p.knots != nullptr)
    launch_scores<W, QMode, true>(p, sc, stream);
  else
    launch_scores<W, QMode, false>(p, sc, stream);
}

template <int W>
bool launch(const Params& p, int qmode, const Scores& sc, cudaStream_t stream) {
  switch (qmode) {
    case kQualNone: launch_mode<W, kQualNone>(p, sc, stream); return true;
    case kQualSingle: launch_mode<W, kQualSingle>(p, sc, stream); return true;
    case kQualDual: launch_mode<W, kQualDual>(p, sc, stream); return true;
    default: return false;
  }
}

}  // namespace

// Exactly one of qoff (S,) and knots (n_items, nk) is given: the shared
// schedule or the per-item guided knots, nk >= ((S - 1) >> 6) + 1.
// qual: (n_items, L) uint8 (qmode 1) or uint16 (qmode 2), NULL for qmode 0.
// matrix: 25 ints on the host (row-major query x target code), or NULL for
// the match/mismatch/N scores.
extern "C" int banded_dp_launch(const void* query, const void* qlen, const void* target,
                                const void* tlo, const void* thi, const void* qoff,
                                const void* knots, int nk, const void* qual, int qmode,
                                void* best, void* arrows, int n_items, int L, int T, int S,
                                int W, int match, int mismatch, int n_score, int ins,
                                int del, int open, int extend, const int* matrix,
                                void* stream) {
  if (n_items <= 0) return 0;
  if (S != L + T - 1 || S <= 0 || S >= kMaxSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((qmode == kQualNone) != (qual == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((qoff == nullptr) == (knots == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (knots != nullptr && (nk < ((S - 1) >> kKnotLog2) + 1 || nk > kMaxKnots))
    return static_cast<int>(cudaErrorInvalidValue);
  Scores sc{match, mismatch, n_score, ins, del, open, extend, matrix != nullptr, {}};
  if (matrix != nullptr)
    for (int j = 0; j < 25; ++j) sc.mat[j] = matrix[j];
  const Params p{static_cast<const uint8_t*>(query), static_cast<const int32_t*>(qlen),
                 static_cast<const uint8_t*>(target), static_cast<const int32_t*>(tlo),
                 static_cast<const int32_t*>(thi), static_cast<const int32_t*>(qoff),
                 static_cast<const int32_t*>(knots), qual, static_cast<int32_t*>(best),
                 static_cast<uint16_t*>(arrows), knots != nullptr ? nk : 0, n_items, L, T, S};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (W) {
    case 32: ok = launch<32>(p, qmode, sc, st); break;
    case 64: ok = launch<64>(p, qmode, sc, st); break;
    case 128: ok = launch<128>(p, qmode, sc, st); break;
    case 256: ok = launch<256>(p, qmode, sc, st); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
