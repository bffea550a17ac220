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
// Bound on the H100: the S = L + T - 1 steps of an item are serial, so the
// kernel is latency bound on that loop (a few dozen integer operations,
// one or two neighbour exchanges and one 2W-byte arrow row store per step).
// The arrow stores, 2 bytes per cell, are its only DRAM traffic; the
// query and target bytes are re-read from L1 as the band slides.
//
// Design: one thread block per item and one thread per band cell (W is a
// template parameter in {32, 64, 128, 256}); all recurrence state lives in
// registers. The quality mode is a second template parameter, so the
// quality-free instance keeps its code and registers; a quality mode adds
// one global load of the cell's phred byte(s) beside the query code and a
// few integer operations per cell. The +-1 band shifts read a neighbour lane's value of the
// previous step(s): with W = 32 the band is one warp and the exchange is a
// __shfl_sync; with W > 32 each step's values go to a 3-slot shared-memory
// ring (step a writes slot a % 3 and reads the other two), so one barrier
// per step separates every read from the next overwrite. The TPU kernel's
// lane packing (_widen, _interleave, reversed targets) is layout for the
// TPU's 128-lane vregs and has no counterpart here; so is the chunked
// guided mode's packing of 128/W items per lane row and its fetch span,
// so the two guided TPU modes are one mode here. Guided and matrix live in
// a third template parameter, Special, that is on when either is: the
// instances without it are the shared-schedule, default-score kernel with
// nothing added (with the two switches as runtime branches of every
// instance, tools/dp_kernel_times.py measured 9-29% more time per launch
// on an NVIDIA H100 80GB HBM3 at 700 W). Inside
// a Special instance the two are runtime branches, uniform over the grid,
// so the build has 24 instances, not 48: a guided block stages its item's
// NK knots (about 110 at L = 3328) in dynamic shared memory and every
// thread evaluates the same lerp per step, in place of the qoff load; a
// matrix block stages the 25 values in shared memory and reads one per
// cell in place of the match/mismatch/N select. Each lane tracks its
// own best with a strict '<' (so it keeps its earliest step); one block
// reduction of a packed (score, a, w) key at the end gives the oracle's
// tie order.

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
constexpr int kMaxKnots = 8192;  // 32 KB of knots: with the ring, under 48 KB

struct Scores {
  int match, mismatch, n_score, ins, del, open, extend;
  int use_matrix;
  int mat[25];  // row-major query x target code (A C G T N)
};

__device__ __forceinline__ int lane_value(int x, int lane, int fill) {
  const int v = __shfl_sync(0xffffffffu, x, lane & 31);
  return (lane >= 0 && lane < 32) ? v : fill;
}

// max(1, floor((base * clip(q, 4, 30) + 7) / 15)), floor also for a
// negative base
__device__ __forceinline__ int qv_cost(int base, int q) {
  const int n = base * min(max(q, 4), 30) + 7;
  const int d = n >= 0 ? n / 15 : -((14 - n) / 15);
  return max(d, 1);
}

template <int W>
__device__ __forceinline__ int row_value(const int* row, int w, int fill) {
  return (w >= 0 && w < W) ? row[w] : fill;
}

template <int W, int QMode, bool Special>
__global__ void __launch_bounds__(W)
banded_dp_kernel(const uint8_t* __restrict__ query, const int32_t* __restrict__ qlen,
                 const uint8_t* __restrict__ target, const int32_t* __restrict__ tlo,
                 const int32_t* __restrict__ thi, const int32_t* __restrict__ qoff,
                 const int32_t* __restrict__ knots, int nk,
                 const void* __restrict__ qual, int32_t* __restrict__ best,
                 uint16_t* __restrict__ arrows,
                 int n_items, int L, int T, int S, Scores sc) {
  constexpr int kSlots = W > 32 ? 3 : 1;
  __shared__ int sH[kSlots][W], sE[kSlots][W], sF[kSlots][W], sR[kSlots][W],
      sM[kSlots][W];
  __shared__ int sMat[25];
  extern __shared__ int sKnots[];  // nk ints when guided (knots != nullptr)
  const int i = blockIdx.x;
  const int w = threadIdx.x;
  const uint8_t* qrow = query + static_cast<size_t>(i) * L;
  const uint8_t* trow = target + static_cast<size_t>(i) * T;
  const int ql = qlen[i], tl = tlo[i], th = thi[i];
  const bool guided = knots != nullptr;

  int cur = 0, p1 = 2, p2 = 1;  // ring slots of steps a, a-1, a-2
  if constexpr (W > 32) {
    for (int s = 1; s < 3; ++s) {
      sH[s][w] = kInf;
      sE[s][w] = kInf;
      sF[s][w] = kInf;
      sR[s][w] = 0;
      sM[s][w] = 0;
    }
  }
  if constexpr (Special) {
    if (guided) {
      const int32_t* krow = knots + static_cast<size_t>(i) * nk;
      for (int j = w; j < nk; j += W) sKnots[j] = krow[j];
    }
    if (sc.use_matrix && w == 0) {
#pragma unroll
      for (int j = 0; j < 25; ++j) sMat[j] = sc.mat[j];
    }
  }
  if constexpr (W > 32 || Special) __syncthreads();

  int H1 = kInf, H2 = kInf, E1 = kInf, F1 = kInf, R1 = 0, R2 = 0, M1 = 0, M2 = 0;
  int best_v = 0, best_a = 0;
  int qo_prev = 0, s1_prev = 0;
  for (int a = 0; a < S; ++a) {
    int qo;
    if (Special && guided) {
      const int j = a >> kKnotLog2, r = a & (kKnotSpacing - 1);
      qo = (sKnots[j] * (kKnotSpacing - r) + sKnots[min(j + 1, nk - 1)] * r) >> kKnotLog2;
    } else {
      qo = __ldg(qoff + a);
    }
    const int s1 = a > 0 ? qo - qo_prev : 0;
    const int s2 = s1_prev;
    qo_prev = qo;
    s1_prev = s1;
    const int dd = s1 + s2 - 1;
    const int q = qo + w;
    const int t = a - q;
    // a guided schedule comes from the caller's knots: keep its reads in
    // the row even if a knot lies outside [0, L - W]
    const bool q_in = (!Special || q >= 0) && q < L;
    const int qc = q_in ? static_cast<int>(__ldg(qrow + q)) : 4;
    const int tc = (t >= 0 && t < T) ? static_cast<int>(__ldg(trow + t)) : 5;
    const bool valid = q < ql && t >= tl && t < th && t >= 0;
    int x_cell = sc.mismatch, ins_cell = sc.ins;
    if constexpr (QMode == kQualSingle) {
      const uint8_t* qv = static_cast<const uint8_t*>(qual) + static_cast<size_t>(i) * L;
      const int v = q_in ? static_cast<int>(__ldg(qv + q)) : kQvNeutral;
      x_cell = qv_cost(sc.mismatch, v);
      ins_cell = qv_cost(sc.ins, v);
    } else if constexpr (QMode == kQualDual) {
      const uint16_t* qv = static_cast<const uint16_t*>(qual) + static_cast<size_t>(i) * L;
      const int v = q_in ? static_cast<int>(__ldg(qv + q))
                         : (kQvNeutral | (kQvNeutral << 8));
      x_cell = qv_cost(sc.mismatch, v & 255);
      ins_cell = qv_cost(sc.ins, v >> 8);
    }

    int H1_up, H1_left, E1_left, F1_up, H2_diag, R2_diag, M2_diag;
    if constexpr (W == 32) {
      H1_up = lane_value(H1, w + s1 - 1, kInf);
      H1_left = lane_value(H1, w + s1, kInf);
      E1_left = lane_value(E1, w + s1, kInf);
      F1_up = lane_value(F1, w + s1 - 1, kInf);
      H2_diag = lane_value(H2, w + dd, kInf);
      R2_diag = lane_value(R2, w + dd, 0);
      M2_diag = lane_value(M2, w + dd, 0);
    } else {
      H1_up = row_value<W>(sH[p1], w + s1 - 1, kInf);
      H1_left = row_value<W>(sH[p1], w + s1, kInf);
      E1_left = row_value<W>(sE[p1], w + s1, kInf);
      F1_up = row_value<W>(sF[p1], w + s1 - 1, kInf);
      H2_diag = row_value<W>(sH[p2], w + dd, kInf);
      R2_diag = row_value<W>(sR[p2], w + dd, 0);
      M2_diag = row_value<W>(sM[p2], w + dd, 0);
    }

    const bool eq = qc == tc && qc < 4;
    int sub;
    if (Special && sc.use_matrix) {
      sub = qc <= 4 ? sMat[qc * 5 + min(tc, 4)] : 0;
    } else {
      const bool anyn = qc >= 4 || tc >= 4;
      sub = eq ? sc.match : (anyn ? sc.n_score : x_cell);
    }

    const int e_open = H1_left + sc.open;
    int E_new = min(E1_left, e_open) + sc.extend;
    const int ebit = E1_left <= e_open;
    const int f_open = H1_up + sc.open;
    int F_new = min(F1_up, f_open) + sc.extend;
    const int fbit = F1_up <= f_open;

    int h = min(H2_diag, 0) + sub;
    int src = H2_diag > 0 ? kSrcDiagStart : kSrcDiag;
    int v = H1_up + ins_cell;
    if (v < h) { h = v; src = kSrcUp; }
    v = H1_left + sc.del;
    if (v < h) { h = v; src = kSrcLeft; }
    if (E_new < h) { h = E_new; src = kSrcE; }
    if (F_new < h) { h = F_new; src = kSrcF; }
    if (h >= 0) { h = 0; src = kSrcStop; }

    const int H_new = valid ? h : kInf;
    E_new = valid ? E_new : kInf;
    F_new = valid ? F_new : kInf;
    src = valid ? src : kSrcStop;
    const bool is_diag = src == kSrcDiag;
    const int mm = eq ? 0 : 1;
    const bool restart = R2_diag >= 63 || M2_diag >= 31;
    const int R_new = is_diag ? (restart ? 1 : R2_diag + 1) : 0;
    const int M_new = is_diag ? (restart ? mm : M2_diag + mm) : 0;
    const int M_emit = src == kSrcDiagStart ? mm : M_new;

    if (H_new < best_v) {
      best_v = H_new;
      best_a = a;
    }
    if (arrows != nullptr) {
      arrows[(static_cast<size_t>(a) * n_items + i) * W + w] = static_cast<uint16_t>(
          src | (ebit << 3) | (fbit << 4) | (R_new << 5) | (M_emit << 11));
    }
    if constexpr (W > 32) {
      sH[cur][w] = H_new;
      sE[cur][w] = E_new;
      sF[cur][w] = F_new;
      sR[cur][w] = R_new;
      sM[cur][w] = M_new;
      __syncthreads();
      const int old2 = p2;
      p2 = p1;
      p1 = cur;
      cur = old2;
    }
    H2 = H1;
    H1 = H_new;
    E1 = E_new;
    F1 = F_new;
    R2 = R1;
    R1 = R_new;
    M2 = M1;
    M1 = M_new;
  }

  // lexicographic (score, a, w) minimum over the band; the low word is
  // non-negative, so int64 order is the lexicographic order
  long long key = static_cast<long long>(best_v) * 4294967296LL +
                  static_cast<long long>((static_cast<unsigned>(best_a) << 9) |
                                         static_cast<unsigned>(w));
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_down_sync(0xffffffffu, key, off);
    key = o < key ? o : key;
  }
  if constexpr (W > 32) {
    __shared__ long long red[W / 32];
    if ((w & 31) == 0) red[w >> 5] = key;
    __syncthreads();
    if (w == 0) {
      for (int j = 1; j < W / 32; ++j) key = red[j] < key ? red[j] : key;
    }
  }
  if (w == 0) {
    const long long low = key & 0xffffffffLL;
    best[i] = static_cast<int32_t>((key - low) / 4294967296LL);
    best[n_items + i] = static_cast<int32_t>(low >> 9);
    best[2 * n_items + i] = static_cast<int32_t>(low & 511);
  }
}

// the launch's pointers and sizes, as the C entry point received them
struct Args {
  const void *query, *qlen, *target, *tlo, *thi, *qoff, *knots, *qual;
  void *best, *arrows;
  int nk, n_items, L, T, S;
};

template <int W, int QMode, bool Special>
void launch_special(const Args& g, const Scores& sc, cudaStream_t stream) {
  const size_t smem = g.knots != nullptr ? sizeof(int) * static_cast<size_t>(g.nk) : 0;
  banded_dp_kernel<W, QMode, Special><<<g.n_items, W, smem, stream>>>(
      static_cast<const uint8_t*>(g.query), static_cast<const int32_t*>(g.qlen),
      static_cast<const uint8_t*>(g.target), static_cast<const int32_t*>(g.tlo),
      static_cast<const int32_t*>(g.thi), static_cast<const int32_t*>(g.qoff),
      static_cast<const int32_t*>(g.knots), g.nk, g.qual,
      static_cast<int32_t*>(g.best), static_cast<uint16_t*>(g.arrows), g.n_items, g.L,
      g.T, g.S, sc);
}

template <int W, int QMode>
void launch_mode(const Args& g, const Scores& sc, cudaStream_t stream) {
  if (g.knots != nullptr || sc.use_matrix)
    launch_special<W, QMode, true>(g, sc, stream);
  else
    launch_special<W, QMode, false>(g, sc, stream);
}

template <int W>
bool launch(const Args& g, int qmode, const Scores& sc, cudaStream_t stream) {
  switch (qmode) {
    case kQualNone: launch_mode<W, kQualNone>(g, sc, stream); return true;
    case kQualSingle: launch_mode<W, kQualSingle>(g, sc, stream); return true;
    case kQualDual: launch_mode<W, kQualDual>(g, sc, stream); return true;
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
  const Args g{query, qlen, target, tlo, thi, qoff, knots, qual, best, arrows,
               knots != nullptr ? nk : 0, n_items, L, T, S};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (W) {
    case 32: ok = launch<32>(g, qmode, sc, st); break;
    case 64: ok = launch<64>(g, qmode, sc, st); break;
    case 128: ok = launch<128>(g, qmode, sc, st); break;
    case 256: ok = launch<256>(g, qmode, sc, st); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
