// Traceback walk over the banded DP's arrow words: one thread per item.
//
// Replaces no TPU kernel. The JAX package walks the arrows with plain jnp
// code (blasr_tpu/ops/traceback_device.py), and the port's plain version
// (blasr_tpu_torch/ops/traceback_device.py:walk_arrows_plain) runs all
// items in lockstep: a Python loop of up to ceil((2S + 4) / 8) iterations
// of eight sub-steps, about 150 small launches a sub-step, and a wait for
// the device after every iteration to learn whether any item is still
// active. On the card that loop is paced by the host's launches and
// waits, not by the device. This kernel computes the same outputs, bit for
// bit, in one launch that the host never waits for.
//
// Each thread runs the plain walk's state machine for its own item: the
// anti-diagonal a, the band cell w, the state H/E/F, the four tallies and
// the move position in registers, up to the plain loop's cap of
// ceil((2S + 4) / 8) * 8 sub-steps, stopping where it stops (a start or
// stop arrow, a < 0, or w outside [0, W)). A sub-step reads one arrow
// word, at (a * I + i) * W + w, and a diagonal run of r cells jumps 2r
// anti-diagonals in one sub-step. The band offsets come in the plain
// walk's three forms, one template instance each: the closed-form drift
// schedule ((a - diag) * num) >> 16, centred and clamped (num read from a
// device scalar, so the host never fetches it), per-item guided knots
// (the lerp with a clamped to [0, S - 1]), or a shared (S,) table. The
// instance with moves writes each emitted run's boundary code
// ((p + 1) << 2) | op at its op position p into the item's zeroed row.
//
// Bound on the H100: each sub-step's address depends on the word before
// it, so a thread is one chain of dependent loads, one 32-byte sector
// each; the kernel is bound by its longest chain times the device memory
// latency (about 0.6-0.8 us a dependent load), not by bytes: 10^4 items of
// a few hundred sub-steps touch some 10^6 sectors, tens of MB, some tens
// of microseconds at 3.35 TB/s. The design keeps that chain short: the
// band offsets of the next address are integer arithmetic (drift) or
// cached loads of a few hundred bytes per item (knots, table) that do not
// wait for the arrow word, every item runs in its own thread of one wave
// (ceil(I / 128) blocks of 128 threads, 80 blocks at the main path's
// I = 10,240 on 132 SMs), and a warp runs as long as its longest item.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the arrow word (csrc/banded_dp.cu, ops/banded_align.py): a 3-bit source,
// the E and F bits, a 6-bit diagonal run and a 5-bit in-run mismatch count
constexpr int kSrcDiag = 0, kSrcUp = 1, kSrcLeft = 2, kSrcE = 3, kSrcF = 4, kSrcStop = 5,
              kSrcDiagStart = 6;
constexpr int kSrcMask = 7;
constexpr int kEShift = 3, kFShift = 4;
constexpr int kRunShift = 5, kRunMask = 63;
constexpr int kMisShift = 11;
// the ops of the boundary codes and the walk's states
constexpr int kOpM = 1, kOpI = 2, kOpD = 3;
constexpr int kStateH = 0, kStateE = 1, kStateF = 2;
// the band schedules (ops/banded_align.py)
constexpr int kQoffShift = 16;
constexpr int kKnotLog2 = 6;
constexpr int kKnotSpacing = 1 << kKnotLog2;
constexpr int kBandDrift = 0, kBandKnots = 1, kBandTable = 2;
constexpr int kThreads = 128;

struct Params {
  const uint16_t* arrows;  // (S, I, W)
  const int32_t *best_a, *best_w, *scores;  // (I,)
  const int32_t* qoff;     // table: (S,)
  const int32_t* knots;    // knots: (I, nk)
  const int32_t* num_ptr;  // drift: the slope numerator on the device, or null
  int num;                 // drift: the numerator when num_ptr is null
  int diag, half, hi;      // drift: diagonal origin, W_band / 2, max(0, L_q - W_band)
  int nk;
  int32_t* out;            // (9, I): nops q_start q_end t_start t_end match mismatch ins del
  int32_t* moves;          // (I, row) zeroed boundary-code rows, or null
  int row;                 // 4 * packed_width(S) + 1
  int n_items, S, W, max_steps;
};

// One item's band offset qoff(a) and step s1(a) = qoff(a) - qoff(a - 1),
// as the plain walk evaluates them.
template <int Band>
struct Offsets {
  int S, diag = 0, half = 0, hi = 0, num = 0, nk = 0;
  const int32_t* table = nullptr;  // table: the shared (S,) offsets
  const int32_t* knots = nullptr;  // knots: this item's row

  __device__ Offsets(const Params& p, int i) : S(p.S) {
    if constexpr (Band == kBandDrift) {
      diag = p.diag;
      half = p.half;
      hi = p.hi;
      num = p.num_ptr ? *p.num_ptr : p.num;
    } else if constexpr (Band == kBandKnots) {
      nk = p.nk;
      knots = p.knots + static_cast<size_t>(i) * nk;
    } else {
      table = p.qoff;
    }
  }

  __device__ __forceinline__ int clamp_a(int a) const { return min(max(a, 0), S - 1); }

  __device__ __forceinline__ int at(int a) const {
    if constexpr (Band == kBandDrift) {
      // int32 arithmetic that wraps as the plain version's does; >> floors
      const int cq = static_cast<int>(static_cast<unsigned>(a - diag) *
                                      static_cast<unsigned>(num)) >> kQoffShift;
      return min(max(cq - half, 0), hi);
    } else if constexpr (Band == kBandKnots) {
      const int c = clamp_a(a);
      const int j = c >> kKnotLog2, r = c & (kKnotSpacing - 1);
      const int k0 = knots[j], k1 = knots[min(j + 1, nk - 1)];
      return (k0 * (kKnotSpacing - r) + k1 * r) >> kKnotLog2;
    } else {
      return table[clamp_a(a)];
    }
  }

  __device__ __forceinline__ int step(int a) const {
    if constexpr (Band == kBandTable) {
      const int c = clamp_a(a);
      return c == 0 ? 0 : table[c] - table[c - 1];
    } else {
      return at(a) - at(a - 1);
    }
  }
};

template <int Band, bool Moves>
__global__ void __launch_bounds__(kThreads) traceback_walk_kernel(Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n_items) return;
  const Offsets<Band> qoff(p, i);
  const int a0 = p.best_a[i], w0 = p.best_w[i];
  const int W = p.W;
  const size_t I = p.n_items;
  const uint16_t* __restrict__ arrows = p.arrows;
  int32_t* moves = Moves ? p.moves + i * static_cast<size_t>(p.row) : nullptr;
  const int last = p.row - 2;  // the plain walk clamps an op position to S2 - 1

  int a = a0, w = w0, st = kStateH, mp = 0;
  int nmatch = 0, nmis = 0, nins = 0, ndel = 0;
  bool active = p.scores[i] < 0;
  for (int k = 0; k < p.max_steps && active; ++k) {
    const int ac = qoff.clamp_a(a);
    const int wc = min(max(w, 0), W - 1);
    const int word = __ldg(arrows + (static_cast<size_t>(ac) * I + i) * W + wc);
    int op = 0, cnt = 0, da = -1, dw = 0, next = kStateH;
    bool stop = false;
    if (st == kStateH) {
      const int src = word & kSrcMask;
      if (src == kSrcDiag || src == kSrcDiagStart) {
        stop = src == kSrcDiagStart;
        const int r = stop ? 1 : max((word >> kRunShift) & kRunMask, 1);
        const int mis = word >> kMisShift;
        op = kOpM;
        cnt = r;
        da = -2 * r;
        dw = qoff.at(ac) - qoff.at(ac - 2 * r) - r;
        nmatch += r - mis;
        nmis += mis;
      } else if (src == kSrcUp) {
        op = kOpI;
        cnt = 1;
        dw = qoff.step(ac) - 1;
        ++nins;
      } else if (src == kSrcLeft) {
        op = kOpD;
        cnt = 1;
        dw = qoff.step(ac);
        ++ndel;
      } else if (src == kSrcE || src == kSrcF || src == kSrcStop) {
        da = 0;
        next = src == kSrcE ? kStateE : (src == kSrcF ? kStateF : kStateH);
        stop = src == kSrcStop;
      }  // source 7 is no move: a steps back one anti-diagonal
    } else if (st == kStateE) {
      op = kOpD;
      cnt = 1;
      dw = qoff.step(ac);
      ++ndel;
      next = (word >> kEShift) & 1 ? kStateE : kStateH;
    } else {
      op = kOpI;
      cnt = 1;
      dw = qoff.step(ac) - 1;
      ++nins;
      next = (word >> kFShift) & 1 ? kStateF : kStateH;
    }
    if constexpr (Moves) {
      if (cnt > 0) moves[min(mp, last)] = ((mp + 1) << 2) | op;
    }
    mp += cnt;
    a += da;
    w += dw;
    st = next;
    active = !stop && a >= 0 && w >= 0 && w < W;
  }

  const int q_end = qoff.at(qoff.clamp_a(a0)) + w0 + 1;
  const int t_end = a0 - (q_end - 1) + 1;
  const int n_mops = nmatch + nmis;
  int32_t* out = p.out + i;
  out[0 * I] = n_mops + nins + ndel;
  out[1 * I] = q_end - (n_mops + nins);
  out[2 * I] = q_end;
  out[3 * I] = t_end - (n_mops + ndel);
  out[4 * I] = t_end;
  out[5 * I] = nmatch;
  out[6 * I] = nmis;
  out[7 * I] = nins;
  out[8 * I] = ndel;
}

template <int Band>
void launch(const Params& p, bool moves, cudaStream_t stream) {
  const int blocks = (p.n_items + kThreads - 1) / kThreads;
  if (moves)
    traceback_walk_kernel<Band, true><<<blocks, kThreads, 0, stream>>>(p);
  else
    traceback_walk_kernel<Band, false><<<blocks, kThreads, 0, stream>>>(p);
}

}  // namespace

// band: 0 drift (num_ptr or num, diag, half, hi), 1 knots (knots, nk),
// 2 table (qoff). moves: (I, row) int32 zeroed rows, or null.
extern "C" int traceback_walk_launch(const void* arrows, const void* best_a, const void* best_w,
                                     const void* scores, int band, const void* qoff,
                                     const void* knots, int nk, const void* num_ptr, int num,
                                     int diag, int half, int hi, void* out, void* moves, int row,
                                     int n_items, int S, int W, int max_steps, void* stream) {
  if (n_items <= 0) return 0;
  if (S <= 0 || W <= 0 || max_steps < 0 || (moves != nullptr && row < 2) ||
      (band == kBandKnots && nk <= 0) || band < kBandDrift || band > kBandTable)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const uint16_t*>(arrows),
           static_cast<const int32_t*>(best_a),
           static_cast<const int32_t*>(best_w),
           static_cast<const int32_t*>(scores),
           static_cast<const int32_t*>(qoff),
           static_cast<const int32_t*>(knots),
           static_cast<const int32_t*>(num_ptr),
           num, diag, half, hi, nk,
           static_cast<int32_t*>(out),
           static_cast<int32_t*>(moves),
           row, n_items, S, W, max_steps};
  const auto cs = static_cast<cudaStream_t>(stream);
  const bool with_moves = moves != nullptr;
  if (band == kBandDrift)
    launch<kBandDrift>(p, with_moves, cs);
  else if (band == kBandKnots)
    launch<kBandKnots>(p, with_moves, cs);
  else
    launch<kBandTable>(p, with_moves, cs);
  return static_cast<int>(cudaGetLastError());
}
