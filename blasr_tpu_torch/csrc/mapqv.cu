// Mapping quality of every DP candidate: one thread per read.
//
// Replaces no TPU kernel. The JAX package computes MAPQ with plain jnp code
// (blasr_tpu/ops/mapqv.py, no pallas_call), and the port's plain version
// (blasr_tpu_torch/ops/mapqv.py:map_qv_float) unrolls the candidate loops
// in Python: CD(CD - 1)/2 overlap tests, CD^2 partition steps and CD
// log-sum steps, each float32 multiply-add emulated in float64 and each of
// exp, log1p, log and pow(10, x) dozens of elementwise operations. At the
// benchmark cells' batch (B = 1024 reads, CD = 10) that is about 10,000
// launches of microsecond kernels, paced by the host. This kernel was
// added as the port's own bottleneck: it computes the same (B, CD) result,
// bit for bit, in one launch that the host never waits for.
//
// Each thread takes one read and runs map_qv_float's steps in its order:
// the stable score order with invalid candidates last, the greedy overlap
// partition (containment or more than 0.75 of either interval), each
// partition's widest interval under the nMatch * 1.2 gate, the flank
// charge beyond WIGGLE, each partition's running log10 sum under the same
// gate with its first member taken as it is, then 1 - 10^(pr - denom) to
// Phred with the sub < -20, one_minus <= 0 and psize <= 1 branches, and
// the scatter back to the caller's candidate order. The plain version's
// per-partition loops over all candidates change a partition's state only
// at its members, so one pass over the candidates, each updating its own
// partition, gives the same sequence of states.
//
// The float arithmetic is the plain version's, operation for operation: its
// copies of XLA's CPU exp, log1p and log and of glibc's powf
// (ops/xla_math.py) become device functions below, each float32 multiply-
// add that it emulates through float64 rounded to odd is __fmaf_rn, each
// float64 one (_fma64) __fma_rn, every other multiply, add, subtract and
// divide an _rn intrinsic, so nvcc never contracts a multiply and an add on
// its own, and XLA's flush of subnormal results (_ftz) stays explicit. The
// 32-entry table of powf's exp2 lives in constant memory.
//
// The per-candidate arrays live in a scratch buffer that the wrapper
// allocates, laid out (field, candidate, read) so that a warp's accesses
// are coalesced; so every CD launches the same kernel.
//
// Bound on the H100: one thread's dependent chain. A batch's inputs are
// eight (B, CD) tensors and its outputs two, about 0.38 MB at B = 1024,
// CD = 10 (with 0.61 MB of scratch that stays in L2): 0.11 us at 3.35 TB/s. Each thread runs a few thousand dependent
// instructions (the float64 pow(10, x) and float32 exp, log1p and log of
// every candidate among them), and ceil(B / 64) blocks of 64 threads put
// that chain on 16 SMs at B = 1024: about 35 us on the device, some ten
// launches' worth. Smaller blocks would spread it over more SMs, should
// the kernel's time ever matter against the batch's hundreds of ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnsortedKey = 1 << 30;   // an invalid candidate's sort key
constexpr int kWiggle = 5;              // MAPQV_END_ALIGN_WIGGLE
constexpr float kMaxPhred = 254.0f;

// float32 constants of ops/mapqv.py, as the plain version rounds them
constexpr float kInvTen = 0x1.99999ap-4f;           // x / 10.0
constexpr float kLog10 = 0x1.26bb1cp+1f;            // (mn - mx) * LOG10
constexpr float kInvLog10 = 0x1.bcb7b0p-2f;         // x / LOG10
constexpr float kMinusTenInvLn10 = -0x1.15f2d0p+2f; // -10 log10(x) = log(x) * this
constexpr float kGate = 0x1.333334p+0f;             // nMatch * 1.2
constexpr float kMinOverlap = 0.75f;
constexpr float kFlankCharge = -7.5f;               // -0.5 * 15.0
constexpr float kNeg = -0x1.93e594p+99f;            // -1e30, a partition with no member
constexpr float kOneMinusFloor = 0x1.4484c0p-100f;  // 1e-30
constexpr float kMinNormal = 0x1p-126f;

// ---- ops/xla_math.py ----
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < kMinNormal ? __fmul_rn(x, 0.0f) : x;
}

// log: the Cephes polynomial of XLA's CPU backend
__constant__ float kLogP[9] = {0x1.204376p-4f, -0x1.d7a370p-4f, 0x1.de4a34p-4f, -0x1.fcba9ep-4f,
                               0x1.23d37ep-3f, -0x1.555ca0p-3f, 0x1.999d58p-3f, -0x1.fffff8p-3f,
                               0x1.555554p-2f};
constexpr float kLogQ1 = -0x1.bd0106p-13f, kLogQ2 = 0x1.63p-1f, kSqrtHf = 0x1.6a09e6p-1f;

__device__ float xla_log(float x) {
  x = x < kMinNormal ? kMinNormal : x;
  const int bits = __float_as_int(x);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 0x7F), 1.0f);
  float m = __int_as_float((bits & ~0x7F800000) | 0x3F000000);  // in [0.5, 1)
  const bool small = m < kSqrtHf;
  const float tmp = small ? m : 0.0f;
  m = __fsub_rn(m, 1.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  m = __fadd_rn(m, tmp);
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(x2, m);
  float y = __fmaf_rn(__fmaf_rn(m, kLogP[0], kLogP[1]), m, kLogP[2]);
  const float y1 = __fmaf_rn(__fmaf_rn(m, kLogP[3], kLogP[4]), m, kLogP[5]);
  const float y2 = __fmaf_rn(__fmaf_rn(m, kLogP[6], kLogP[7]), m, kLogP[8]);
  y = __fmaf_rn(__fmaf_rn(y, x3, y1), x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(kLogQ1, e));
  m = __fsub_rn(m, __fmul_rn(x2, 0.5f));
  m = __fadd_rn(m, y);
  return __fadd_rn(m, __fmul_rn(kLogQ2, e));
}

// exp: Cephes expf as XLA's CPU backend emits it
constexpr float kExpLo = -0x1.5f3334p+6f, kExpHi = 0x1.633334p+6f;
constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kExpC1 = 0x1.63p-1f, kExpC2 = -0x1.bd0106p-13f;
__constant__ float kExpP[6] = {0x1.a0d2cep-13f, 0x1.6e879cp-10f, 0x1.111210p-7f,
                               0x1.555382p-5f, 0x1.555554p-3f, 0x1p-1f};

__device__ float xla_exp(float x) {
  x = ftz(x);
  x = x < kExpLo ? kExpLo : (x > kExpHi ? kExpHi : x);
  float n = floorf(__fmaf_rn(x, kLog2e, 0.5f));
  n = n < -127.0f ? -127.0f : (n > 127.0f ? 127.0f : n);
  float r = __fmaf_rn(n, -kExpC1, x);
  r = __fmaf_rn(n, -kExpC2, r);
  float p = __fmaf_rn(r, kExpP[0], kExpP[1]);
#pragma unroll
  for (int i = 2; i < 6; ++i) p = __fmaf_rn(p, r, kExpP[i]);
  const float y = __fadd_rn(__fmaf_rn(p, __fmul_rn(r, r), r), 1.0f);
  const float scale = __int_as_float((static_cast<int>(n) + 127) << 23);
  return ftz(__fmul_rn(y, scale));
}

// log1p: a rational approximation below sqrt(2) - 1, log(1 + x) elsewhere
constexpr float kLog1pSmall = 0x1.a8279ap-2f;
__constant__ float kLog1pP[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f, 0x1.de9738p+4f,
                                 0x1.e798ecp+5f, 0x1.c8e75ap+5f, 0x1.40a202p+4f};
__constant__ float kLog1pQ[6] = {0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f,
                                 0x1.351946p+8f, 0x1.b0db14p+7f, 0x1.e0f304p+5f};

__device__ float xla_log1p(float x) {
  x = ftz(x);
  const float big = xla_log(__fadd_rn(x, 1.0f));
  float p = kLog1pP[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) p = __fmaf_rn(p, x, kLog1pP[i]);
  float q = 1.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) q = __fmaf_rn(q, x, kLog1pQ[i]);
  const float x2 = __fmul_rn(x, x);
  const float t = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q));
  const float small = __fadd_rn(x, __fmaf_rn(x2, -0.5f, t));
  return ftz(fabsf(x) < kLog1pSmall ? small : big);
}

// pow(10, y): glibc's powf, whose exp2 runs in float64
constexpr double kLog2Of10 = 0x1.a934f0979b22dp+1;
__constant__ double kExp2Tab[32] = {
    0x1.0000000000000p+0, 0x1.059b0d3158574p+0, 0x1.0b5586cf9890fp+0, 0x1.11301d0125b51p+0,
    0x1.172b83c7d517bp+0, 0x1.1d4873168b9aap+0, 0x1.2387a6e756238p+0, 0x1.29e9df51fdee1p+0,
    0x1.306fe0a31b715p+0, 0x1.371a7373aa9cbp+0, 0x1.3dea64c123422p+0, 0x1.44e086061892dp+0,
    0x1.4bfdad5362a27p+0, 0x1.5342b569d4f82p+0, 0x1.5ab07dd485429p+0, 0x1.6247eb03a5585p+0,
    0x1.6a09e667f3bcdp+0, 0x1.71f75e8ec5f74p+0, 0x1.7a11473eb0187p+0, 0x1.82589994cce13p+0,
    0x1.8ace5422aa0dbp+0, 0x1.93737b0cdc5e5p+0, 0x1.9c49182a3f090p+0, 0x1.a5503b23e255dp+0,
    0x1.ae89f995ad3adp+0, 0x1.b7f76f2fb5e47p+0, 0x1.c199bdd85529cp+0, 0x1.cb720dcef9069p+0,
    0x1.d5818dcfba487p+0, 0x1.dfc97337b9b5fp+0, 0x1.ea4afa2a490dap+0, 0x1.f50765b6e4540p+0};
constexpr double kExp2C0 = 0x1.c6af84b912394p-5, kExp2C1 = 0x1.ebfce50fac4f3p-3,
                 kExp2C2 = 0x1.62e42ff0c52d6p-1;
constexpr double kExp2Shift = 0x1.8p+47;  // rounds to k / 32
constexpr long long kExp2ShiftBits = 0x42e8000000000000LL;

__device__ float xla_pow10(float y) {
  const double xd = __dmul_rn(static_cast<double>(y), kLog2Of10);
  const double kd = __dadd_rn(xd, kExp2Shift);
  const long long k = __double_as_longlong(kd) - kExp2ShiftBits;
  const double r = __dsub_rn(xd, __dsub_rn(kd, kExp2Shift));
  // 2^floor(k / 32), with the plain version's two's-complement wrap
  const double scale = __longlong_as_double(
      static_cast<long long>(static_cast<unsigned long long>((k >> 5) + 1023) << 52));
  const double s = __dmul_rn(kExp2Tab[k & 31], scale);
  const double z = __fma_rn(r, kExp2C0, kExp2C1);
  const double t = __fma_rn(r, kExp2C2, 1.0);
  const float out = __double2float_rn(__dmul_rn(__fma_rn(z, __dmul_rn(r, r), t), s));
  return ftz(xd <= -150.0 ? 0.0f : out);
}

// ---- the per-candidate arrays ----
// int fields: sort key, original index, valid, lo, hi, partition id; per
// partition: interval begin and end, members seen in the interval pass
// (then the partition's size), started in the log-sum pass
enum IntField { kKey, kOrder, kValid, kLo, kHi, kPid, kBeg, kEnd, kCount, kStarted, kIntFields };
// float fields: nMatch, log-probability; per partition: the interval's
// nMatch, the log10 sum, its largest nMatch
enum FloatField { kNm, kPr, kCurS, kDenom, kMaxNm, kFloatFields };

template <typename T>
struct Lanes {
  T* base;
  int cd, stride;
  __device__ __forceinline__ T& operator()(int field, int c) const {
    return base[(field * cd + c) * stride];
  }
};

struct Params {
  const int32_t* scores;     // (B, CD)
  const uint8_t* valid;      // (B, CD) bool
  const int32_t *q_lo, *q_hi, *n_match, *n_mismatch, *n_ins, *n_del;  // (B, CD)
  int32_t* out;              // (B, CD) mapping quality, clamped to [0, 254] and truncated
  float* q_float;            // (B, CD) the float quality before the clamp
  int32_t* scratch;          // (kIntFields + kFloatFields, CD, B) words
  int n_reads, cd;
  int mismatch_prob, ins_cost, del_cost;
};

__device__ __forceinline__ bool overlaps(int ai, int bi, int aj, int bj) {
  if ((ai <= aj && bi >= bj) || (aj <= ai && bj >= bi)) return true;  // containment
  const float ovp = __int2float_rn(max(min(bi, bj) - max(ai, aj), 0));
  const float li = __int2float_rn(max(bi - ai, 1));
  const float lj = __int2float_rn(max(bj - aj, 1));
  return fmaxf(__fdiv_rn(ovp, li), __fdiv_rn(ovp, lj)) > kMinOverlap;
}

__device__ void map_qv_read(const Params& p, int b, const Lanes<int32_t>& I,
                            const Lanes<float>& F) {
  const int CD = p.cd;
  const int row = b * CD;
  // the stable order of the scores, invalid candidates last (insertion sort)
  for (int c = 0; c < CD; ++c) {
    const int key = p.valid[row + c] ? p.scores[row + c] : kUnsortedKey;
    int j = c;
    for (; j > 0 && I(kKey, j - 1) > key; --j) {
      I(kKey, j) = I(kKey, j - 1);
      I(kOrder, j) = I(kOrder, j - 1);
    }
    I(kKey, j) = key;
    I(kOrder, j) = c;
  }
  for (int k = 0; k < CD; ++k) {
    const int c = row + I(kOrder, k);
    I(kValid, k) = p.valid[c] ? 1 : 0;
    I(kLo, k) = p.q_lo[c];
    I(kHi, k) = p.q_hi[c];
    F(kNm, k) = __int2float_rn(p.n_match[c]);
    // the int32 sum wraps as the plain version's tensors do
    const uint32_t cost = static_cast<uint32_t>(p.mismatch_prob) * p.n_mismatch[c] +
                          static_cast<uint32_t>(p.ins_cost) * p.n_ins[c] +
                          static_cast<uint32_t>(p.del_cost) * p.n_del[c];
    F(kPr, k) = __fmul_rn(-__int2float_rn(static_cast<int32_t>(cost)), kInvTen);
    I(kBeg, k) = 0;
    I(kEnd, k) = 0;
    I(kCount, k) = 0;
    I(kStarted, k) = 0;
    F(kCurS, k) = 0.0f;
    F(kDenom, k) = kNeg;
    F(kMaxNm, k) = 0.0f;
  }

  // the greedy partition: each candidate joins the lowest partition of an
  // earlier valid candidate that it overlaps
  I(kPid, 0) = 0;
  for (int i = 1; i < CD; ++i) {
    int best = i;
    const int ai = I(kLo, i), bi = I(kHi, i);
    if (I(kValid, i))
      for (int j = i - 1; j >= 0; --j)
        if (I(kValid, j) && overlaps(ai, bi, I(kLo, j), I(kHi, j))) best = min(best, I(kPid, j));
    I(kPid, i) = best;
  }
  for (int k = 0; k < CD; ++k)
    if (!I(kValid, k)) I(kPid, k) = -1;

  // each partition's interval: its first member, then a wider member
  // whose nMatch * 1.2 reaches the interval's
  for (int m = 0; m < CD; ++m) {
    const int q = I(kPid, m);
    if (q < 0) continue;
    const int lo = I(kLo, m), hi = I(kHi, m);
    const bool wider = hi - lo > I(kEnd, q) - I(kBeg, q);
    const bool gate = __fmul_rn(F(kNm, m), kGate) >= F(kCurS, q);
    if (I(kCount, q) == 0 || (wider && gate)) {
      I(kBeg, q) = lo;
      I(kEnd, q) = hi;
      F(kCurS, q) = F(kNm, m);
    }
    I(kCount, q) += 1;
  }

  // the charge for the flanks of the partition's interval beyond WIGGLE
  for (int k = 0; k < CD; ++k) {
    const int q = min(max(I(kPid, k), 0), CD - 1);
    const int left = I(kLo, k) - I(kBeg, q), right = I(kEnd, q) - I(kHi, k);
    const bool wiggle = left > kWiggle || right > kWiggle;
    const float charge =
        wiggle && I(kValid, k) ? __fmul_rn(kFlankCharge, __int2float_rn(max(left + right, 0)))
                               : 0.0f;
    F(kPr, k) = __fadd_rn(F(kPr, k), charge);
  }

  // each partition's running log10 sum of its members' probabilities
  for (int m = 0; m < CD; ++m) {
    const int q = I(kPid, m);
    if (q < 0) continue;
    const float nm = F(kNm, m), pr = F(kPr, m);
    const bool first = !I(kStarted, q);
    const float maxnm = fmaxf(F(kMaxNm, q), nm);
    F(kMaxNm, q) = maxnm;
    if (first) {
      F(kDenom, q) = pr;
    } else if (__fmul_rn(nm, kGate) >= maxnm) {
      const float denom = F(kDenom, q);
      const float mx = fmaxf(denom, pr), mn = fminf(denom, pr);
      const float lp = xla_log1p(xla_exp(__fmul_rn(__fsub_rn(mn, mx), kLog10)));
      F(kDenom, q) = __fmaf_rn(lp, kInvLog10, mx);
    }
    I(kStarted, q) = 1;
  }

  // Phred of 1 - 10^(pr - denom), back in the caller's order
  for (int k = 0; k < CD; ++k) {
    const int q = min(max(I(kPid, k), 0), CD - 1);
    const float sub = __fsub_rn(F(kPr, k), F(kDenom, q));
    const float one_minus = __fsub_rn(1.0f, xla_pow10(sub));
    float qv = one_minus <= 0.0f
                   ? kMaxPhred
                   : __fmul_rn(xla_log(one_minus < kOneMinusFloor ? kOneMinusFloor : one_minus),
                               kMinusTenInvLn10);
    if (sub < -20.0f) qv = 0.0f;
    if (I(kCount, q) <= 1) qv = kMaxPhred;
    const int c = row + I(kOrder, k);
    p.q_float[c] = qv;
    p.out[c] = __float2int_rz(qv < 0.0f ? 0.0f : (qv > kMaxPhred ? kMaxPhred : qv));
  }
}

__global__ void __launch_bounds__(kThreads) mapqv_kernel(Params p) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= p.n_reads) return;
  const size_t words = static_cast<size_t>(p.cd) * p.n_reads;
  map_qv_read(p, b, Lanes<int32_t>{p.scratch + b, p.cd, p.n_reads},
              Lanes<float>{reinterpret_cast<float*>(p.scratch + kIntFields * words) + b, p.cd,
                           p.n_reads});
}

}  // namespace

// The scratch words the launcher needs for n_reads x cd candidates.
extern "C" long long mapqv_scratch_words(int n_reads, int cd) {
  return static_cast<long long>(kIntFields + kFloatFields) * cd * n_reads;
}

// All (B, CD) arrays contiguous on one device; q_float (B, CD) float32
// receives the quality before its clamp. scratch: mapqv_scratch_words
// int32 words.
extern "C" int mapqv_launch(const void* scores, const void* valid, const void* q_lo,
                            const void* q_hi, const void* n_match, const void* n_mismatch,
                            const void* n_ins, const void* n_del, int mismatch_prob,
                            int ins_cost, int del_cost, void* out, void* q_float, void* scratch,
                            int n_reads, int cd, void* stream) {
  if (n_reads <= 0 || cd <= 0) return 0;
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const int32_t*>(scores),   static_cast<const uint8_t*>(valid),
           static_cast<const int32_t*>(q_lo),     static_cast<const int32_t*>(q_hi),
           static_cast<const int32_t*>(n_match),  static_cast<const int32_t*>(n_mismatch),
           static_cast<const int32_t*>(n_ins),    static_cast<const int32_t*>(n_del),
           static_cast<int32_t*>(out),            static_cast<float*>(q_float),
           static_cast<int32_t*>(scratch),        n_reads, cd, mismatch_prob, ins_cost,
           del_cost};
  const int blocks = (n_reads + kThreads - 1) / kThreads;
  mapqv_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
