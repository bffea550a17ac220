// Host helpers of the port in C++: the suffix-array builder (SA-IS), the
// FASTA byte-stream encoder and the move-string unpacker. The port's copy of
// the three functions of blasr_tpu/native/src/blasr_native.cpp that it
// calls; each has a plain numpy version in blasr_tpu_torch/native.py that
// the tests hold it equal to.
//
// Role of the reference's native infrastructure: suffix-array construction
// (common/algorithms/sorting/qsufsort.h, Karkkainen.h — here replaced by a
// from-scratch SA-IS, the linear-time induced-sorting algorithm) and
// FASTA byte-stream encoding (common/FASTAReader.h buffered parse).
//
// Plain C ABI, loaded with ctypes; built with g++ by
// blasr_tpu_torch/ops/_build.py. Index types are templated so genomes of
// 2^31 bases and more use 64-bit positions.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline bool is_lms(const std::vector<bool>& t, int64_t i) {
  return i > 0 && t[i] && !t[i - 1];
}

template <typename C, typename I>
void get_buckets(const C* s, I n, I K, std::vector<I>& bkt, bool end) {
  std::fill(bkt.begin(), bkt.end(), I(0));
  for (I i = 0; i < n; i++) bkt[s[i]]++;
  I sum = 0;
  for (I c = 0; c <= K; c++) {
    sum += bkt[c];
    bkt[c] = end ? sum : sum - bkt[c];
  }
}

template <typename C, typename I>
void induce_l(const std::vector<bool>& t, I* sa, const C* s, I n, I K,
              std::vector<I>& bkt) {
  get_buckets(s, n, K, bkt, false);
  for (I i = 0; i < n; i++) {
    I j = sa[i] - 1;
    if (sa[i] > 0 && !t[j]) sa[bkt[s[j]]++] = j;
  }
}

template <typename C, typename I>
void induce_s(const std::vector<bool>& t, I* sa, const C* s, I n, I K,
              std::vector<I>& bkt) {
  get_buckets(s, n, K, bkt, true);
  for (I i = n - 1; i >= 0; i--) {
    I j = sa[i] - 1;
    if (sa[i] > 0 && t[j]) sa[--bkt[s[j]]] = j;
  }
}

// SA-IS over s[0..n) with unique smallest sentinel at s[n-1] == 0.
template <typename C, typename I>
void sais_main(const C* s, I* sa, I n, I K) {
  std::vector<bool> t(n);
  t[n - 1] = true;
  if (n >= 2) t[n - 2] = false;
  for (I i = n - 3; i >= 0; i--)
    t[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[i + 1]);

  std::vector<I> bkt(K + 1);

  // stage 1: sort LMS substrings by induced sorting
  get_buckets(s, n, K, bkt, true);
  std::fill(sa, sa + n, I(-1));
  for (I i = 1; i < n; i++)
    if (is_lms(t, i)) sa[--bkt[s[i]]] = i;
  induce_l(t, sa, s, n, K, bkt);
  induce_s(t, sa, s, n, K, bkt);

  // compact sorted LMS suffixes into sa[0..n1)
  I n1 = 0;
  for (I i = 0; i < n; i++)
    if (sa[i] > 0 && is_lms(t, sa[i])) sa[n1++] = sa[i];
  std::fill(sa + n1, sa + n, I(-1));

  // name LMS substrings
  I name = 0, prev = -1;
  for (I i = 0; i < n1; i++) {
    I pos = sa[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (I d = 0;; d++) {
        if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(t, pos + d) || is_lms(t, prev + d))) break;
      }
    }
    if (diff) {
      name++;
      prev = pos;
    }
    sa[n1 + pos / 2] = name - 1;
  }
  for (I i = n - 1, j = n - 1; i >= n1; i--)
    if (sa[i] >= 0) sa[j--] = sa[i];

  // stage 2: recurse if names are not yet unique
  I* s1 = sa + n - n1;
  if (name < n1) {
    sais_main<I, I>(s1, sa, n1, name - 1);
  } else {
    for (I i = 0; i < n1; i++) sa[s1[i]] = i;
  }

  // stage 3: induce the full SA from the sorted LMS order
  for (I i = 1, j = 0; i < n; i++)
    if (is_lms(t, i)) s1[j++] = i;           // LMS positions in text order
  for (I i = 0; i < n1; i++) sa[i] = s1[sa[i]];
  std::fill(sa + n1, sa + n, I(-1));
  get_buckets(s, n, K, bkt, true);
  for (I i = n1 - 1; i >= 0; i--) {
    I j = sa[i];
    sa[i] = -1;
    sa[--bkt[s[j]]] = j;
  }
  induce_l(t, sa, s, n, K, bkt);
  induce_s(t, sa, s, n, K, bkt);
}

template <typename I>
int sais_entry(const uint8_t* s, I n, I* sa_out) {
  if (n <= 0) return 0;
  if (n == 1) {
    sa_out[0] = 0;
    return 0;
  }
  // append the virtual sentinel (strictly smallest); shift alphabet by 1
  std::vector<uint8_t> st(static_cast<size_t>(n) + 1);
  uint8_t mx = 0;
  for (I i = 0; i < n; i++) {
    st[i] = static_cast<uint8_t>(s[i] + 1);
    if (st[i] > mx) mx = st[i];
  }
  st[n] = 0;
  std::vector<I> sa(static_cast<size_t>(n) + 1);
  sais_main<uint8_t, I>(st.data(), sa.data(), n + 1, static_cast<I>(mx));
  std::memcpy(sa_out, sa.data() + 1, sizeof(I) * static_cast<size_t>(n));
  return 0;
}

}  // namespace

extern "C" {

// ---- suffix array ----
int bn_sais_i64(const uint8_t* s, int64_t n, int64_t* sa_out) {
  return sais_entry<int64_t>(s, n, sa_out);
}

int bn_sais_i32(const uint8_t* s, int32_t n, int32_t* sa_out) {
  return sais_entry<int32_t>(s, n, sa_out);
}

// ---- sequence encoding: ASCII -> 2-bit codes (4 = N/ambiguous),
// skipping whitespace. Returns the number of codes written.
int64_t bn_encode_strip(const uint8_t* in, int64_t n, uint8_t* out) {
  static uint8_t lut[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) lut[i] = 4;
    lut[(unsigned)'A'] = lut[(unsigned)'a'] = 0;
    lut[(unsigned)'C'] = lut[(unsigned)'c'] = 1;
    lut[(unsigned)'G'] = lut[(unsigned)'g'] = 2;
    lut[(unsigned)'T'] = lut[(unsigned)'t'] = 3;
    lut[(unsigned)'\n'] = lut[(unsigned)'\r'] = lut[(unsigned)' '] =
        lut[(unsigned)'\t'] = 255;
    init = true;
  }
  int64_t m = 0;
  for (int64_t i = 0; i < n; i++) {
    uint8_t c = lut[in[i]];
    if (c != 255) out[m++] = c;
  }
  return m;
}

// ---- batch move unpack: packed END->START -> forward per-op array.
void bn_unpack_moves(const uint8_t* packed, int64_t nops, uint8_t* ops_out) {
  for (int64_t j = 0; j < nops; j++) {
    int op = (packed[j >> 2] >> (2 * (j & 3))) & 3;
    ops_out[nops - 1 - j] = static_cast<uint8_t>(op);
  }
}

}  // extern "C"
