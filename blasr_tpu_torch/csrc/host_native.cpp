// Host helpers of the port in C++: the suffix-array builder (SA-IS), the
// FASTA byte-stream encoder, the move-string unpacker, the SAM record
// fields (the =/X CIGAR of an op array, and CIGAR, SEQ and QUAL in one pass
// over a packed move string) and the dense global aligner that fills the
// gaps between stitched segments of a long query. The port's copy of the functions of
// blasr_tpu/native/src/blasr_native.cpp that it calls; each has a plain
// numpy version in blasr_tpu_torch/native.py that the tests hold it equal
// to. Then the port's own: the -bestn secondary admission's SDP interval
// aligner and the reference anchor list, whose plain versions are
// blasr_tpu_torch/pipeline/secondary_refine.py's.
//
// Role of the reference's native infrastructure: suffix-array construction
// (common/algorithms/sorting/qsufsort.h, Karkkainen.h — here replaced by a
// from-scratch SA-IS, the linear-time induced-sorting algorithm), FASTA
// byte-stream encoding (common/FASTAReader.h buffered parse) and SAM CIGAR
// emission (printers/SAMPrinter.h:120-260 CreateCIGAR), and the
// inter-anchor dense fills (Blasr.cpp:1578-1634 AlignSubstring). The SDP
// interval aligner is SDPAlign (SDPAlign.h) over the sparse chain of
// SparseDynamicProgramming.h; the anchor list is MapBySuffixArray.h's
// maximal-match narrowing and FindMaxInterval.h's RemoveOverlappingAnchors.
//
// Plain C ABI, loaded with ctypes; built with g++ by
// blasr_tpu_torch/ops/_build.py. Index types are templated so genomes of
// 2^31 bases and more use 64-bit positions.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
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

// ---- SAM CIGAR with M split into =/X (SAMPrinter.h AddUngappedOperations
// role): one pass over the forward op array, comparing aligned bases, with
// optional clip runs at both ends. ops values 1=M 2=I 3=D; q/t are code
// arrays in aligned orientation; qpos/tpos are the path-local span starts.
// Writes the ASCII CIGAR into out (capacity out_cap) and returns its
// length, or -1 if out_cap would overflow.
static inline char* emit_run(char* p, char* end, int64_t len, char op) {
  char tmp[24];
  int k = 0;
  if (len <= 0) return p;
  while (len > 0) { tmp[k++] = static_cast<char>('0' + len % 10); len /= 10; }
  if (p + k + 1 > end) return nullptr;
  while (k > 0) *p++ = tmp[--k];
  *p++ = op;
  return p;
}

int64_t bn_xeq_cigar(const uint8_t* ops, int64_t nops, const uint8_t* q,
                     const uint8_t* t, int64_t qpos, int64_t tpos,
                     int64_t pre_clip, int64_t post_clip, char clip_op,
                     char* out, int64_t out_cap) {
  char* p = out;
  char* end = out + out_cap;
  if (pre_clip > 0) {
    p = emit_run(p, end, pre_clip, clip_op);
    if (!p) return -1;
  }
  char cur = 0;
  int64_t run = 0;
  for (int64_t i = 0; i < nops; i++) {
    uint8_t op = ops[i];
    char sym;
    if (op == 2) {
      sym = 'I';
      qpos++;
    } else if (op == 3) {
      sym = 'D';
      tpos++;
    } else {
      sym = (q[qpos] == t[tpos]) ? '=' : 'X';
      qpos++;
      tpos++;
    }
    if (sym == cur) {
      run++;
    } else {
      if (run) {
        p = emit_run(p, end, run, cur);
        if (!p) return -1;
      }
      cur = sym;
      run = 1;
    }
  }
  if (run) {
    p = emit_run(p, end, run, cur);
    if (!p) return -1;
  }
  if (post_clip > 0) {
    p = emit_run(p, end, post_clip, clip_op);
    if (!p) return -1;
  }
  return p - out;
}

// ---- full SAM field assembly for one record (SAMPrinter.h:120-260 CIGAR
// emission + :59-102 clipping modes + SEQ/QUAL orientation,
// Blasr.cpp:1316-1323 RC convention): consumes the 2-bit packed move
// string (END->START order, as the device walk emits it) directly — no
// intermediate ops array — and writes the three expensive record fields
// into one buffer as cigar '\t' seq '\t' qual. fwd_codes/qual are the
// read's FORWARD-orientation arrays; strand==1 reverse-complements
// (reverses) them on the fly. clip_mode: 0 none, 1 soft/subread, 2 hard.
// Returns total bytes or -1 on overflow; lens_out[0..2] get field lengths.
int64_t bn_sam_fields(const uint8_t* packed, int64_t nops, int64_t q_start,
                      int64_t t_start, const uint8_t* fwd_codes,
                      int64_t read_len, const uint8_t* qual,
                      int64_t has_qual, const uint8_t* t_aln, int64_t t_len,
                      int64_t strand, int64_t clip_mode, char clip_op,
                      char* out, int64_t out_cap, int64_t* lens_out) {
  static const char b2a[6] = {'A', 'C', 'G', 'T', 'N', 'N'};
  char* p = out;
  char* end = out + out_cap;
  // aligned-orientation base at query position i
  auto qbase = [&](int64_t i) -> uint8_t {
    if (strand) {
      uint8_t c = fwd_codes[read_len - 1 - i];
      return c < 4 ? static_cast<uint8_t>(3 - c) : c;
    }
    return fwd_codes[i];
  };
  // count query-consuming ops for q_end (packed order is END->START, op
  // j-from-end at bit position 2*(j&3) of byte j>>2; 1=M 2=I 3=D)
  int64_t q_cons = 0;
  for (int64_t j = 0; j < nops; j++) {
    int op = (packed[j >> 2] >> (2 * (j & 3))) & 3;
    if (op != 3) q_cons++;
  }
  const int64_t q_end = q_start + q_cons;
  const int64_t pre = q_start, post = read_len - q_end;
  // ---- CIGAR ----
  if (clip_mode != 0 && pre > 0) {
    p = emit_run(p, end, pre, clip_op);
    if (!p) return -1;
  }
  {
    int64_t qpos = q_start, tpos = t_start;
    char cur = 0;
    int64_t run = 0;
    for (int64_t j = nops - 1; j >= 0; j--) {  // forward op order
      int op = (packed[j >> 2] >> (2 * (j & 3))) & 3;
      char sym;
      if (op == 2) {
        sym = 'I';
        qpos++;
      } else if (op == 3) {
        sym = 'D';
        tpos++;
      } else {
        sym = (tpos < t_len && qbase(qpos) == t_aln[tpos]) ? '=' : 'X';
        qpos++;
        tpos++;
      }
      if (sym == cur) {
        run++;
      } else {
        if (run) {
          p = emit_run(p, end, run, cur);
          if (!p) return -1;
        }
        cur = sym;
        run = 1;
      }
    }
    if (run) {
      p = emit_run(p, end, run, cur);
      if (!p) return -1;
    }
  }
  if (clip_mode != 0 && post > 0) {
    p = emit_run(p, end, post, clip_op);
    if (!p) return -1;
  }
  lens_out[0] = p - out;
  if (p >= end) return -1;
  *p++ = '\t';
  // ---- SEQ (aligned orientation; hard clip slices the aligned span) ----
  const int64_t s_lo = clip_mode == 2 ? q_start : 0;
  const int64_t s_hi = clip_mode == 2 ? q_end : read_len;
  if (p + (s_hi - s_lo) > end) return -1;
  char* seq0 = p;
  for (int64_t i = s_lo; i < s_hi; i++) *p++ = b2a[qbase(i) > 5 ? 5 : qbase(i)];
  lens_out[1] = p - seq0;
  if (p >= end) return -1;
  *p++ = '\t';
  // ---- QUAL (+33, reversed for strand 1, same clip slice) ----
  char* qual0 = p;
  if (!has_qual) {
    if (p >= end) return -1;
    *p++ = '*';
  } else {
    if (p + (s_hi - s_lo) > end) return -1;
    for (int64_t i = s_lo; i < s_hi; i++) {
      uint8_t v = strand ? qual[read_len - 1 - i] : qual[i];
      *p++ = static_cast<char>(v + 33);
    }
  }
  lens_out[2] = p - qual0;
  return p - out;
}

// ---- dense global alignment with traceback (linear gaps, minimization).
// Host-side gap filler for the SDP/piecewise path — the role of the
// reference's inter-anchor AlignSubstring dense fills (Blasr.cpp:1578-1634,
// SWAlign recursion in SDPAlign.h:437-521). Query/target are 0..4 codes.
// Emits START->END ops (1=M 2=I 3=D) into ops_out (capacity qn+tn) and
// returns nops; *score_out gets the global DP score. The caller bounds the
// (qn+1)*(tn+1) matrix.
int64_t bn_global_align(const uint8_t* q, int64_t qn, const uint8_t* t,
                        int64_t tn, int32_t match, int32_t mismatch,
                        int32_t nscore, int32_t ins, int32_t del,
                        uint8_t* ops_out, int32_t* score_out) {
  const int64_t W = tn + 1;
  std::vector<int32_t> H((qn + 1) * W);
  for (int64_t j = 0; j <= tn; j++) H[j] = static_cast<int32_t>(j) * del;
  for (int64_t i = 1; i <= qn; i++) {
    int32_t* row = &H[i * W];
    const int32_t* prev = &H[(i - 1) * W];
    row[0] = static_cast<int32_t>(i) * ins;
    const uint8_t qc = q[i - 1];
    for (int64_t j = 1; j <= tn; j++) {
      const uint8_t tc = t[j - 1];
      int32_t sub = (qc == tc && qc < 4) ? match
                    : (qc >= 4 || tc >= 4) ? nscore
                                           : mismatch;
      int32_t best = prev[j - 1] + sub;
      int32_t up = prev[j] + ins;
      int32_t left = row[j - 1] + del;
      if (up < best) best = up;
      if (left < best) best = left;
      row[j] = best;
    }
  }
  *score_out = H[qn * W + tn];
  // traceback (prefer diag, then up/ins, then left/del — reference KBand
  // convention of favoring matches on ties)
  int64_t i = qn, j = tn;
  std::vector<uint8_t> rev;
  rev.reserve(qn + tn);
  while (i > 0 || j > 0) {
    if (i > 0 && j > 0) {
      const uint8_t qc = q[i - 1], tc = t[j - 1];
      int32_t sub = (qc == tc && qc < 4) ? match
                    : (qc >= 4 || tc >= 4) ? nscore
                                           : mismatch;
      if (H[i * W + j] == H[(i - 1) * W + (j - 1)] + sub) {
        rev.push_back(1);
        i--;
        j--;
        continue;
      }
    }
    if (i > 0 && H[i * W + j] == H[(i - 1) * W + j] + ins) {
      rev.push_back(2);
      i--;
      continue;
    }
    rev.push_back(3);
    j--;
  }
  const int64_t nops = static_cast<int64_t>(rev.size());
  for (int64_t k = 0; k < nops; k++) ops_out[k] = rev[nops - 1 - k];
  return nops;
}

}  // extern "C"

// ---- the -bestn secondary admission (pipeline/secondary_refine.py):
// SDPAlign (Local, detailed) over an interval window and the reference's
// anchor list of one read orientation. Each computes exactly what its plain
// version in secondary_refine.py computes, for every input: the same
// fragment order, the same sweep containers and tie order, the same
// integer and double arithmetic.

namespace {

struct Frag {
  int64_t x, y, length, weight;
  int64_t cost = 0, chain_prev = -1, chain_len = 0, above = -1;
};

struct SdpParams {
  int64_t word, sdp_ins, sdp_del, match, mismatch, n_score, ins, dele;
  double indel_rate;
  int64_t prefix_len, recurse, no_recurse_under, cap;
  int64_t affine, affine_open, affine_extend;
};

using Block = std::array<int64_t, 3>;  // query start, target start, length

// The key of every k-window of s[0..n) and whether it is free of N. Up to
// k = 27 the plain version's base-5 sums of N-free k-mers are distinct for
// distinct k-mers, so a rolling 2-bit key matches the same windows; above
// that its int64 sums wrap, and are computed as such.
void kmer_keys(const uint8_t* s, int64_t n, int64_t k, std::vector<uint64_t>& key,
               std::vector<char>& ok) {
  const int64_t m = n - k + 1;
  key.resize(static_cast<size_t>(m));
  ok.resize(static_cast<size_t>(m));
  if (k <= 27) {
    const uint64_t mask = (uint64_t(1) << (2 * k)) - 1;
    uint64_t acc = 0;
    int64_t last_n = -1;
    for (int64_t i = 0; i < n; i++) {
      acc = ((acc << 2) | (s[i] & 3u)) & mask;
      if (s[i] >= 4) last_n = i;
      if (i >= k - 1) {
        key[i - k + 1] = acc;
        ok[i - k + 1] = last_n < i - k + 1;
      }
    }
    return;
  }
  for (int64_t i = 0; i < m; i++) {
    uint64_t mul = 1, acc = 0;
    bool good = true;
    for (int64_t j = 0; j < k; j++) {
      acc += static_cast<uint64_t>(s[i + j]) * mul;
      good = good && s[i + j] < 4;
      mul *= 5;
    }
    key[i] = acc;
    ok[i] = good;
  }
}

// Exact k-mer matches (StoreMatchingPositions, TupleMatching.h:37-61) as
// (x, y) pairs in the plain version's order: query position ascending,
// target position ascending within it. The target's k-mers go into an
// open-addressing table, each slot the head of its positions' list.
void kmer_matches(const uint8_t* q, int64_t qn, const uint8_t* t, int64_t tn,
                  int64_t k, int64_t q_off, int64_t t_off,
                  std::vector<std::pair<int64_t, int64_t>>& out) {
  out.clear();
  if (qn < k || tn < k) return;
  std::vector<uint64_t> tkey, qkey;
  std::vector<char> tok, qok;
  kmer_keys(t, tn, k, tkey, tok);
  kmer_keys(q, qn, k, qkey, qok);
  const int64_t m = static_cast<int64_t>(tkey.size());
  size_t cap = 16;
  while (cap < 2 * tkey.size()) cap <<= 1;
  const size_t mask = cap - 1;
  std::vector<uint64_t> slot_key(cap);
  std::vector<int64_t> slot_head(cap, -1), next(static_cast<size_t>(m), -1);
  auto slot_of = [&](uint64_t key) {
    uint64_t h = key ^ (key >> 31);
    h *= 0x9e3779b97f4a7c15ULL;
    size_t i = static_cast<size_t>(h >> 20) & mask;
    while (slot_head[i] != -1 && slot_key[i] != key) i = (i + 1) & mask;
    return i;
  };
  for (int64_t i = m - 1; i >= 0; i--) {  // descending, so each list ascends
    if (!tok[i]) continue;
    const size_t sl = slot_of(tkey[i]);
    slot_key[sl] = tkey[i];
    next[i] = slot_head[sl];
    slot_head[sl] = i;
  }
  for (int64_t i = 0; i + k <= qn; i++) {
    if (!qok[i]) continue;
    for (int64_t j = slot_head[slot_of(qkey[i])]; j != -1; j = next[j])
      out.emplace_back(i + q_off, j + t_off);
  }
}

struct FragAt {
  int64_t x, y, length;
};

// _gather_fragments (SDPAlign.h:140-266): small-word matches in the first
// and last prefix_len bases, then word matches; a query position with more
// than cap matches of one set dropped whole; merged by (x, y) stably and
// deduplicated, so a small-word fragment wins over a word one at one (x, y).
void gather_fragments(const uint8_t* q, int64_t qn, const uint8_t* t, int64_t tn,
                      const SdpParams& p, int64_t word, int64_t prefix_len,
                      std::vector<Frag>& frags) {
  const int64_t small = std::min<int64_t>(word, 5);
  std::vector<FragAt> ends, words;  // the small-word sets (x ascending), the word set
  std::vector<std::pair<int64_t, int64_t>> m;
  auto add = [&](std::vector<FragAt>& to, int64_t length) {
    size_t s = 0;
    while (s < m.size()) {
      size_t e = s;
      while (e < m.size() && m[e].first == m[s].first) e++;
      if (!(p.cap && static_cast<int64_t>(e - s) > p.cap))
        for (size_t i = s; i < e; i++) to.push_back({m[i].first, m[i].second, length});
      s = e;
    }
  };
  const int64_t pl_t = std::min(tn, prefix_len), sl_t = std::min(tn - pl_t, prefix_len);
  const int64_t pl_q = std::min(qn, prefix_len), sl_q = std::min(qn - pl_q, prefix_len);
  kmer_matches(q, pl_q, t, pl_t, small, 0, 0, m);
  add(ends, small);
  if (sl_q > 0 && sl_t > 0) {
    kmer_matches(q + qn - sl_q, sl_q, t + tn - sl_t, sl_t, small, qn - sl_q, tn - sl_t, m);
    add(ends, small);
  }
  kmer_matches(q, qn, t, tn, word, 0, 0, m);
  add(words, word);
  std::vector<FragAt> all(ends.size() + words.size());
  std::merge(ends.begin(), ends.end(), words.begin(), words.end(), all.begin(),
             [](const FragAt& a, const FragAt& b) { return a.x != b.x ? a.x < b.x : a.y < b.y; });
  frags.clear();
  frags.reserve(all.size());
  for (const FragAt& g : all)
    if (frags.empty() || frags.back().x != g.x || frags.back().y != g.y)
      frags.push_back(Frag{g.x, g.y, g.length, word});
}

// SDPLongestCommonSubsequence (SparseDynamicProgramming.h:71-322), the
// Baker-Giancarlo sweep of _sdp_chain_local / _sdp_chain_global over
// fragments sorted by (x, y): the column set (retired fragments, per-column
// minima with the suffix invariant) and the sweep set (fragments of the
// last k rows, ordered by diagonal then x) as sorted vectors, as the plain
// version keeps them, and the 'above' neighbour. Returns the chain's
// fragment indices, start to end.
std::vector<int64_t> sdp_chain(std::vector<Frag>& f, int64_t k, int64_t sdp_ins,
                               int64_t sdp_del, int64_t match, bool local) {
  std::vector<int64_t> chain;
  const int64_t n = static_cast<int64_t>(f.size());
  if (n == 0) return chain;
  const int64_t INF = int64_t(1) << 60;
  // StoreAbove: in (y, x) order, the predecessor overlapping in x with a
  // smaller y. A stable counting sort by y of the (x, y) order gives the
  // (y, x) order.
  int64_t y_min = f[0].y, y_max = f[0].y;
  for (const Frag& g : f) {
    y_min = std::min(y_min, g.y);
    y_max = std::max(y_max, g.y);
  }
  std::vector<int64_t> y_start(static_cast<size_t>(y_max - y_min + 2), 0), by_y(n);
  for (const Frag& g : f) y_start[g.y - y_min + 1]++;
  for (size_t i = 1; i < y_start.size(); i++) y_start[i] += y_start[i - 1];
  for (int64_t i = 0; i < n; i++) by_y[y_start[f[i].y - y_min]++] = i;
  for (int64_t i = 1; i < n; i++) {
    const Frag& pf = f[by_y[i - 1]];
    Frag& c = f[by_y[i]];
    if (pf.x <= c.x && c.x < pf.x + pf.length && pf.y < c.y) c.above = by_y[i - 1];
  }
  struct SweepEntry {
    int64_t diag, x, frag;
  };
  struct ColEntry {
    int64_t col, frag;
  };
  auto sweep_less = [](const SweepEntry& e, const std::pair<int64_t, int64_t>& key) {
    return e.diag != key.first ? e.diag < key.first : e.x < key.second;
  };
  auto col_less = [](const ColEntry& e, int64_t col) { return e.col < col; };
  std::vector<SweepEntry> sweep;
  std::vector<ColEntry> cols;
  int64_t best = local ? INF : 0, best_idx = -1;
  int64_t f_sweep = 0, f_trail = 0, rows_hi = f[0].x;
  for (const Frag& g : f) rows_hi = std::max(rows_hi, g.x);
  rows_hi += k + 1;
  auto drift_pen = [&](const Frag& cur, const Frag& pf) {
    const int64_t drift = (cur.x - cur.y) - (pf.x - pf.y);
    return drift > 0 ? drift * sdp_ins : -drift * sdp_del;
  };
  for (int64_t row = f[0].x; row <= rows_hi; row++) {
    const int64_t start_f = f_sweep;
    while (f_sweep < n && f[f_sweep].x == row) {
      Frag& cur = f[f_sweep];
      int64_t cp = INF, cl = INF, ca = INF, cp_prev = -1, cl_prev = -1;
      bool found = false;
      auto ci = std::lower_bound(cols.begin(), cols.end(), cur.y, col_less);
      if (ci != cols.begin()) {  // the greatest column below cur.y
        const int64_t j = (ci - 1)->frag;
        const Frag& pf = f[j];
        const int64_t d = (cur.x + cur.y) - (pf.x + pf.y);
        cp = pf.cost + static_cast<int64_t>(std::sqrt(static_cast<double>(d < 0 ? -d : d))) - k;
        cp_prev = j;
        found = true;
      }
      auto si = std::lower_bound(sweep.begin(), sweep.end(),
                                 std::make_pair(cur.y - cur.x, cur.x), sweep_less);
      if (si != sweep.begin()) {  // the greatest (diagonal, x) below cur's
        const int64_t j = (si - 1)->frag;
        const Frag& pf = f[j];
        cl = pf.cost + std::min<int64_t>((k - (cur.y - pf.y)) * match, 0) + drift_pen(cur, pf);
        cl_prev = j;
        found = true;
      }
      if (cur.above >= 0) {
        const Frag& pf = f[cur.above];
        ca = pf.cost + (k - (cur.y - pf.y)) * match + drift_pen(cur, pf);
        found = true;
      }
      const int64_t mc = std::min(cp, std::min(cl, ca));
      if (found && (!local || mc < 0)) {  // Local: extend only paying chains
        cur.cost = mc - cur.weight;
        cur.chain_prev = mc == cp ? cp_prev : mc == cl ? cl_prev : cur.above;
        cur.chain_len = f[cur.chain_prev].chain_len + 1;
      } else {
        cur.chain_prev = -1;
        cur.cost = (local ? 0 : (cur.x + cur.y) * sdp_del) + k * match - cur.weight;
        cur.chain_len = 1;
      }
      if (local ? cur.cost < best : cur.chain_len > best) {
        best = local ? cur.cost : cur.chain_len;
        best_idx = f_sweep;
      }
      f_sweep++;
    }
    for (int64_t fi = start_f; fi < f_sweep; fi++) {
      const auto key = std::make_pair(f[fi].y - f[fi].x, f[fi].x);
      auto it = std::lower_bound(sweep.begin(), sweep.end(), key, sweep_less);
      if (it != sweep.end() && it->diag == key.first && it->x == key.second) it->frag = fi;
      else sweep.insert(it, SweepEntry{key.first, key.second, fi});
    }
    if (row >= k + 1) {
      const int64_t trail_row = row - k - 1;
      while (f_trail < n && f[f_trail].x < trail_row) f_trail++;
      while (f_trail < n && f[f_trail].x == trail_row) {
        const Frag& tf = f[f_trail];
        auto it = std::lower_bound(cols.begin(), cols.end(), tf.y, col_less);
        const bool member = it != cols.end() && it->col == tf.y;
        // the reference's replacement condition, kept verbatim: an entry is
        // replaced when the EXISTING one scores better
        // (SparseDynamicProgramming.h:259-267)
        if (!member || f[it->frag].cost < tf.cost) {
          if (member) it->frag = f_trail;
          else it = cols.insert(it, ColEntry{tf.y, f_trail});
          // suffix invariant: drop the later columns that cost more
          auto e = it + 1;
          while (e != cols.end() && f[e->frag].cost > tf.cost) ++e;
          cols.erase(it + 1, e);
        }
        const auto key = std::make_pair(tf.y - tf.x, tf.x);
        auto si = std::lower_bound(sweep.begin(), sweep.end(), key, sweep_less);
        if (si != sweep.end() && si->diag == key.first && si->x == key.second) sweep.erase(si);
        f_trail++;
      }
    }
  }
  for (int64_t i = best_idx; i != -1; i = f[i].chain_prev) chain.push_back(i);
  std::reverse(chain.begin(), chain.end());
  return chain;
}

// _chain_to_blocks (SDPAlign.h:298-414): contiguous (x+1, y+1) runs
// condensed, overlaps trimmed against the next block, zero-length blocks
// and 3-sigma off-diagonal outliers dropped.
std::vector<Block> chain_to_blocks(const std::vector<Frag>& f, const std::vector<int64_t>& chain,
                                   double indel_rate) {
  std::vector<Block> blocks;
  const size_t nc = chain.size();
  size_t i = 0;
  while (i < nc) {
    const size_t s = i;
    while (i + 1 < nc && f[chain[i]].x == f[chain[i + 1]].x - 1 &&
           f[chain[i]].y == f[chain[i + 1]].y - 1)
      i++;
    const int64_t qpos = f[chain[s]].x, tpos = f[chain[s]].y;
    blocks.push_back({qpos, tpos, f[chain[i]].x + f[chain[i]].length - qpos});
    i++;
  }
  const size_t nb = blocks.size();
  for (size_t b = 0; b + 1 < nb; b++) {
    if (blocks[b][0] + blocks[b][2] > blocks[b + 1][0]) blocks[b][2] = blocks[b + 1][0] - blocks[b][0];
    if (blocks[b][1] + blocks[b][2] > blocks[b + 1][1]) blocks[b][2] = blocks[b + 1][1] - blocks[b][1];
  }
  std::vector<char> good(nb);
  for (size_t b = 0; b < nb; b++) good[b] = blocks[b][2] > 0;
  auto diag = [&](size_t b) { return blocks[b][1] - blocks[b][0]; };
  for (size_t b = 1; b + 1 < nb; b++) {
    const int64_t prev_diag = std::llabs(diag(b) - diag(b - 1));
    const int64_t prev_dist = std::min(blocks[b][1] - blocks[b - 1][1], blocks[b][0] - blocks[b - 1][0]);
    const int64_t next_diag = std::llabs(diag(b + 1) - diag(b));
    const int64_t next_dist = std::min(blocks[b + 1][1] - blocks[b][1], blocks[b + 1][0] - blocks[b][0]);
    if (static_cast<double>(prev_dist) * indel_rate < static_cast<double>(prev_diag) &&
        static_cast<double>(next_dist) * indel_rate < static_cast<double>(next_diag))
      good[b] = 0;
  }
  std::vector<Block> out;
  for (size_t b = 0; b < nb; b++)
    if (good[b]) out.push_back(blocks[b]);
  return out;
}

inline int64_t sub_cost(uint8_t qc, uint8_t tc, const SdpParams& p) {
  if (qc >= 4 || tc >= 4) return p.n_score;
  return qc == tc ? p.match : p.mismatch;
}

// _sw_global (SWAlign.h Global type): linear gaps, minimising; traceback
// diagonal first on ties, then up; gapless blocks in the region's
// coordinates.
std::vector<Block> sw_global(const uint8_t* q, int64_t nq, const uint8_t* t, int64_t nt,
                             const SdpParams& p) {
  std::vector<Block> blocks;
  if (nq == 0 || nt == 0) return blocks;
  const int64_t W = nt + 1;
  std::vector<int64_t> H((nq + 1) * W);
  for (int64_t j = 0; j <= nt; j++) H[j] = j * p.dele;
  for (int64_t i = 1; i <= nq; i++) {
    H[i * W] = i * p.ins;
    for (int64_t j = 1; j <= nt; j++) {
      const int64_t d = H[(i - 1) * W + j - 1] + sub_cost(q[i - 1], t[j - 1], p);
      const int64_t up = H[(i - 1) * W + j] + p.ins;
      const int64_t left = H[i * W + j - 1] + p.dele;
      H[i * W + j] = std::min(std::min(d, up), left);
    }
  }
  int64_t i = nq, j = nt, cur_len = 0;
  while (i > 0 || j > 0) {
    if (i > 0 && j > 0 &&
        H[i * W + j] == H[(i - 1) * W + j - 1] + sub_cost(q[i - 1], t[j - 1], p)) {
      i--;
      j--;
      cur_len++;
    } else {
      if (cur_len) {
        blocks.push_back({i, j, cur_len});
        cur_len = 0;
      }
      if (i > 0 && H[i * W + j] == H[(i - 1) * W + j] + p.ins) i--;
      else if (j > 0) j--;
      else i--;
    }
  }
  if (cur_len) blocks.push_back({0, 0, cur_len});
  std::reverse(blocks.begin(), blocks.end());
  return blocks;
}

int64_t columns_score(const uint8_t* q, const uint8_t* t, int64_t n, const SdpParams& p) {
  int64_t s = 0;
  for (int64_t c = 0; c < n; c++) s += sub_cost(q[c], t[c], p);
  return s;
}

// _blocks_stats_score (AlignmentUtils.h:466-533 rendering, :61-124 score):
// columns inside blocks; between blocks the common part of the gap pair as
// aligned columns over the last common bases, the rest as one indel run,
// rated affinely at the last column's linear cost.
int64_t blocks_stats_score(const std::vector<Block>& blocks, const uint8_t* q, const uint8_t* t,
                           const SdpParams& p) {
  int64_t score = 0;
  for (const Block& b : blocks) score += columns_score(q + b[0], t + b[1], b[2], p);
  for (size_t b = 0; b + 1 < blocks.size(); b++) {
    const int64_t q0 = blocks[b][0] + blocks[b][2], t0 = blocks[b][1] + blocks[b][2];
    const int64_t qgap = blocks[b + 1][0] - q0, tgap = blocks[b + 1][1] - t0;
    const int64_t common = std::min(qgap, tgap);
    const int64_t q_rem = qgap - common, t_rem = tgap - common, run = q_rem + t_rem;
    if (run > 0) {
      if (p.affine)
        score += std::min(run * (t_rem > 0 ? p.dele : p.ins), p.affine_open + run * p.affine_extend);
      else
        score += q_rem * p.ins + t_rem * p.dele;
    }
    if (common > 0)
      score += columns_score(q + blocks[b + 1][0] - common, t + blocks[b + 1][1] - common, common, p);
  }
  return score;
}

// sdp_interval_align: fragment chain -> blocks -> the gaps between blocks
// filled (global SW under no_recurse_under cells, the recursive global SDP
// with word - 4 above it while recursion is left) -> the stats score.
std::vector<Block> sdp_align(const uint8_t* q, int64_t qn, const uint8_t* t, int64_t tn,
                             const SdpParams& p, int64_t word, int64_t prefix_len,
                             int64_t recurse, bool local, int64_t* score_out) {
  std::vector<Block> full;
  *score_out = 0;
  std::vector<Frag> frags;
  gather_fragments(q, qn, t, tn, p, word, prefix_len, frags);
  if (frags.empty()) return full;
  const std::vector<int64_t> chain = sdp_chain(frags, word, p.sdp_ins, p.sdp_del, p.match, local);
  if (chain.empty()) return full;
  const std::vector<Block> blocks = chain_to_blocks(frags, chain, p.indel_rate);
  if (blocks.empty()) return full;
  const int64_t sub_word = std::max<int64_t>(word - 4, 5);
  int64_t ignored;
  if (!local && blocks[0][0] > 0 && blocks[0][1] > 0) {
    // the pre-chain region of a global alignment (SDPAlign.h:416-478)
    const int64_t fq = blocks[0][0], ft = blocks[0][1];
    if (recurse == 0 && fq * ft < p.no_recurse_under) {
      const std::vector<Block> g = sw_global(q, fq, t, ft, p);
      full.insert(full.end(), g.begin(), g.end());
    } else if (recurse != 0) {
      const std::vector<Block> g =
          sdp_align(q, fq, t, ft, p, sub_word, prefix_len, recurse - 1, false, &ignored);
      full.insert(full.end(), g.begin(), g.end());
    }
  }
  for (size_t b = 0; b + 1 < blocks.size(); b++) {
    full.push_back(blocks[b]);
    const int64_t q0 = blocks[b][0] + blocks[b][2], t0 = blocks[b][1] + blocks[b][2];
    const int64_t ql = blocks[b + 1][0] - q0, tl = blocks[b + 1][1] - t0;
    if (ql > 0 && tl > 0) {
      std::vector<Block> g;
      if (ql * tl < p.no_recurse_under)
        g = sw_global(q + q0, ql, t + t0, tl, p);
      else if (recurse != 0)
        g = sdp_align(q + q0, ql, t + t0, tl, p, sub_word, 0, recurse - 1, false, &ignored);
      for (const Block& blk : g) full.push_back({blk[0] + q0, blk[1] + t0, blk[2]});
    }
  }
  full.push_back(blocks.back());
  *score_out = blocks_stats_score(full, q, t, p);
  return full;
}

// The number of leading positions, at most lim, where a[i] == b[i] and
// a[i] is a base (not N), eight at a time.
int64_t match_run(const uint8_t* a, const uint8_t* b, int64_t lim) {
  int64_t e = 0;
  for (; e + 8 <= lim; e += 8) {
    uint64_t x, y;
    std::memcpy(&x, a + e, 8);
    std::memcpy(&y, b + e, 8);
    // a byte of a from 4 up (N) has a bit of 0xFC set
    const uint64_t stop = (x ^ y) | (x & 0xFCFCFCFCFCFCFCFCULL);
    if (stop) return e + (__builtin_ctzll(stop) >> 3);
  }
  while (e < lim && a[e] == b[e] && a[e] < 4) e++;
  return e;
}

}  // namespace

extern "C" {

// ---- sdp_interval_align (SDPAlign.h, SparseDynamicProgramming.h): the
// -bestn secondary admission's interval alignment. Writes the blocks as
// (query, target, length) int64 triples into blocks_out (room for
// max_blocks) and the score into *score_out; returns the block count, or
// minus it when max_blocks is too small (nothing written then).
int64_t bn_sdp_interval_align(const uint8_t* q, int64_t qn, const uint8_t* t, int64_t tn,
                              int64_t word, int64_t sdp_ins, int64_t sdp_del, int64_t match,
                              int64_t mismatch, int64_t n_score, int64_t ins, int64_t dele,
                              double indel_rate, int64_t prefix_len, int64_t recurse,
                              int64_t no_recurse_under, int64_t cap, int64_t affine,
                              int64_t affine_open, int64_t affine_extend, int64_t local,
                              int64_t* blocks_out, int64_t max_blocks, int64_t* score_out) {
  const SdpParams p{word, sdp_ins, sdp_del, match, mismatch, n_score, ins, dele, indel_rate,
                    prefix_len, recurse, no_recurse_under, cap, affine, affine_open,
                    affine_extend};
  const std::vector<Block> blocks =
      sdp_align(q, qn, t, tn, p, word, prefix_len, recurse, local != 0, score_out);
  const int64_t nb = static_cast<int64_t>(blocks.size());
  if (nb > max_blocks) return -nb;
  for (int64_t b = 0; b < nb; b++)
    for (int c = 0; c < 3; c++) blocks_out[3 * b + c] = blocks[b][c];
  return nb;
}

// ---- reference_anchor_list (MapBySuffixArray.h:100-212,
// FindMaxInterval.h:279-312): per read position the suffix-array hits of
// its k-mer (sa_kmers, at most max_range), each extended past the k-mer up
// to max_ext bases; the hits of the position's maximal extension kept
// (length k + ext - length_deficit at least min_match, at most
// max_anchors_per_position of them, a unique unextended hit backing off);
// then an anchor encompassed by one at the previous target position
// dropped. sa and sa_kmers are int32 or int64 (the *_is64 flags); lut, when
// not NULL, is GenomeIndex.lut()'s table of 2^lut_bits + 1 first rows of each
// key prefix (the key's top lut_bits of its 2k), which narrows each search
// to its prefix's rows (up to k = 31, where keys are not negative). Writes
// (q, t, len) into the three outputs (room for cap) and returns the count,
// or minus it when cap is too small (nothing written then).
int64_t bn_reference_anchor_list(const uint8_t* q, int64_t n, const uint8_t* genome, int64_t G,
                                 const void* sa, int64_t sa_is64, const void* sa_kmers,
                                 int64_t kmers_is64, int64_t nsa, int64_t k, int64_t min_match,
                                 int64_t trim, int64_t max_ext, int64_t max_range,
                                 int64_t max_anchors_per_position, int64_t length_deficit,
                                 const int32_t* lut, int64_t lut_bits,
                                 int64_t* q_out, int64_t* t_out, int64_t* l_out, int64_t cap) {
  auto sa_at = [&](int64_t i) -> int64_t {
    return sa_is64 ? static_cast<const int64_t*>(sa)[i] : static_cast<const int32_t*>(sa)[i];
  };
  auto kmer_at = [&](int64_t i) -> int64_t {
    return kmers_is64 ? static_cast<const int64_t*>(sa_kmers)[i]
                      : static_cast<const int32_t*>(sa_kmers)[i];
  };
  // np.searchsorted(sa_kmers, key, side) over rows [lo, hi)
  auto search = [&](int64_t lo, int64_t hi, int64_t key, bool right) {
    while (lo < hi) {
      const int64_t mid = lo + (hi - lo) / 2;
      const int64_t v = kmer_at(mid);
      if (right ? v <= key : v < key) lo = mid + 1;
      else hi = mid;
    }
    return lo;
  };
  // Each step below runs over every position (or hit) before the next
  // starts, so the table, suffix-array and genome reads of different
  // positions are in flight together.
  const int64_t end_p = std::max<int64_t>(0, std::min(n - trim, n - k + 1));
  // pack_kmers: the big-endian 2-bit key of each window inside the read;
  // a window holding an N is not searched (its rows stay empty)
  std::vector<int64_t> key(end_p), row_lo(end_p, 0), row_hi(end_p, 0);
  std::vector<char> valid(end_p);
  {
    const uint64_t mask = 2 * k >= 64 ? ~uint64_t(0) : (uint64_t(1) << (2 * k)) - 1;
    uint64_t acc = 0;
    int64_t last_n = -1;
    for (int64_t i = 0; i < end_p + k - 1; i++) {
      acc = ((acc << 2) | (q[i] & 3u)) & mask;
      if (q[i] >= 4) last_n = i;
      const int64_t p = i - k + 1;
      if (p < 0) continue;
      key[p] = 2 * k <= 31 ? static_cast<int64_t>(static_cast<int32_t>(acc))
                           : static_cast<int64_t>(acc);
      valid[p] = last_n < p;
    }
  }
  for (int64_t p = 0; p < end_p; p++) {
    if (!valid[p]) continue;
    row_hi[p] = nsa;
    if (lut != nullptr && 2 * k <= 62) {  // the rows of the key's prefix bucket
      const int64_t pref = key[p] >> (2 * k - lut_bits);
      row_lo[p] = lut[pref];
      row_hi[p] = lut[pref + 1];
      __builtin_prefetch(static_cast<const char*>(sa_kmers) +
                         (row_lo[p] << (kmers_is64 ? 3 : 2)));
    }
  }
  for (int64_t p = 0; p < end_p; p++) {
    if (!valid[p]) continue;
    const int64_t lo = search(row_lo[p], row_hi[p], key[p], false);
    row_hi[p] = search(lo, row_hi[p], key[p], true);
    row_lo[p] = lo;
    __builtin_prefetch(static_cast<const char*>(sa) + (lo << (sa_is64 ? 3 : 2)));
  }
  // the hits of every position with 1 to max_range of them, each extended
  // past its k-mer
  std::vector<int64_t> hit_t, ext;
  for (int64_t p = 0; p < end_p; p++) {
    const int64_t cnt = row_hi[p] - row_lo[p];
    if (cnt <= 0 || cnt > max_range) continue;
    for (int64_t r = row_lo[p]; r < row_hi[p]; r++) {
      hit_t.push_back(sa_at(r));
      if (hit_t.back() + k < G) __builtin_prefetch(genome + hit_t.back() + k);
    }
  }
  ext.resize(hit_t.size());
  {
    size_t h = 0;
    for (int64_t p = 0; p < end_p; p++) {
      const int64_t cnt = row_hi[p] - row_lo[p];
      if (cnt <= 0 || cnt > max_range) continue;
      for (int64_t j = 0; j < cnt; j++, h++) {
        const int64_t tpos = hit_t[h];
        const int64_t lim =
            std::max<int64_t>(0, std::min(max_ext, std::min(n - (p + k), G - (tpos + k))));
        ext[h] = match_run(q + p + k, genome + tpos + k, lim);
      }
    }
  }
  // per position, the hits of its maximal extension
  std::vector<int64_t> aq, at, al;
  size_t h0 = 0;
  for (int64_t p = 0; p < end_p; p++) {
    const int64_t cnt = row_hi[p] - row_lo[p];
    if (cnt <= 0 || cnt > max_range) continue;
    const size_t h1 = h0 + static_cast<size_t>(cnt);
    int64_t pmax = 0, n_sel = 0;
    for (size_t h = h0; h < h1; h++) pmax = std::max(pmax, ext[h]);
    for (size_t h = h0; h < h1; h++) n_sel += ext[h] == pmax;
    const int64_t length = k + pmax - length_deficit;
    if (!(length < min_match || n_sel > max_anchors_per_position || (n_sel == 1 && pmax == 0)))
      for (size_t h = h0; h < h1; h++) {
        if (ext[h] != pmax) continue;
        aq.push_back(p);
        at.push_back(hit_t[h]);
        al.push_back(length);
      }
    h0 = h1;
  }
  // RemoveOverlappingAnchors: drop an anchor encompassed in both coordinates
  // by an anchor at the previous target position, found through an
  // open-addressing table of the anchors by target
  const int64_t na = static_cast<int64_t>(aq.size());
  size_t tcap = 16;
  while (tcap < 2 * static_cast<size_t>(na)) tcap <<= 1;
  const size_t tmask = tcap - 1;
  std::vector<int64_t> slot_t(tcap), slot_head(tcap, -1), next(na, -1);
  auto slot_of = [&](int64_t t) {
    size_t i = static_cast<size_t>((static_cast<uint64_t>(t) * 0x9e3779b97f4a7c15ULL) >> 20) & tmask;
    while (slot_head[i] != -1 && slot_t[i] != t) i = (i + 1) & tmask;
    return i;
  };
  for (int64_t i = 0; i < na; i++) {
    const size_t sl = slot_of(at[i]);
    slot_t[sl] = at[i];
    next[i] = slot_head[sl];
    slot_head[sl] = i;
  }
  std::vector<int64_t> keep;
  keep.reserve(na);
  for (int64_t i = 0; i < na; i++) {
    bool drop = false;
    for (int64_t j = slot_head[slot_of(at[i] - 1)]; j != -1 && !drop; j = next[j])
      drop = aq[j] < aq[i] && al[j] + aq[j] >= al[i] + aq[i] && al[j] + at[j] >= al[i] + at[i];
    if (!drop) keep.push_back(i);
  }
  const int64_t nk = static_cast<int64_t>(keep.size());
  if (nk > cap) return -nk;
  for (int64_t c = 0; c < nk; c++) {
    q_out[c] = aq[keep[c]];
    t_out[c] = at[keep[c]];
    l_out[c] = al[keep[c]];
  }
  return nk;
}

}  // extern "C"
