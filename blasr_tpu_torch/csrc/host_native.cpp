// Host helpers of the port in C++: the suffix-array builder (SA-IS), the
// FASTA byte-stream encoder, the move-string unpacker, the SAM record
// fields (the =/X CIGAR of an op array, and CIGAR, SEQ and QUAL in one pass
// over a packed move string) and the dense global aligner that fills the
// gaps between stitched segments of a long query. The port's copy of the functions of
// blasr_tpu/native/src/blasr_native.cpp that it calls; each has a plain
// numpy version in blasr_tpu_torch/native.py that the tests hold it equal
// to.
//
// Role of the reference's native infrastructure: suffix-array construction
// (common/algorithms/sorting/qsufsort.h, Karkkainen.h — here replaced by a
// from-scratch SA-IS, the linear-time induced-sorting algorithm), FASTA
// byte-stream encoding (common/FASTAReader.h buffered parse) and SAM CIGAR
// emission (printers/SAMPrinter.h:120-260 CreateCIGAR), and the
// inter-anchor dense fills (Blasr.cpp:1578-1634 AlignSubstring).
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
