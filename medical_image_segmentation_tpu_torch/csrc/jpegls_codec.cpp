// JPEG-LS (ITU-T T.87 / ISO 14495-1, LOCO-I) decoder — C++ fast path.
//
// Port of the pure-Python reference decoder in
// medical_image_segmentation_tpu/data/jpegls.py (the bit-exact oracle;
// parity-tested against it and against libcharls in
// tests/test_data_formats.py). The reference project decodes these DICOM
// transfer syntaxes (1.2.840.10008.1.2.4.80/.81) through pylibjpeg/GDCM
// plugins (reference docker/Dockerfile:34-35).
//
// Scope (same as the oracle): single-component scans and multi-component
// ILV=0. Hardened for untrusted input: every read is bounds-checked, unary
// runs and Golomb k growth are capped, and any malformed structure returns a
// nonzero status (the Python caller then re-decodes with the oracle to raise
// a precise CodecError).
//
// C ABI:
//   jpegls_probe(data, size, &rows, &cols, &ncomp, &precision) -> 0 | err
//   jpegls_decode(data, size, out_u16, out_capacity_elems)     -> 0 | err
//     out layout: (rows, cols, ncomp) row-major, component-last.
//   jpegls_encode(img_u16, rows, cols, ncomp, precision, near,
//                 out, out_capacity, &out_size)                 -> 0 | err
//     lossless/near-lossless encode, BIT-IDENTICAL to the Python encoder
//     (data/jpegls.py::jpeg_ls_encode — same contexts/k/mapping/stuffing);
//     the hot path for building 16-bit (FLAG_U16) MIS stores, where the
//     pure-Python encoder is ~2 orders of magnitude too slow for the 1M
//     ingest (BASELINE.md).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kJ[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,  2,  3,  3,  3,  3,
                        4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};
constexpr int kMinC = -128, kMaxC = 127;

struct Params {
  int maxval, near_, range, bpp, qbpp, limit, reset, t1, t2, t3;
};

static int bit_length(int v) {
  int n = 0;
  while (v > 0) { v >>= 1; ++n; }
  return n;
}

// T.87 A.1 default thresholds (BASIC_T = 3, 7, 21)
static void default_thresholds(int maxval, int near_, int* t1, int* t2, int* t3) {
  auto clampf = [&](int i, int j) { return (i > maxval || i < j) ? j : i; };
  if (maxval >= 128) {
    int factor = ((maxval < 4095 ? maxval : 4095) + 128) / 256;
    *t1 = clampf(factor * (3 - 2) + 2 + 3 * near_, near_ + 1);
    *t2 = clampf(factor * (7 - 3) + 3 + 5 * near_, *t1);
    *t3 = clampf(factor * (21 - 4) + 4 + 7 * near_, *t2);
  } else {
    int factor = 256 / (maxval + 1);
    int a = 3 / factor + 3 * near_;
    *t1 = clampf(a > 2 ? a : 2, near_ + 1);
    int b = 7 / factor + 5 * near_;
    *t2 = clampf(b > 3 ? b : 3, *t1);
    int c = 21 / factor + 7 * near_;
    *t3 = clampf(c > 4 ? c : 4, *t2);
  }
}

static int make_params(int precision, int near_, int maxval, int t1, int t2,
                       int t3, int reset, Params* p) {
  p->maxval = maxval ? maxval : (1 << precision) - 1;
  int near_cap = p->maxval / 2 < 255 ? p->maxval / 2 : 255;
  if (near_ < 0 || near_ > near_cap) return 21;
  p->near_ = near_;
  p->range = (p->maxval + 2 * near_) / (2 * near_ + 1) + 1;
  int bl = bit_length(p->maxval);
  p->bpp = bl > 2 ? bl : 2;
  p->qbpp = bit_length(p->range - 1);
  p->limit = 2 * (p->bpp + (p->bpp > 8 ? p->bpp : 8));
  p->reset = reset ? reset : 64;
  if (t1 && t2 && t3) {
    p->t1 = t1; p->t2 = t2; p->t3 = t3;
  } else {
    default_thresholds(p->maxval, near_, &p->t1, &p->t2, &p->t3);
  }
  if (!(near_ + 1 <= p->t1 && p->t1 <= p->t2 && p->t2 <= p->t3 &&
        p->t3 <= p->maxval))
    return 22;
  return 0;
}

// MSB-first bit reader with JPEG-LS marker-avoidance unstuffing: after an
// 0xFF byte only 7 bits of the next byte are data; 0xFF followed by a byte
// >= 0x80 is a marker → end of scan data (feed zeros thereafter).
//
// Buffered: `acc` holds the next `nbits` undelivered bits in its LOW bits
// (all higher bits zero — the invariant every extraction preserves), so
// multi-bit reads are one shift+mask and unary runs resolve with one clz
// instead of a per-bit loop.
struct BitReader {
  const uint8_t* data;
  int64_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool prev_ff = false;

  BitReader(const uint8_t* d, int64_t size, int64_t start)
      : data(d), n(size), pos(start) {}

  // Top the accumulator up to >= 57 bits (one byte may add only 7).
  void refill() {
    while (nbits <= 56) {
      if (pos >= n) { acc <<= 8; nbits += 8; prev_ff = false; continue; }
      uint8_t b = data[pos];
      if (prev_ff) {
        if (b >= 0x80) { acc <<= 8; nbits += 8; continue; }  // marker: zeros
        ++pos;
        acc = (acc << 7) | (b & 0x7F);
        nbits += 7;
        prev_ff = false;
      } else {
        ++pos;
        acc = (acc << 8) | b;
        nbits += 8;
        prev_ff = (b == 0xFF);
      }
    }
  }

  inline int read_bit() {
    if (nbits == 0) refill();
    --nbits;
    int bit = int((acc >> nbits) & 1);
    acc &= (uint64_t(1) << nbits) - 1;
    return bit;
  }

  inline int64_t read(int k) {
    if (k <= 0) return 0;
    if (nbits < k) refill();
    nbits -= k;
    int64_t v = int64_t(acc >> nbits);
    acc &= (uint64_t(1) << nbits) - 1;
    return v;
  }

  // count 0-bits until the terminating 1; cap guards corrupt streams
  inline int read_unary(int cap, int* err) {
    int c = 0;
    for (;;) {
      if (nbits == 0) refill();
      if (acc == 0) {  // whole window is zeros: swallow it and keep going
        c += nbits;
        nbits = 0;
        if (c > cap) { *err = 23; return 0; }
        continue;
      }
      int top = 63 - __builtin_clzll(acc);  // position of the terminating 1
      c += nbits - 1 - top;
      if (c > cap) { *err = 23; return 0; }
      nbits = top;  // consume through the 1-bit
      acc &= (uint64_t(1) << top) - 1;
      return c;
    }
  }
};

// A.5.3 limited-length Golomb decode of a mapped error value.
//
// Fast path (the regular-mode hot loop): ONE refill guarantees >= 57 live
// bits, so for the overwhelmingly common short codes the unary run AND the
// k remainder bits both sit in the accumulator already — one clz + one
// shift/mask extracts the whole codeword, replacing the per-bit loop +
// second refill-checked read (round-4 pass; ~1.3x on noisy CT content,
// BASELINE.md loader table). Long runs / escape codes / exhausted windows
// fall back to the original exact path with the reader state untouched.
static inline int64_t golomb_decode(BitReader& br, int k, int limit, int qbpp,
                                    int* err) {
  if (br.nbits <= 56) br.refill();
  if (br.acc != 0) {
    const int top = 63 - __builtin_clzll(br.acc);  // terminating 1-bit
    const int high = br.nbits - 1 - top;
    if (high < limit - (qbpp + 1) && top >= k) {
      br.nbits = top - k;  // consume the zeros, the 1, and the k low bits
      const int64_t low = k ? int64_t(br.acc >> br.nbits) & ((int64_t(1) << k) - 1) : 0;
      br.acc &= (uint64_t(1) << br.nbits) - 1;
      return (int64_t(high) << k) | low;
    }
  }
  int high = br.read_unary(limit + 1, err);
  if (*err) return 0;
  if (high < limit - (qbpp + 1))
    return k ? ((int64_t(high) << k) | br.read(k)) : high;
  if (high != limit - (qbpp + 1)) { *err = 24; return 0; }
  return br.read(qbpp) + 1;
}

// A.3.3 gradient quantization to the 9 regions
static inline int quantize_gradient(int d, const Params& p) {
  if (d <= -p.t3) return -4;
  if (d <= -p.t2) return -3;
  if (d <= -p.t1) return -2;
  if (d < -p.near_) return -1;
  if (d <= p.near_) return 0;
  if (d < p.t1) return 1;
  if (d < p.t2) return 2;
  if (d < p.t3) return 3;
  return 4;
}

// Table-driven A.3.3 quantization: gradients are sample differences, so
// d ∈ [-maxval, maxval] — one int8 lookup replaces the 8-branch compare
// chain, which dominates the per-pixel cost on noisy content (<=8 KB for
// 12-bit data, L1-resident).
struct GradientLUT {
  std::vector<int8_t> t;
  const int8_t* base;  // pre-offset pointer: base[d] is valid for ±maxval

  explicit GradientLUT(const Params& p) : t(2 * p.maxval + 1) {
    for (int d = -p.maxval; d <= p.maxval; ++d)
      t[d + p.maxval] = int8_t(quantize_gradient(d, p));
    base = t.data() + p.maxval;
  }
  inline int operator()(int d) const { return base[d]; }
};

// Regular-mode contexts A/B/C/N (365 entries) + run-interruption contexts
struct Contexts {
  int64_t A[365], B[365];
  int C[365], N[365];
  int64_t Ar[2];
  int Nr[2], Nn[2];
  const Params& p;

  explicit Contexts(const Params& params) : p(params) {
    int64_t init_a = (p.range + 32) / 64;
    if (init_a < 2) init_a = 2;
    for (int i = 0; i < 365; ++i) { A[i] = init_a; B[i] = 0; C[i] = 0; N[i] = 1; }
    Ar[0] = Ar[1] = init_a;
    Nr[0] = Nr[1] = 1;
    Nn[0] = Nn[1] = 0;
  }

  // smallest k >= 0 with (n << k) >= a, closed-form via clz:
  // bitlen(a-1) - bitlen(n) is within 1 of the answer (one adjust).
  static inline int k_min_shift(int64_t n, int64_t a, int* err) {
    if (n >= a) return 0;
    int k = (64 - __builtin_clzll(uint64_t(a - 1))) -
            (64 - __builtin_clzll(uint64_t(n)));
    if ((n << k) < a) ++k;
    if (k > 32) { *err = 25; return 0; }
    return k;
  }

  inline int k_regular(int q, int* err) { return k_min_shift(N[q], A[q], err); }

  // A.6.2 variables update + A.6.3 bias computation
  inline void update_regular(int q, int64_t errval) {
    B[q] += errval * (2 * p.near_ + 1);
    A[q] += errval < 0 ? -errval : errval;
    if (N[q] == p.reset) {
      A[q] >>= 1;
      B[q] >>= 1;  // arithmetic shift: rounds toward -inf like Python >>
      N[q] >>= 1;
    }
    N[q] += 1;
    if (B[q] <= -N[q]) {
      B[q] += N[q];
      if (B[q] < 1 - N[q]) B[q] = 1 - N[q];
      if (C[q] > kMinC) C[q] -= 1;
    } else if (B[q] > 0) {
      B[q] -= N[q];
      if (B[q] > 0) B[q] = 0;
      if (C[q] < kMaxC) C[q] += 1;
    }
  }

  inline int k_run(int ritype, int* err) {
    int64_t temp = Ar[ritype] + (ritype ? (Nr[ritype] >> 1) : 0);
    int k = k_min_shift(Nr[ritype], temp, err);
    if (*err) *err = 26;
    return k;
  }

  inline void update_run(int ritype, int64_t errval, int64_t emapped) {
    if (errval < 0) Nn[ritype] += 1;
    Ar[ritype] += (emapped + 1 - ritype) >> 1;
    if (Nr[ritype] == p.reset) {
      Ar[ritype] >>= 1;
      Nr[ritype] >>= 1;
      Nn[ritype] >>= 1;
    }
    Nr[ritype] += 1;
  }
};

// A.4.1 median edge detector prediction
static inline int med(int a, int b, int c) {
  int mx = a > b ? a : b, mn = a < b ? a : b;
  if (c >= mx) return mn;
  if (c <= mn) return mx;
  return a + b - c;
}

static inline int clampv(int64_t v, int maxval) {
  return v < 0 ? 0 : (v > maxval ? maxval : int(v));
}

// A.4.2 / A.8.3 reconstruction wrap + clamp
static inline int fix_reconstructed(int64_t v, const Params& p) {
  int64_t m = int64_t(p.range) * (2 * p.near_ + 1);
  if (v < -p.near_) v += m;
  else if (v > p.maxval + p.near_) v -= m;
  return clampv(v, p.maxval);
}

// Decode one component scan (A.3–A.8) into out (stride elements per pixel).
// `rows` may be a ROW LIMIT below the scan's true height: T.87 context
// adaptation is causal top-to-bottom, so decoding the first `rows` lines of
// a taller scan is bit-identical to a full decode truncated — the windowed
// crop-at-decode lever for JLS (columns can NOT be skipped: every sample
// feeds the left-to-right context chain).
static int decode_scan(BitReader& br, int rows, int cols, const Params& p,
                       uint16_t* out, int stride) {
  Contexts ctx(p);
  const GradientLUT qg(p);
  std::vector<int> prev(cols, 0), prev2(cols, 0), cur(cols, 0);
  int run_index = 0;
  const int near_ = p.near_, maxval = p.maxval, range = p.range;
  int err = 0;

  for (int y = 0; y < rows; ++y) {
    int x = 0;
    while (x < cols) {
      int b = prev[x];
      int d = (x + 1 < cols) ? prev[x + 1] : b;
      int a, c;
      if (x > 0) { a = cur[x - 1]; c = prev[x - 1]; }
      else { a = b; c = (y >= 1) ? prev2[0] : 0; }  // Ra(0)=Rb, Rc(0)=above-Rb
      int d1 = d - b, d2 = b - c, d3 = c - a;
      int ad1 = d1 < 0 ? -d1 : d1, ad2 = d2 < 0 ? -d2 : d2,
          ad3 = d3 < 0 ? -d3 : d3;
      if (ad1 <= near_ && ad2 <= near_ && ad3 <= near_) {
        // ---- run mode (A.7) ----
        int remaining = cols - x;
        int index = 0;
        while (br.read_bit()) {
          int count = 1 << kJ[run_index];
          if (count > remaining - index) count = remaining - index;
          index += count;
          if (count == (1 << kJ[run_index]) && run_index < 31) ++run_index;
          if (index == remaining) break;
        }
        if (index != remaining) {
          if (kJ[run_index] > 0) index += int(br.read(kJ[run_index]));
          if (index >= remaining) return 27;  // run length exceeds line
        }
        for (int i = 0; i < index; ++i) cur[x + i] = a;
        x += index;
        if (index == remaining) continue;  // run hit EOL: no interruption
        // run interruption sample (A.7.2)
        int rb = prev[x];
        int ra = a;  // == RUNval
        int dr = ra - rb;
        int ritype = ((dr < 0 ? -dr : dr) <= near_) ? 1 : 0;
        int k = ctx.k_run(ritype, &err);
        if (err) return err;
        int64_t emapped =
            golomb_decode(br, k, p.limit - kJ[run_index] - 1, p.qbpp, &err);
        if (err) return err;
        int64_t temp = emapped + ritype;
        int mp = int(temp & 1);
        int64_t errabs = (temp + mp) >> 1;
        bool cond = (k != 0 || 2 * ctx.Nn[ritype] >= ctx.Nr[ritype]);
        int64_t errval = ((cond && mp) || (!cond && !mp)) ? -errabs : errabs;
        ctx.update_run(ritype, errval, emapped);
        int rx;
        if (ritype) {
          rx = fix_reconstructed(ra + errval * (2 * near_ + 1), p);
        } else {
          int s = rb > ra ? 1 : -1;
          rx = fix_reconstructed(rb + s * errval * (2 * near_ + 1), p);
        }
        cur[x] = rx;
        ++x;
        if (run_index > 0) --run_index;
        continue;
      }
      // ---- regular mode (A.4–A.6) ----
      int q = 81 * qg(d1) + 9 * qg(d2) + qg(d3);
      int sign = q < 0 ? -1 : 1;
      if (q < 0) q = -q;
      int px = clampv(med(a, b, c) + sign * ctx.C[q], maxval);
      int k = ctx.k_regular(q, &err);
      if (err) return err;
      int64_t merr = golomb_decode(br, k, p.limit, p.qbpp, &err);
      if (err) return err;
      // A.5.2 inverse error mapping (floor division semantics for negatives)
      int64_t errval = (merr >> 1) ^ -(merr & 1);  // zigzag unmap, branchless
      if (k == 0 && near_ == 0 && 2 * ctx.B[q] <= -ctx.N[q])
        errval = -errval - 1;
      if ((errval < 0 ? -errval : errval) > range) return 28;
      ctx.update_regular(q, errval);
      errval *= sign;
      cur[x] = fix_reconstructed(px + errval * (2 * near_ + 1), p);
      ++x;
    }
    for (int i = 0; i < cols; ++i) out[(int64_t(y) * cols + i) * stride] =
        uint16_t(cur[i]);
    std::swap(prev2, prev);
    std::swap(prev, cur);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// marker-segment layer

constexpr uint8_t kSOI = 0xD8, kEOI = 0xD9, kSOF55 = 0xF7, kLSE = 0xF8,
                  kSOS = 0xDA, kDRI = 0xDD;

struct Header {
  int precision = 0, rows = 0, cols = 0, ncomp = 0;
  int lse_maxval = 0, lse_t1 = 0, lse_t2 = 0, lse_t3 = 0, lse_reset = 0;
  int sos_ns = 0, sos_near = 0, sos_ilv = 0;
  int64_t entropy_start = 0;
};

static int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// Parse markers up to (and including) the first SOS
static int parse_header(const uint8_t* data, int64_t n, Header* h) {
  if (n < 4 || data[0] != 0xFF || data[1] != kSOI) return 1;
  int64_t i = 2;
  while (i + 4 <= n) {
    if (data[i] != 0xFF) return 2;
    uint8_t marker = data[i + 1];
    if (marker == 0xFF) { ++i; continue; }  // fill byte
    i += 2;
    if (marker == kSOI || marker == kEOI) return 3;
    int seglen = be16(data + i);
    if (seglen < 2 || i + seglen > n) return 4;
    const uint8_t* seg = data + i + 2;
    int sn = seglen - 2;
    if (marker == kSOF55) {
      if (sn < 6) return 5;
      h->precision = seg[0];
      h->rows = be16(seg + 1);
      h->cols = be16(seg + 3);
      h->ncomp = seg[5];
      if (h->precision < 2 || h->precision > 16) return 6;
      if (h->rows == 0 || h->cols == 0) return 7;  // DNL unsupported
      if (h->ncomp < 1 || h->ncomp > 4) return 8;
    } else if (marker == kLSE) {
      if (sn < 1) return 9;
      if (seg[0] == 1) {
        if (sn < 11) return 9;
        h->lse_maxval = be16(seg + 1);
        h->lse_t1 = be16(seg + 3);
        h->lse_t2 = be16(seg + 5);
        h->lse_t3 = be16(seg + 7);
        h->lse_reset = be16(seg + 9);
      } else if (seg[0] == 2 || seg[0] == 3) {
        return 10;  // mapping tables unsupported
      }
    } else if (marker == kDRI) {
      if (sn >= 2 && be16(seg) != 0) return 11;  // restart intervals unsupported
    } else if (marker == kSOS) {
      if (sn < 1 || sn < 3 + 2 * seg[0]) return 12;
      h->sos_ns = seg[0];
      h->sos_near = seg[1 + 2 * h->sos_ns];
      h->sos_ilv = seg[2 + 2 * h->sos_ns];
      if (h->precision == 0) return 13;
      h->entropy_start = i + seglen;
      return 0;
    }
    i += seglen;
  }
  return 14;  // missing SOF55/SOS
}

// ---------------------------------------------------------------------------
// encoder — exact dual of decode_scan; mirrors data/jpegls.py::_encode_scan
// so the two encoders emit identical bitstreams (tested)

// MSB-first writer with the T.87 stuffing rule: after emitting an 0xFF byte
// the next byte carries only 7 data bits (MSB forced 0).
struct BitWriter {
  std::vector<uint8_t> out;
  uint32_t cur = 0;
  int free_ = 8, cap = 8;

  inline void write_bit(int bit) {
    --free_;
    cur |= uint32_t(bit & 1) << free_;
    if (free_ == 0) {
      out.push_back(uint8_t(cur));
      cap = free_ = (cur == 0xFF) ? 7 : 8;
      cur = 0;
    }
  }

  inline void write(int64_t value, int nbits) {
    while (nbits > 0) {
      int take = nbits < free_ ? nbits : free_;
      uint32_t chunk = uint32_t((value >> (nbits - take)) & ((1 << take) - 1));
      free_ -= take;
      nbits -= take;
      cur |= chunk << free_;
      if (free_ == 0) {
        out.push_back(uint8_t(cur));
        cap = free_ = (cur == 0xFF) ? 7 : 8;
        cur = 0;
      }
    }
  }

  void flush() {
    if (free_ < cap) {
      out.push_back(uint8_t(cur));
      cur = 0;
    } else if (cap == 7) {
      // a dangling 0xFF needs its stuffed-0 byte so it can't pair with the
      // following marker byte
      out.push_back(0);
    }
    free_ = cap = 8;
  }
};

static inline void golomb_encode(BitWriter& bw, int64_t value, int k,
                                 int limit, int qbpp) {
  int64_t high = value >> k;
  if (high < limit - (qbpp + 1)) {
    bw.write(1, int(high) + 1);  // `high` zeros then a 1
    if (k) bw.write(value & ((int64_t(1) << k) - 1), k);
  } else {
    bw.write(1, limit - qbpp);  // limit-qbpp-1 zeros then a 1
    bw.write((value - 1) & ((int64_t(1) << qbpp) - 1), qbpp);
  }
}

// A.4.5 modulo reduction into [-range/2, ceil(range/2)-1]
static inline int64_t mod_range(int64_t errval, int rng) {
  if (errval < 0) errval += rng;
  if (errval >= (rng + 1) / 2) errval -= rng;
  return errval;
}

// Encode one component scan — mirror of decode_scan / Python _encode_scan.
// img points at the component plane with `stride` elements per pixel.
static void encode_scan(BitWriter& bw, const uint16_t* img, int rows, int cols,
                        int stride, const Params& p) {
  Contexts ctx(p);
  const GradientLUT qg(p);
  std::vector<int> prev(cols, 0), prev2(cols, 0), cur(cols, 0);
  int run_index = 0;
  const int near_ = p.near_, maxval = p.maxval, range = p.range;

  for (int y = 0; y < rows; ++y) {
    const uint16_t* line = img + int64_t(y) * cols * stride;
    int x = 0;
    while (x < cols) {
      int b = prev[x];
      int d = (x + 1 < cols) ? prev[x + 1] : b;
      int a, c;
      if (x > 0) { a = cur[x - 1]; c = prev[x - 1]; }
      else { a = b; c = (y >= 1) ? prev2[0] : 0; }
      int d1 = d - b, d2 = b - c, d3 = c - a;
      int ad1 = d1 < 0 ? -d1 : d1, ad2 = d2 < 0 ? -d2 : d2,
          ad3 = d3 < 0 ? -d3 : d3;
      if (ad1 <= near_ && ad2 <= near_ && ad3 <= near_) {
        // ---- run mode (A.7) ----
        const int runval = a;
        const int start = x;
        while (x < cols) {
          int diff = int(line[int64_t(x) * stride]) - runval;
          if ((diff < 0 ? -diff : diff) > near_) break;
          cur[x] = runval;
          ++x;
        }
        int run_length = x - start;
        const bool eol = (x == cols);
        while (run_length >= (1 << kJ[run_index])) {
          bw.write_bit(1);
          run_length -= 1 << kJ[run_index];
          if (run_index < 31) ++run_index;
        }
        if (eol) {
          if (run_length > 0) bw.write_bit(1);
          continue;
        }
        bw.write_bit(0);
        if (kJ[run_index] > 0) bw.write(run_length, kJ[run_index]);
        // run interruption sample (A.7.2)
        const int ix = int(line[int64_t(x) * stride]);
        const int rb = prev[x];
        const int ra = runval;
        const int dr = ra - rb;
        const int ritype = ((dr < 0 ? -dr : dr) <= near_) ? 1 : 0;
        int64_t errval;
        int s;
        if (ritype) {
          errval = ix - ra;
          s = 1;
        } else {
          s = rb > ra ? 1 : -1;
          errval = int64_t(ix - rb) * s;
        }
        if (near_ > 0) {
          if (errval > 0) errval = (near_ + errval) / (2 * near_ + 1);
          else errval = -((near_ - errval) / (2 * near_ + 1));
        }
        int rx;
        if (ritype) rx = fix_reconstructed(ra + errval * (2 * near_ + 1), p);
        else rx = fix_reconstructed(rb + s * errval * (2 * near_ + 1), p);
        errval = mod_range(errval, range);
        int err = 0;
        const int k = ctx.k_run(ritype, &err);
        // k growth is bounded for valid params; err can't fire on encode
        int mp;
        if (k == 0 && errval > 0 && 2 * ctx.Nn[ritype] < ctx.Nr[ritype]) mp = 1;
        else if (errval < 0 && (2 * ctx.Nn[ritype] >= ctx.Nr[ritype] || k != 0)) mp = 1;
        else mp = 0;
        const int64_t emapped = 2 * (errval < 0 ? -errval : errval) - ritype - mp;
        golomb_encode(bw, emapped, k, p.limit - kJ[run_index] - 1, p.qbpp);
        ctx.update_run(ritype, errval, emapped);
        cur[x] = rx;
        ++x;
        if (run_index > 0) --run_index;
        continue;
      }
      // ---- regular mode (A.4–A.6) ----
      int q = 81 * qg(d1) + 9 * qg(d2) + qg(d3);
      const int sign = q < 0 ? -1 : 1;
      if (q < 0) q = -q;
      const int px = clampv(med(a, b, c) + sign * ctx.C[q], maxval);
      const int ix = int(line[int64_t(x) * stride]);
      int64_t errval = int64_t(ix - px) * sign;
      if (near_ > 0) {
        if (errval > 0) errval = (near_ + errval) / (2 * near_ + 1);
        else errval = -((near_ - errval) / (2 * near_ + 1));
      }
      cur[x] = fix_reconstructed(px + sign * errval * (2 * near_ + 1), p);
      errval = mod_range(errval, range);
      int err = 0;
      const int k = ctx.k_regular(q, &err);
      int64_t merr;
      if (k == 0 && near_ == 0 && 2 * ctx.B[q] <= -ctx.N[q])
        merr = errval >= 0 ? 2 * errval + 1 : -2 * (errval + 1);
      else
        merr = errval >= 0 ? 2 * errval : -2 * errval - 1;
      golomb_encode(bw, merr, k, p.limit, p.qbpp);
      ctx.update_regular(q, errval);
      ++x;
    }
    std::swap(prev2, prev);
    std::swap(prev, cur);
  }
}

}  // namespace

extern "C" {

int jpegls_probe(const uint8_t* data, int64_t size, int* rows, int* cols,
                 int* ncomp, int* precision) {
  Header h;
  int rc = parse_header(data, size, &h);
  if (rc) return rc;
  *rows = h.rows;
  *cols = h.cols;
  *ncomp = h.ncomp;
  *precision = h.precision;
  return 0;
}

static int jpegls_decode_impl(const uint8_t* data, int64_t size, uint16_t* out,
                              int64_t out_capacity, int max_rows) {
  Header h;
  int rc = parse_header(data, size, &h);
  if (rc) return rc;
  const int rows_dec =
      (max_rows > 0 && max_rows < h.rows) ? max_rows : h.rows;
  if (int64_t(rows_dec) * h.cols * h.ncomp > out_capacity) return 15;
  int sos_ns = h.sos_ns, sos_near = h.sos_near, sos_ilv = h.sos_ilv;
  int64_t pos = h.entropy_start;
  for (int comp = 0; comp < h.ncomp; ++comp) {
    if (sos_ns != 1 || (h.ncomp > 1 && sos_ilv != 0)) return 16;  // ILV 1/2
    Params p;
    rc = h.lse_maxval
             ? make_params(h.precision, sos_near, h.lse_maxval, h.lse_t1,
                           h.lse_t2, h.lse_t3, h.lse_reset, &p)
             : make_params(h.precision, sos_near, 0, 0, 0, 0, 0, &p);
    if (rc) return rc;
    BitReader br(data, size, pos);
    rc = decode_scan(br, rows_dec, h.cols, p, out + comp, h.ncomp);
    if (rc) return rc;
    if (comp + 1 == h.ncomp) break;
    // Find the next SOS after this scan's entropy data. The buffered reader
    // refills in bulk, so br.pos normally rests one byte PAST the 0xFF of
    // the very marker that terminated the scan (refill leaves pos at the
    // marker's second byte without consuming it) — start the search one
    // byte back. Bit stuffing guarantees FF DA cannot occur inside entropy
    // data (an FF there is always followed by a byte < 0x80), so backing up
    // cannot produce a false match.
    int64_t j = br.pos > pos ? br.pos - 1 : br.pos;
    int64_t nxt = -1;
    while (j + 1 < size) {
      if (data[j] == 0xFF && data[j + 1] == kSOS) { nxt = j; break; }
      ++j;
    }
    if (nxt < 0) return 17;
    if (nxt + 4 > size) return 18;
    int seglen = be16(data + nxt + 2);
    if (seglen < 2 || nxt + 2 + seglen > size) return 18;
    const uint8_t* seg = data + nxt + 4;
    int sn = seglen - 2;
    if (sn < 1 || sn < 3 + 2 * seg[0]) return 19;
    sos_ns = seg[0];
    sos_near = seg[1 + 2 * sos_ns];
    sos_ilv = seg[2 + 2 * sos_ns];
    pos = nxt + 2 + seglen;
  }
  return 0;
}

int jpegls_decode(const uint8_t* data, int64_t size, uint16_t* out,
                  int64_t out_capacity) {
  return jpegls_decode_impl(data, size, out, out_capacity, 0);
}

// Row-limited decode: emit only the first `max_rows` lines of each component
// (full width), bit-identical to a truncated full decode (T.87 contexts are
// causal). Output layout (min(max_rows, rows), cols, ncomp). The loader's
// crop-at-decode path uses this to stop entropy-decoding below the RRC
// windows' union last row (csrc/mis_loader.cpp); columns cannot be skipped —
// see decode_scan.
int jpegls_decode_rows(const uint8_t* data, int64_t size, uint16_t* out,
                       int64_t out_capacity, int max_rows) {
  return jpegls_decode_impl(data, size, out, out_capacity, max_rows);
}

// Encode (rows, cols, ncomp) component-last uint16 samples → a complete
// JPEG-LS stream (SOI/SOF55/per-component SOS+scan/EOI, ILV=0, default
// thresholds) in `out`. Returns 0 and sets *out_size, or a nonzero error:
// 30 bad dims, 31 bad precision/near, 32 sample exceeds precision,
// 33 output buffer too small. Byte-identical to the Python encoder.
int jpegls_encode(const uint16_t* img, int rows, int cols, int ncomp,
                  int precision, int near, uint8_t* out, int64_t out_capacity,
                  int64_t* out_size) {
  if (rows <= 0 || cols <= 0 || rows >= (1 << 16) || cols >= (1 << 16) ||
      ncomp < 1 || ncomp > 4)
    return 30;
  if (precision < 2 || precision > 16) return 31;
  Params p;
  if (make_params(precision, near, 0, 0, 0, 0, 0, &p) != 0) return 31;
  const int64_t n = int64_t(rows) * cols * ncomp;
  for (int64_t i = 0; i < n; ++i)
    if (img[i] > p.maxval) return 32;

  BitWriter bw;
  // SOI + SOF55
  bw.out.reserve(size_t(n / 2 + 64));
  auto push16 = [&](int v) {
    bw.out.push_back(uint8_t(v >> 8));
    bw.out.push_back(uint8_t(v));
  };
  bw.out.push_back(0xFF); bw.out.push_back(kSOI);
  bw.out.push_back(0xFF); bw.out.push_back(kSOF55);
  push16(2 + 6 + 3 * ncomp);
  bw.out.push_back(uint8_t(precision));
  push16(rows);
  push16(cols);
  bw.out.push_back(uint8_t(ncomp));
  for (int c = 0; c < ncomp; ++c) {
    bw.out.push_back(uint8_t(c + 1));
    bw.out.push_back(0x11);
    bw.out.push_back(0);
  }
  for (int c = 0; c < ncomp; ++c) {
    bw.out.push_back(0xFF); bw.out.push_back(kSOS);
    push16(2 + 6);
    bw.out.push_back(1);                 // Ns
    bw.out.push_back(uint8_t(c + 1));    // component id
    bw.out.push_back(0);                 // table selectors
    bw.out.push_back(uint8_t(near));
    bw.out.push_back(0);                 // ILV=0
    bw.out.push_back(0);                 // point transform
    encode_scan(bw, img + c, rows, cols, ncomp, p);
    bw.flush();
  }
  bw.out.push_back(0xFF); bw.out.push_back(kEOI);
  if (int64_t(bw.out.size()) > out_capacity) return 33;
  memcpy(out, bw.out.data(), bw.out.size());
  *out_size = int64_t(bw.out.size());
  return 0;
}

}  // extern "C"
