// Baseline JPEG decoder of the MIS store reader: sequential Huffman, 8-bit
// samples, restart intervals, one component (gray) or three (YCbCr at 1x1,
// 2x1, 1x2 or 2x2 chroma sampling in one interleaved scan).
//
// It is the C++ twin of utils/jpeg.py::decode_jpeg_numpy and gives the
// pixels libjpeg-turbo gives the reference reader (csrc/mis_loader.cpp of
// the JAX package, cinfo defaults): the integer "islow" inverse DCT of
// jidctint.c, clamped as its SIMD routes clamp; for RGB output, fancy
// upsampling (jdsample.c) and the fixed-point YCbCr → RGB of jdcolor.c;
// gray output of a YCbCr stream is its Y plane (JCS_GRAYSCALE); a gray
// stream asked for RGB is replicated. Damaged streams are read as libjpeg
// reads them: past the end of the data or at a stray marker the bits are
// zeros and the rest of the restart interval is gray, a bad Huffman code
// decodes as symbol 0 after 17 bits, and restart markers resynchronise as
// jpeg_resync_to_restart does.
//
// Streams it does not carry return a named code (image_codecs.h):
// progressive, arithmetic-coded, lossless or hierarchical frames, samples
// of other than 8 bits, an RGB (not YCbCr) colour space, several scans, or
// a sampling layout other than the above.

#include "image_codecs.h"

#include <algorithm>
#include <cstring>

namespace mis_codecs {
namespace {

// natural (row-major) index of each zigzag position, then 16 guards at 63
// for a run that overshoots (jpeg_natural_order in jutils.c)
const uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K.3 tables, which libjpeg-turbo loads where a stream defines none
// (jstdhuff.c): DC and AC for table 0 (luminance) and table 1 (chrominance)
const uint8_t kDcLumCounts[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrCounts[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumCounts[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumValues[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrCounts[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrValues[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jidctint.c fixed-point constants (CONST_BITS 13, PASS1_BITS 2)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270;
constexpr int32_t F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137;
constexpr int32_t F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// One pass of jpeg_idct_islow over 8 transforms side by side: d[k][l] is
// input k of transform l, o[k][l] its output k, descaled by n bits. The
// lanes are independent, so the compiler runs them as one vector.
inline void idct_pass(const int32_t (*d)[8], int32_t (*o)[8], int n) {
  for (int l = 0; l < 8; ++l) {
    const int32_t z2 = d[2][l], z3 = d[6][l];
    const int32_t z1 = (z2 + z3) * F0_541;
    const int32_t tmp2 = z1 + z3 * -F1_847;
    const int32_t tmp3 = z1 + z2 * F0_765;
    const int32_t tmp0 = (d[0][l] + d[4][l]) * (1 << kConstBits);
    const int32_t tmp1 = (d[0][l] - d[4][l]) * (1 << kConstBits);
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    const int32_t t0 = d[7][l], t1 = d[5][l], t2 = d[3][l], t3 = d[1][l];
    const int32_t z5 = (t0 + t2 + t1 + t3) * F1_175;
    const int32_t y1 = (t0 + t3) * -F0_899, y2 = (t1 + t2) * -F2_562;
    const int32_t y3 = (t0 + t2) * -F1_961 + z5, y4 = (t1 + t3) * -F0_390 + z5;
    const int32_t s0 = t0 * F0_298 + y1 + y3, s1 = t1 * F2_053 + y2 + y4;
    const int32_t s2 = t2 * F3_072 + y2 + y3, s3 = t3 * F1_501 + y1 + y4;
    o[0][l] = descale(tmp10 + s3, n);
    o[7][l] = descale(tmp10 - s3, n);
    o[1][l] = descale(tmp11 + s2, n);
    o[6][l] = descale(tmp11 - s2, n);
    o[2][l] = descale(tmp12 + s1, n);
    o[5][l] = descale(tmp12 - s1, n);
    o[3][l] = descale(tmp13 + s0, n);
    o[4][l] = descale(tmp13 - s0, n);
  }
}

// dequantize + inverse DCT of one block into 8x8 samples at `out`; a
// block without AC coefficients is flat, the value both passes give it
void idct_block(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride, bool has_ac) {
  if (!has_ac) {
    const int32_t ws0 = (int32_t)coef[0] * q[0] * (1 << kPass1Bits);
    const int32_t v = descale(ws0 * (1 << kConstBits), kConstBits + kPass1Bits + 3);
    const uint8_t px = (uint8_t)(std::min(127, std::max(-128, v)) + 128);
    for (int r = 0; r < 8; ++r) std::memset(out + (size_t)r * stride, px, 8);
    return;
  }
  alignas(32) int32_t in[8][8], ws[8][8], wt[8][8], res[8][8];
  for (int i = 0; i < 64; ++i) in[i >> 3][i & 7] = (int32_t)coef[i] * q[i];
  idct_pass(in, ws, kConstBits - kPass1Bits);  // columns: ws[row][column]
  for (int r = 0; r < 8; ++r)
    for (int k = 0; k < 8; ++k) wt[k][r] = ws[r][k];
  idct_pass(wt, res, kConstBits + kPass1Bits + 3);  // rows: res[column][row]
  for (int r = 0; r < 8; ++r) {
    uint8_t* o = out + (size_t)r * stride;
    for (int k = 0; k < 8; ++k) o[k] = (uint8_t)(std::min(127, std::max(-128, res[k][r])) + 128);
  }
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      const int x = i - 128;
      cr_r[i] = (91881 * x + 32768) >> 16;
      cb_b[i] = (116130 * x + 32768) >> 16;
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + 32768;
    }
  }
};
const YccTables kYcc;

}  // namespace

// Entropy-coded bits as libjpeg's bit reader and memory source give them:
// byte stuffing removed, fill bytes skipped, a marker stops the data, and
// past the data the source repeats a fake EOI (FF D9).
struct JpegDecoder::Bits {
  const uint8_t* p;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  int marker = 0;             // libjpeg's unread_marker
  bool insufficient = false;  // zeros were read past the data

  int next_byte() {
    if (pos < n) return p[pos++];
    const int b = ((pos - n) & 1) ? 0xD9 : 0xFF;
    ++pos;
    return b;
  }
  void fill() {
    while (cnt <= 56 && !marker) {
      int c = next_byte();
      if (c == 0xFF) {
        do c = next_byte(); while (c == 0xFF);
        if (c != 0) {
          marker = c;
          break;
        }
        c = 0xFF;
      }
      buf = (buf << 8) | (uint64_t)c;
      cnt += 8;
    }
  }
  // the next 16 bits, zeros past the data
  uint32_t peek16() {
    if (cnt < 16) {
      fill();
      if (cnt < 16) return (uint32_t)((buf << (16 - cnt)) & 0xFFFF);
    }
    return (uint32_t)(buf >> (cnt - 16)) & 0xFFFF;
  }
  void need(int k) {
    if (cnt < k) {
      fill();
      if (cnt < k) {
        insufficient = true;
        buf <<= (k - cnt);
        cnt = k;
      }
    }
  }
  void skip(int k) {
    need(k);
    cnt -= k;
  }
  int get(int k) {
    need(k);
    cnt -= k;
    return (int)((buf >> cnt) & ((1u << k) - 1));
  }
  int next_marker() {  // jdmarker.c next_marker
    for (;;) {
      int c = next_byte();
      while (c != 0xFF) c = next_byte();
      do c = next_byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }
  // jdmarker.c read_restart_marker + jpeg_resync_to_restart
  void restart(int desired) {
    cnt = 0;
    buf = 0;
    int m = marker ? marker : next_marker();
    if (m == 0xD0 + desired) {
      marker = 0;
    } else {
      for (;;) {
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          marker = 0;
          break;
        }
        if (action == 3) {
          marker = m;
          break;
        }
        m = next_marker();
      }
    }
    if (marker == 0) insufficient = false;
  }
};

namespace {

inline int huff_decode(JpegDecoder::Bits& br, const int32_t* maxcode, const int32_t* valoffset,
                       const uint8_t* values, const uint16_t* fast) {
  const uint32_t look = br.peek16();
  const uint16_t e = fast[look >> 7];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  int l = 10;
  while (l <= 16 && (int32_t)(look >> (16 - l)) > maxcode[l]) ++l;
  if (l > 16) {  // no such code: libjpeg takes 17 bits and fakes a zero
    br.skip(16);
    br.skip(1);
    return 0;
  }
  br.skip(l);
  return values[(int)((look >> (16 - l)) + valoffset[l]) & 0xFF];
}

}  // namespace

int JpegDecoder::derive(Huff& t, bool dc) {
  int size[257], code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < t.counts[l]; ++i) size[p++] = l;
  size[p] = 0;
  const int num = p;
  int code = 0, si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1 << si)) return kCorrupt;  // a code of all ones
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.counts[l]) {
      t.valoffset[l] = p - code_of[p];
      p += t.counts[l];
      t.maxcode[l] = code_of[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0xFFFFF;
  t.valoffset[17] = 0;
  std::memset(t.fast, 0, sizeof(t.fast));
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < t.counts[l]; ++i, ++p) {
      int look = code_of[p] << (9 - l);
      for (int k = 1 << (9 - l); k > 0; --k) t.fast[look++] = (uint16_t)((l << 8) | t.values[p]);
    }
  }
  if (dc) {
    for (int i = 0; i < num; ++i)
      if (t.values[i] > 15) return kCorrupt;
    return 0;
  }
  std::memset(t.fast_ac, 0, sizeof(t.fast_ac));
  p = 0;
  for (int l = 1; l <= 10; ++l) {
    for (int i = 0; i < t.counts[l]; ++i, ++p) {
      const int rs = t.values[p], run = rs >> 4, size = rs & 15;
      if (l + size > 10) continue;
      const int base = code_of[p] << (10 - l);
      for (int k = 0; k < (1 << (10 - l)); ++k) {
        const int idx = base + k;
        const int value = size ? extend((idx >> (10 - l - size)) & ((1 << size) - 1), size) : 0;
        t.fast_ac[idx] = (int32_t)((uint32_t)value << 16) | (size << 9) | (run << 5) | (l + size);
      }
    }
  }
  return 0;
}

int JpegDecoder::parse(const uint8_t* data, size_t size) {
  data_ = data;
  size_ = size;
  height_ = width_ = ncomp_ = nscan_ = restart_ = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  for (int i = 0; i < 4; ++i) {
    quant_defined_[i] = false;
    dc_[i].defined = ac_[i].defined = false;
  }
  auto std_table = [](Huff& t, const uint8_t* counts, const uint8_t* values) {
    std::memcpy(t.counts, counts, 17);
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += counts[l];
    std::memset(t.values, 0, 256);
    std::memcpy(t.values, values, n);
    t.defined = true;
  };
  std_table(dc_[0], kDcLumCounts, kDcValues);
  std_table(dc_[1], kDcChrCounts, kDcValues);
  std_table(ac_[0], kAcLumCounts, kAcLumValues);
  std_table(ac_[1], kAcChrCounts, kAcChrValues);

  if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) return kCorrupt;
  size_t pos = 2;
  bool saw_sof = false;
  for (;;) {
    // next_marker: skip garbage, then fill bytes; FF 00 is no marker
    int m = 0;
    for (;;) {
      while (pos < size && data[pos] != 0xFF) ++pos;
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) return kCorrupt;  // the data ended before the scan
      m = data[pos++];
      if (m != 0) break;
    }
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, RSTn: no segment
    if (m == 0xD8 || m == 0xD9) return kCorrupt;         // second SOI; EOI before a scan
    if (pos + 2 > size) return kCorrupt;
    const int length = (data[pos] << 8) | data[pos + 1];
    if (length < 2) return kCorrupt;
    const uint8_t* seg = data + pos + 2;
    int len = length - 2;
    const bool sized = pos + (size_t)length <= size;
    if (m == 0xC0 || m == 0xC1) {  // baseline or extended sequential, Huffman
      if (!sized || saw_sof || len < 6) return kCorrupt;
      saw_sof = true;
      const int prec = seg[0];
      height_ = (seg[1] << 8) | seg[2];
      width_ = (seg[3] << 8) | seg[4];
      ncomp_ = seg[5];
      if (height_ <= 0 || width_ <= 0 || ncomp_ <= 0) return kCorrupt;
      if (len != 6 + ncomp_ * 3) return kCorrupt;
      if (prec != 8) return kJpegPrecision;
      if (ncomp_ != 1 && ncomp_ != 3) return kCorrupt;  // libjpeg converts neither to gray or RGB
      hmax_ = vmax_ = 1;
      for (int c = 0; c < ncomp_; ++c) {
        Component& k = comp_[c];
        k.id = seg[6 + 3 * c];
        k.h = seg[7 + 3 * c] >> 4;
        k.v = seg[7 + 3 * c] & 15;
        k.tq = seg[8 + 3 * c];
        if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return kCorrupt;
        hmax_ = std::max(hmax_, k.h);
        vmax_ = std::max(vmax_, k.v);
      }
    } else if (m == 0xC2) {
      return kJpegProgressive;
    } else if ((m >= 0xC3 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      return kJpegNotHuffman;
    } else if (m == 0xC4) {  // DHT
      if (!sized) return kCorrupt;
      const uint8_t* q = seg;
      while (len > 16) {
        int index = q[0];
        int count = 0;
        for (int l = 1; l <= 16; ++l) count += q[l];
        len -= 17;
        if (count > 256 || count > len) return kCorrupt;
        Huff* t;
        if (index & 0x10) {
          index -= 0x10;
          if (index < 0 || index > 3) return kCorrupt;
          t = &ac_[index];
        } else {
          if (index > 3) return kCorrupt;
          t = &dc_[index];
        }
        t->counts[0] = 0;
        std::memcpy(t->counts + 1, q + 1, 16);
        std::memset(t->values, 0, 256);
        std::memcpy(t->values, q + 17, count);
        t->defined = true;
        q += 17 + count;
        len -= count;
      }
      if (len != 0) return kCorrupt;
    } else if (m == 0xDB) {  // DQT
      if (!sized) return kCorrupt;
      const uint8_t* q = seg;
      while (len > 0) {
        const int prec = q[0] >> 4, n = q[0] & 15;
        ++q;
        --len;
        if (n > 3) return kCorrupt;
        int count = 64;
        uint16_t* table = quant_[n];
        if (len < 64 * (prec ? 2 : 1)) {  // short: the rest stays 1, as jdmarker.c does
          for (int i = 0; i < 64; ++i) table[i] = 1;
          count = prec ? len >> 1 : len;
        }
        for (int i = 0; i < count; ++i) {
          table[kNatural[i]] = prec ? (uint16_t)((q[0] << 8) | q[1]) : q[0];
          q += prec ? 2 : 1;
        }
        len -= count * (prec ? 2 : 1);
        quant_defined_[n] = true;
      }
      if (len != 0) return kCorrupt;
    } else if (m == 0xDD) {  // DRI
      if (!sized || length != 4) return kCorrupt;
      restart_ = (seg[0] << 8) | seg[1];
    } else if (m == 0xE0 || m == 0xEE) {  // APP0 (JFIF), APP14 (Adobe)
      if (m == 0xE0 && len >= 14 && pos + 2 + 14 <= size && std::memcmp(seg, "JFIF", 5) == 0) jfif = true;
      if (m == 0xEE && len >= 12 && pos + 2 + 12 <= size && std::memcmp(seg, "Adobe", 5) == 0) {
        adobe = true;
        adobe_transform = seg[11];
      }
    } else if (m == 0xDA) {  // SOS
      if (!saw_sof) return kCorrupt;
      if (!sized || len < 1) return kCorrupt;
      const int n = seg[0];
      if (len != n * 2 + 4 || n < 1 || n > 4) return kCorrupt;
      for (int i = 0; i < n; ++i) {
        const int id = seg[1 + 2 * i];
        int c = 0;
        while (c < ncomp_ && comp_[c].id != id) ++c;
        if (c == ncomp_) return kCorrupt;
        for (int j = 0; j < i; ++j)
          if (scan_comps_[j] == c) return kCorrupt;
        scan_comps_[i] = c;
        comp_[c].td = seg[2 + 2 * i] >> 4;
        comp_[c].ta = seg[2 + 2 * i] & 15;
      }
      nscan_ = n;
      scan_pos_ = pos + length;
      int blocks = 0;
      for (int i = 0; i < n; ++i) blocks += comp_[scan_comps_[i]].h * comp_[scan_comps_[i]].v;
      if (n > 1 && blocks > 10) return kCorrupt;  // D_MAX_BLOCKS_IN_MCU
      if (n != ncomp_) return kJpegLayout;  // the components in several scans
      if (ncomp_ == 3) {  // jdapimin.c default_decompress_parms
        bool rgb;  // JCS_RGB: by the Adobe marker, or 'R', 'G', 'B' ids
        if (jfif)
          rgb = false;
        else if (adobe)
          rgb = adobe_transform == 0;
        else
          rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
        if (rgb) return kJpegLayout;
      }
      return 0;
    } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC || m == 0xCC) {
      // other APPn, COM, DNL, DAC: skipped
    } else {
      return kCorrupt;  // unknown marker
    }
    pos += length;
  }
}

int JpegDecoder::decode_scan(int last_mcu_row, bool want_color) {
  Bits br{data_, size_, scan_pos_};
  const bool single = ncomp_ == 1;
  const int mcus_x = single ? comp_[0].blocks_w : (width_ + 8 * hmax_ - 1) / (8 * hmax_);
  int restarts_to_go = restart_, next_restart = 0;
  int pred[4] = {0, 0, 0, 0};
  alignas(32) int16_t blk[64];
  for (int my = 0; my <= last_mcu_row; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (restart_) {
        if (restarts_to_go == 0) {
          br.restart(next_restart);
          next_restart = (next_restart + 1) & 7;
          for (int& p : pred) p = 0;
          restarts_to_go = restart_;
        }
        --restarts_to_go;
      }
      const bool skip = br.insufficient;  // out of data: the MCU stays zero (gray)
      for (int i = 0; i < nscan_; ++i) {
        const int ci = scan_comps_[i];
        Component& c = comp_[ci];
        const Huff& dc = dc_[c.td];
        const Huff& ac = ac_[c.ta];
        const int bh = single ? 1 : c.v, bw = single ? 1 : c.h;
        const bool transform = ci == 0 || want_color;
        for (int yy = 0; yy < bh; ++yy) {
          for (int xx = 0; xx < bw; ++xx) {
            std::memset(blk, 0, sizeof(blk));
            bool has_ac = false;
            if (!skip) {
              int s = huff_decode(br, dc.maxcode, dc.valoffset, dc.values, dc.fast);
              if (s) pred[i] += extend(br.get(s), s);
              blk[0] = (int16_t)pred[i];
              for (int k = 1; k < 64; ++k) {
                const int32_t e = ac.fast_ac[br.peek16() >> 6];
                if (e) {  // code and extra bits in one lookahead
                  br.skip(e & 31);
                  const int run = (e >> 5) & 15;
                  if ((e >> 9) & 15) {
                    k += run;
                    blk[kNatural[k]] = (int16_t)(e >> 16);
                    has_ac = true;
                  } else {
                    if (run != 15) break;
                    k += 15;
                  }
                  continue;
                }
                const int rs = huff_decode(br, ac.maxcode, ac.valoffset, ac.values, ac.fast);
                const int r = rs >> 4;
                s = rs & 15;
                if (s) {
                  k += r;
                  blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
                  has_ac = true;
                } else {
                  if (r != 15) break;
                  k += 15;
                }
              }
            }
            const int by = my * bh + yy, bx = mx * bw + xx;
            if (transform && by >= c.need_y0 && by <= c.need_y1 && bx >= c.need_x0 && bx <= c.need_x1) {
              const int stride = c.blocks_w * 8;
              idct_block(blk, quant_[c.tq], c.plane.data() + (size_t)by * 8 * stride + (size_t)bx * 8, stride,
                         has_ac);
            }
          }
        }
      }
    }
  }
  return 0;
}

int JpegDecoder::decode(int want_c, Box box, std::vector<uint8_t>& out) {
  if (want_c != 1 && want_c != 3) return kWrongChannels;
  if (box.y0 < 0 || box.x0 < 0 || box.y1 > height_ || box.x1 > width_ || box.y1 <= box.y0 ||
      box.x1 <= box.x0)
    return kCorrupt;
  const bool color = want_c == 3 && ncomp_ == 3;
  Component& y = comp_[0];
  if (ncomp_ == 3 && (y.h != hmax_ || y.v != vmax_)) return kJpegLayout;  // Y below full size
  int rh[3] = {1, 1, 1}, rv[3] = {1, 1, 1};
  if (color) {
    for (int c = 1; c < 3; ++c) {
      if (hmax_ % comp_[c].h || vmax_ % comp_[c].v) return kJpegLayout;
      rh[c] = hmax_ / comp_[c].h;
      rv[c] = vmax_ / comp_[c].v;
      if (rh[c] > 2 || rv[c] > 2) return kJpegLayout;
    }
  }
  for (int i = 0; i < nscan_; ++i) {
    const Component& c = comp_[scan_comps_[i]];
    if (!quant_defined_[c.tq] || !dc_[c.td].defined || !ac_[c.ta].defined) return kCorrupt;
  }
  for (int i = 0; i < nscan_; ++i) {
    const Component& c = comp_[scan_comps_[i]];
    if (derive(dc_[c.td], true) != 0 || derive(ac_[c.ta], false) != 0) return kCorrupt;
  }
  const int mcus_x = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
  const int mcus_y = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
  int last_row = 0;
  for (int ci = 0; ci < ncomp_; ++ci) {
    Component& c = comp_[ci];
    c.down_w = (width_ * c.h + hmax_ - 1) / hmax_;
    c.down_h = (height_ * c.v + vmax_ - 1) / vmax_;
    if (ncomp_ == 1) {
      c.blocks_w = (c.down_w + 7) / 8;
      c.blocks_h = (c.down_h + 7) / 8;
    } else {
      c.blocks_w = mcus_x * c.h;
      c.blocks_h = mcus_y * c.v;
    }
    c.need_y0 = 0;
    c.need_y1 = -1;
    if (ci > 0 && !color) continue;
    // the samples the box reads, with one of context for the upsampling
    const int mh = rh[ci] > 1, mv = rv[ci] > 1;
    const int sy0 = std::max(0, box.y0 / rv[ci] - mv);
    const int sy1 = std::min(c.down_h - 1, (box.y1 - 1) / rv[ci] + mv);
    const int sx0 = std::max(0, box.x0 / rh[ci] - mh);
    const int sx1 = std::min(c.down_w - 1, (box.x1 - 1) / rh[ci] + mh);
    c.need_y0 = sy0 / 8;
    c.need_y1 = sy1 / 8;
    c.need_x0 = sx0 / 8;
    c.need_x1 = sx1 / 8;
    c.plane.resize((size_t)c.blocks_w * 8 * c.blocks_h * 8);
    last_row = std::max(last_row, ncomp_ == 1 ? c.need_y1 : c.need_y1 / c.v);
  }
  decode_scan(last_row, color);

  const int bh = box.y1 - box.y0, bw = box.x1 - box.x0;
  out.resize((size_t)bh * bw * want_c);
  const int ys = y.blocks_w * 8;
  if (want_c == 1) {
    for (int r = 0; r < bh; ++r)
      std::memcpy(out.data() + (size_t)r * bw, y.plane.data() + (size_t)(box.y0 + r) * ys + box.x0, bw);
    return 0;
  }
  if (!color) {  // gray replicated
    for (int r = 0; r < bh; ++r) {
      const uint8_t* s = y.plane.data() + (size_t)(box.y0 + r) * ys + box.x0;
      uint8_t* o = out.data() + (size_t)r * bw * 3;
      for (int x = 0; x < bw; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = s[x];
    }
    return 0;
  }
  // one chroma sample at output (yy, xx): jdsample.c fancy upsampling
  auto chroma = [&](int ci, int yy, int xx) -> int {
    const Component& c = comp_[ci];
    const int st = c.blocks_w * 8;
    const uint8_t* pl = c.plane.data();
    const int dw = c.down_w, dh = c.down_h;
    if (rh[ci] == 1 && rv[ci] == 1) return pl[(size_t)yy * st + xx];
    if (rv[ci] == 1) {  // h2v1
      const uint8_t* row = pl + (size_t)yy * st;
      const int i = xx >> 1;
      if (dw <= 2) return row[i];
      const int v = row[i];
      if (xx & 1) return i == dw - 1 ? v : (3 * v + row[i + 1] + 2) >> 2;
      return i == 0 ? v : (3 * v + row[i - 1] + 1) >> 2;
    }
    const int j = yy >> 1;
    const int far = (yy & 1) ? std::min(j + 1, dh - 1) : std::max(j - 1, 0);
    const uint8_t* near_row = pl + (size_t)j * st;
    const uint8_t* far_row = pl + (size_t)far * st;
    if (rh[ci] == 1)  // h1v2
      return (3 * near_row[xx] + far_row[xx] + ((yy & 1) ? 2 : 1)) >> 2;
    const int i = xx >> 1;  // h2v2
    if (dw <= 2) return near_row[i];
    auto colsum = [&](int k) { return 3 * near_row[k] + far_row[k]; };
    const int t = colsum(i);
    if (xx & 1) return i == dw - 1 ? (t * 4 + 7) >> 4 : (3 * t + colsum(i + 1) + 7) >> 4;
    return i == 0 ? (t * 4 + 8) >> 4 : (3 * t + colsum(i - 1) + 8) >> 4;
  };
  for (int r = 0; r < bh; ++r) {
    const int yy = box.y0 + r;
    const uint8_t* s = y.plane.data() + (size_t)yy * ys;
    uint8_t* o = out.data() + (size_t)r * bw * 3;
    for (int x = 0; x < bw; ++x) {
      const int xx = box.x0 + x;
      const int lum = s[xx], cb = chroma(1, yy, xx), cr = chroma(2, yy, xx);
      o[3 * x] = clamp255(lum + kYcc.cr_r[cr]);
      o[3 * x + 1] = clamp255(lum + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(lum + kYcc.cb_b[cb]);
    }
  }
  return 0;
}

}  // namespace mis_codecs
