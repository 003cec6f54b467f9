// PNG decoder of the MIS store reader, on its own inflate (RFC 1950/1951:
// stored, fixed- and dynamic-Huffman blocks, the Adler-32 checked) and CRC
// (no zlib, no libpng).
//
// decode_png gives the pixels the reference reader gets from libpng with
// these calls (csrc/mis_loader.cpp of the JAX package): png_set_strip_16,
// png_set_palette_to_rgb, png_set_expand_gray_1_2_4_to_8,
// png_set_tRNS_to_alpha, png_set_strip_alpha, and png_set_gray_to_rgb or
// png_set_rgb_to_gray(png, 1, -1, -1), then png_read_image (Adam7 passes
// put in place). RGB → gray is libpng's fixed point with its default
// coefficients (6968, 23434, 2366 of 32768): truncated where the file
// states no gamma; through libpng's gamma tables where a gAMA or sRGB chunk
// states one (8-bit samples). Colour management it does not carry (cHRM, or
// a stated gamma on 16-bit RGB read as gray) returns kPngColorSpace.
//
// Errors are libpng's: a bad signature, IHDR, CRC of a critical chunk,
// filter type, zlib stream or Adler-32, too little image data, or data
// that ends early give kCorrupt; an ancillary chunk with a bad CRC is
// dropped.

#include "image_codecs.h"

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>

namespace mis_codecs {
namespace {

// ---------------------------------------------------------------------------
// CRC-32 and Adler-32
// ---------------------------------------------------------------------------

struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
const CrcTable kCrc;

uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = kCrc.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n > 0) {
    const size_t k = std::min<size_t>(n, 5552);
    for (size_t i = 0; i < k; ++i) {
      a += p[i];
      b += a;
    }
    a %= 65521;
    b %= 65521;
    p += k;
    n -= k;
  }
  return (b << 16) | a;
}

inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

// ---------------------------------------------------------------------------
// inflate
// ---------------------------------------------------------------------------

struct InBits {
  const uint8_t* p;
  size_t n, pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  bool need(int k) {
    while (cnt < k) {
      if (pos >= n) return false;
      buf |= (uint64_t)p[pos++] << cnt;
      cnt += 8;
    }
    return true;
  }
  // k bits, or -1 past the end
  int get(int k) {
    if (!need(k)) return -1;
    const int v = (int)(buf & ((1ull << k) - 1));
    buf >>= k;
    cnt -= k;
    return v;
  }
};

constexpr int kMaxBits = 15;
constexpr int kFastBits = 9;

struct Huffman {
  int16_t count[kMaxBits + 1];
  int16_t symbol[320];
  uint16_t fast[1 << kFastBits];  // (symbol << 4) | length, 0 = longer code
};

// canonical code from lengths (puff's construct, zlib's inflate_table
// checks): 0 or an error for an over-subscribed or not allowed incomplete set
int build(Huffman& h, const uint8_t* length, int n, bool code_lengths) {
  std::memset(h.count, 0, sizeof(h.count));
  for (int s = 0; s < n; ++s) h.count[length[s]]++;
  int max = kMaxBits;
  while (max >= 1 && h.count[max] == 0) --max;
  int left = 1;
  for (int len = 1; len <= kMaxBits; ++len) {
    left <<= 1;
    left -= h.count[len];
    if (left < 0) return kCorrupt;
  }
  if (max > 0 && left > 0 && (code_lengths || max != 1)) return kCorrupt;
  int16_t offs[kMaxBits + 2];
  offs[1] = 0;
  for (int len = 1; len < kMaxBits; ++len) offs[len + 1] = offs[len] + h.count[len];
  for (int s = 0; s < n; ++s)
    if (length[s]) h.symbol[offs[length[s]]++] = (int16_t)s;
  // fast table: codes of up to kFastBits, bit-reversed (streams are LSB first)
  std::memset(h.fast, 0, sizeof(h.fast));
  int code = 0, index = 0;
  for (int len = 1; len <= kMaxBits; ++len) {
    for (int i = 0; i < h.count[len]; ++i, ++code, ++index) {
      if (len > kFastBits) continue;
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (int f = rev; f < (1 << kFastBits); f += 1 << len)
        h.fast[f] = (uint16_t)((h.symbol[index] << 4) | len);
    }
    code <<= 1;
  }
  return 0;
}

// one symbol, or a negative code (no such code, or past the end)
int decode_sym(InBits& in, const Huffman& h) {
  if (in.need(kFastBits)) {
    const uint16_t e = h.fast[in.buf & ((1u << kFastBits) - 1)];
    if (e) {
      in.buf >>= (e & 15);
      in.cnt -= (e & 15);
      return e >> 4;
    }
  }
  int code = 0, first = 0, index = 0;
  for (int len = 1; len <= kMaxBits; ++len) {
    const int b = in.get(1);
    if (b < 0) return kCorrupt;
    code |= b;
    const int count = h.count[len];
    if (code - count < first) return h.symbol[index + (code - first)];
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  return kCorrupt;
}

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,   2,   3,   4,   5,   7,    9,    13,   17,   25,
                                33,  49,  65,  97,  129, 193,  257,  385,  513,  769,
                                1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

int codes(InBits& in, std::vector<uint8_t>& out, const Huffman& lit, const Huffman& dist, size_t cap) {
  for (;;) {
    int s = decode_sym(in, lit);
    if (s < 0) return kCorrupt;
    if (s < 256) {
      if (out.size() >= cap) return kCorrupt;
      out.push_back((uint8_t)s);
      continue;
    }
    if (s == 256) return 0;
    s -= 257;
    if (s >= 29) return kCorrupt;  // literal/length symbols 286, 287
    int e = in.get(kLenExtra[s]);
    if (e < 0) return kCorrupt;
    const size_t len = kLenBase[s] + e;
    const int ds = decode_sym(in, dist);
    if (ds < 0 || ds >= 30) return kCorrupt;
    e = in.get(kDistExtra[ds]);
    if (e < 0) return kCorrupt;
    const size_t d = kDistBase[ds] + (size_t)e;
    if (d > out.size() || out.size() + len > cap) return kCorrupt;
    const size_t from = out.size() - d;
    for (size_t i = 0; i < len; ++i) out.push_back(out[from + i]);
  }
}

// RFC 1950 stream → out (at most cap bytes); *used = the bytes it took
int inflate_zlib(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t cap, size_t* used) {
  if (n < 2) return kCorrupt;
  const int cmf = p[0], flg = p[1];
  if ((cmf * 256 + flg) % 31 || (cmf & 15) != 8 || (cmf >> 4) > 7 || (flg & 0x20)) return kCorrupt;
  InBits in{p + 2, n - 2};
  out.clear();
  out.reserve(cap);
  int last = 0;
  static Huffman fixed_lit, fixed_dist;
  static const bool fixed_built = [] {
    uint8_t l[288];
    for (int i = 0; i < 288; ++i) l[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    build(fixed_lit, l, 288, false);
    uint8_t d[32];
    for (int i = 0; i < 32; ++i) d[i] = 5;
    build(fixed_dist, d, 32, false);
    return true;
  }();
  (void)fixed_built;
  Huffman lit, dist;
  while (!last) {
    last = in.get(1);
    const int type = in.get(2);
    if (last < 0 || type < 0) return kCorrupt;
    if (type == 0) {  // stored
      in.buf >>= (in.cnt & 7);
      in.cnt -= in.cnt & 7;
      const int len = in.get(16), nlen = in.get(16);
      if (len < 0 || nlen < 0 || len != (~nlen & 0xFFFF)) return kCorrupt;
      if (out.size() + len > cap) return kCorrupt;
      for (int i = 0; i < len; ++i) {  // whole bytes: from the bit buffer, then the input
        int b = in.get(8);
        if (b < 0) return kCorrupt;
        out.push_back((uint8_t)b);
      }
    } else if (type == 1) {
      if (codes(in, out, fixed_lit, fixed_dist, cap)) return kCorrupt;
    } else if (type == 2) {
      const int nlen = in.get(5), ndist = in.get(5), ncode = in.get(4);
      if (nlen < 0 || ndist < 0 || ncode < 0) return kCorrupt;
      const int hlit = nlen + 257, hdist = ndist + 1, hclen = ncode + 4;
      if (hlit > 286 || hdist > 30) return kCorrupt;
      static const uint8_t order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
      uint8_t lengths[320] = {};
      for (int i = 0; i < hclen; ++i) {
        const int v = in.get(3);
        if (v < 0) return kCorrupt;
        lengths[order[i]] = (uint8_t)v;
      }
      Huffman lencode;
      if (build(lencode, lengths, 19, true)) return kCorrupt;
      int idx = 0;
      std::memset(lengths, 0, sizeof(lengths));
      while (idx < hlit + hdist) {
        int sym = decode_sym(in, lencode);
        if (sym < 0) return kCorrupt;
        if (sym < 16) {
          lengths[idx++] = (uint8_t)sym;
          continue;
        }
        int rep, val = 0;
        if (sym == 16) {
          if (idx == 0) return kCorrupt;
          val = lengths[idx - 1];
          rep = in.get(2);
          if (rep < 0) return kCorrupt;
          rep += 3;
        } else if (sym == 17) {
          rep = in.get(3);
          if (rep < 0) return kCorrupt;
          rep += 3;
        } else {
          rep = in.get(7);
          if (rep < 0) return kCorrupt;
          rep += 11;
        }
        if (idx + rep > hlit + hdist) return kCorrupt;
        while (rep--) lengths[idx++] = (uint8_t)val;
      }
      if (lengths[256] == 0) return kCorrupt;  // no end-of-block code
      if (build(lit, lengths, hlit, false) || build(dist, lengths + hlit, hdist, false)) return kCorrupt;
      if (codes(in, out, lit, dist, cap)) return kCorrupt;
    } else {
      return kCorrupt;
    }
  }
  in.buf >>= (in.cnt & 7);  // the Adler-32 starts on a byte
  in.cnt -= in.cnt & 7;
  uint32_t check = 0;
  for (int i = 0; i < 4; ++i) {
    const int b = in.get(8);
    if (b < 0) return kCorrupt;
    check = (check << 8) | (uint32_t)b;
  }
  if (check != adler32(out.data(), out.size())) return kCorrupt;
  *used = 2 + in.pos - (size_t)(in.cnt / 8);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

struct Png {
  uint32_t width = 0, height = 0;
  int depth = 0, ctype = 0, interlace = 0;
  uint8_t palette[256][3] = {};
  bool have_plte = false;
  int gamma = 0;  // the file's gamma (PNG fixed point), 0 = none stated
  bool srgb = false, chrm = false;
  std::vector<uint8_t> raw;  // inflated, filtered rows
};

inline bool critical(const uint8_t* type) { return (type[0] & 0x20) == 0; }

int channels_of(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

bool valid_depth(int ctype, int depth) {
  switch (ctype) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2:
    case 4:
    case 6: return depth == 8 || depth == 16;
  }
  return false;
}

// Adam7 passes: (row start, column start, row step, column step)
const int kAdam7[7][4] = {{0, 0, 8, 8}, {0, 4, 8, 8}, {4, 0, 8, 4}, {0, 2, 4, 4},
                          {2, 0, 4, 2}, {0, 1, 2, 2}, {1, 0, 2, 1}};

size_t row_bytes(uint32_t w, int ch, int depth) { return ((size_t)w * ch * depth + 7) / 8; }

// the chunks before the image data (png_read_info): header fields, palette
// and colour chunks; *idat = the offset of the first IDAT chunk
int read_info(const uint8_t* d, size_t n, Png& png, size_t* idat) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (n < 8 || std::memcmp(d, sig, 8) != 0) return kCorrupt;
  size_t pos = 8;
  bool first = true;
  for (;;) {
    if (pos + 8 > n) return kCorrupt;
    const uint32_t len = be32(d + pos);
    const uint8_t* type = d + pos + 4;
    if (len > 0x7FFFFFFFu) return kCorrupt;
    for (int i = 0; i < 4; ++i)
      if (!((type[i] >= 'A' && type[i] <= 'Z') || (type[i] >= 'a' && type[i] <= 'z'))) return kCorrupt;
    if (first && std::memcmp(type, "IHDR", 4) != 0) return kCorrupt;
    first = false;
    if (std::memcmp(type, "IDAT", 4) == 0) break;
    if (pos + 12 + (size_t)len > n) return kCorrupt;  // read past the end
    const uint8_t* body = d + pos + 8;
    const bool crc_ok = crc32(d + pos + 4, 4 + (size_t)len) == be32(body + len);
    pos += 12 + (size_t)len;
    if (!crc_ok) {
      if (critical(type)) return kCorrupt;
      continue;  // an ancillary chunk with a bad CRC is dropped
    }
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len != 13 || png.width) return kCorrupt;
      png.width = be32(body);
      png.height = be32(body + 4);
      png.depth = body[8];
      png.ctype = body[9];
      png.interlace = body[12];
      if (png.width == 0 || png.height == 0 || png.width > 1000000 || png.height > 1000000) return kCorrupt;
      if (!valid_depth(png.ctype, png.depth) || body[10] != 0 || body[11] != 0 || png.interlace > 1)
        return kCorrupt;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (png.have_plte) return kCorrupt;
      if (len > 768 || len % 3) {
        if (png.ctype == 3) return kCorrupt;
        continue;
      }
      if (!(png.ctype & 2)) continue;  // ignored in a gray PNG
      const int max = png.ctype == 3 ? 1 << png.depth : 256;
      const int num = std::min<int>(len / 3, max);
      std::memcpy(png.palette, body, (size_t)num * 3);  // the rest stays black
      png.have_plte = true;
    } else if (std::memcmp(type, "gAMA", 4) == 0) {
      if (len == 4 && !png.have_plte) {
        const uint32_t g = be32(body);
        if (g > 0 && g <= 0x7FFFFFFFu && !png.srgb) png.gamma = (int)g;
      }
    } else if (std::memcmp(type, "sRGB", 4) == 0) {
      if (len == 1 && !png.have_plte) {
        png.srgb = true;
        png.gamma = 45455;
      }
    } else if (std::memcmp(type, "cHRM", 4) == 0) {
      if (len == 32 && !png.have_plte) png.chrm = true;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      return kCorrupt;  // no image data
    } else if (critical(type)) {
      return kCorrupt;  // an unknown critical chunk
    }
  }
  if (png.ctype == 3 && !png.have_plte) return kCorrupt;
  *idat = pos;
  return 0;
}

// the inflated rows of the consecutive IDAT chunks from `pos`, each
// CRC-checked up to the one that ends the zlib stream (png_read_image)
int read_rows(const uint8_t* d, size_t n, size_t pos, Png& png) {
  std::vector<uint8_t> z;
  std::vector<size_t> ends;  // end offset in z of each chunk
  std::vector<size_t> starts;
  size_t p = pos;
  while (p + 8 <= n && std::memcmp(d + p + 4, "IDAT", 4) == 0) {
    const uint32_t len = be32(d + p);
    if (len > 0x7FFFFFFFu) return kCorrupt;
    const size_t have = std::min<size_t>(len, n - std::min(n, p + 8));
    starts.push_back(p);
    z.insert(z.end(), d + p + 8, d + p + 8 + have);
    ends.push_back(z.size());
    if (have < len) break;
    p += 12 + (size_t)len;
  }
  const int ch = channels_of(png.ctype);
  size_t need = 0;
  if (png.interlace) {
    for (const auto& a : kAdam7) {
      const uint32_t pw = png.width > (uint32_t)a[1] ? (png.width - a[1] + a[3] - 1) / a[3] : 0;
      const uint32_t ph = png.height > (uint32_t)a[0] ? (png.height - a[0] + a[2] - 1) / a[2] : 0;
      if (pw && ph) need += (size_t)ph * (1 + row_bytes(pw, ch, png.depth));
    }
  } else {
    need = (size_t)png.height * (1 + row_bytes(png.width, ch, png.depth));
  }
  size_t used = 0;
  if (inflate_zlib(z.data(), z.size(), png.raw, need, &used) != 0) return kCorrupt;
  if (png.raw.size() < need) return kCorrupt;  // not enough image data
  for (size_t i = 0; i < ends.size(); ++i) {
    const size_t s = starts[i];
    const uint32_t len = be32(d + s);
    if (s + 12 + (size_t)len > n) return kCorrupt;  // read past the end
    if (crc32(d + s + 4, 4 + (size_t)len) != be32(d + s + 8 + len)) return kCorrupt;
    if (ends[i] >= used) break;
  }
  return 0;
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// undo the filter of one row in place; prior is the previous row (zeros first)
int unfilter(int kind, uint8_t* row, const uint8_t* prior, size_t len, int bpp) {
  switch (kind) {
    case 0: return 0;
    case 1:
      for (size_t i = bpp; i < len; ++i) row[i] = (uint8_t)(row[i] + row[i - bpp]);
      return 0;
    case 2:
      for (size_t i = 0; i < len; ++i) row[i] = (uint8_t)(row[i] + prior[i]);
      return 0;
    case 3:
      for (size_t i = 0; i < len; ++i) {
        const int a = i >= (size_t)bpp ? row[i - bpp] : 0;
        row[i] = (uint8_t)(row[i] + ((a + prior[i]) >> 1));
      }
      return 0;
    case 4:
      for (size_t i = 0; i < len; ++i) {
        const int a = i >= (size_t)bpp ? row[i - bpp] : 0;
        const int c = i >= (size_t)bpp ? prior[i - bpp] : 0;
        row[i] = (uint8_t)(row[i] + paeth(a, prior[i], c));
      }
      return 0;
  }
  return kCorrupt;  // bad adaptive filter value
}

// libpng's 8-bit gamma tables (png_build_8bit_table, floating point)
void gamma_table(uint8_t* t, int gamma_val) {
  const bool significant = gamma_val < 100000 - 5000 || gamma_val > 100000 + 5000;
  for (int i = 0; i < 256; ++i)
    t[i] = (uint8_t)((significant && i > 0 && i < 255)
                         ? std::floor(255 * std::pow(i / 255., gamma_val * .00001) + .5)
                         : i);
}

inline int reciprocal(double a) { return (int)std::floor(1e10 / a + .5); }

// Calls emit(x, y, samples) for every pixel of every pass, the samples (up
// to 4, 16-bit values for 16-bit files) unfiltered and unpacked.
template <typename Emit>
int for_each_pixel(Png& png, Emit emit) {
  const int ch = channels_of(png.ctype);
  const int bpp = std::max(1, ch * png.depth / 8);
  size_t off = 0;
  const int passes = png.interlace ? 7 : 1;
  std::vector<uint8_t> prior;
  for (int pass = 0; pass < passes; ++pass) {
    const int y0 = png.interlace ? kAdam7[pass][0] : 0, x0 = png.interlace ? kAdam7[pass][1] : 0;
    const int ys = png.interlace ? kAdam7[pass][2] : 1, xs = png.interlace ? kAdam7[pass][3] : 1;
    const uint32_t pw = png.width > (uint32_t)x0 ? (png.width - x0 + xs - 1) / xs : 0;
    const uint32_t ph = png.height > (uint32_t)y0 ? (png.height - y0 + ys - 1) / ys : 0;
    if (!pw || !ph) continue;
    const size_t rb = row_bytes(pw, ch, png.depth);
    prior.assign(rb, 0);
    for (uint32_t r = 0; r < ph; ++r) {
      uint8_t* row = png.raw.data() + off + 1;
      if (unfilter(row[-1], row, prior.data(), rb, bpp)) return kCorrupt;
      off += rb + 1;
      const uint32_t y = y0 + r * ys;
      int s[4] = {0, 0, 0, 0};
      for (uint32_t i = 0; i < pw; ++i) {
        if (png.depth == 16) {
          for (int k = 0; k < ch; ++k) s[k] = (row[(i * ch + k) * 2] << 8) | row[(i * ch + k) * 2 + 1];
        } else if (png.depth == 8) {
          for (int k = 0; k < ch; ++k) s[k] = row[i * ch + k];
        } else {  // one sample of 1, 2 or 4 bits, high bits first
          const size_t bit = (size_t)i * png.depth;
          s[0] = (row[bit >> 3] >> (8 - png.depth - (bit & 7))) & ((1 << png.depth) - 1);
        }
        emit(x0 + i * xs, y, s);
      }
      std::memcpy(prior.data(), row, rb);
    }
  }
  return 0;
}

}  // namespace

int decode_png(const uint8_t* data, size_t size, int want_c, std::vector<uint8_t>& out, int* h, int* w) {
  if (want_c != 1 && want_c != 3) return kWrongChannels;
  Png png;
  size_t idat = 0;
  int rc = read_info(data, size, png, &idat);
  if (rc == 0) rc = read_rows(data, size, idat, png);
  if (rc) return rc;
  const bool color = png.ctype == 2 || png.ctype == 6 || png.ctype == 3;
  const bool to_gray = want_c == 1 && color;
  // rgb_to_gray: libpng builds gamma tables where the stated gamma is significant
  bool use_gamma = false;
  uint8_t to1[256], from1[256], same[256];
  if (to_gray) {
    if (png.chrm) return kPngColorSpace;
    const int g = png.gamma;
    if (g && (g < 95000 || g > 105000)) {
      if (png.depth == 16) return kPngColorSpace;
      const int screen = reciprocal(g);
      use_gamma = true;
      gamma_table(to1, reciprocal(g));
      gamma_table(from1, reciprocal(screen));
      gamma_table(same, (int)std::floor(1e15 / g / screen + .5));
    }
  }
  *h = (int)png.height;
  *w = (int)png.width;
  out.assign((size_t)png.height * png.width * want_c, 0);
  const int depth = png.depth;
  const int scale = depth < 8 ? 255 / ((1 << depth) - 1) : 1;
  auto to8 = [depth](int v) { return depth == 16 ? v >> 8 : v; };
  rc = for_each_pixel(png, [&](uint32_t x, uint32_t y, const int* s) {
    uint8_t* o = out.data() + ((size_t)y * png.width + x) * want_c;
    int r = 0, g = 0, b = 0;
    if (png.ctype == 0 || png.ctype == 4) {
      const int v = depth < 8 ? s[0] * scale : to8(s[0]);
      for (int k = 0; k < want_c; ++k) o[k] = (uint8_t)v;
      return;
    }
    if (png.ctype == 3) {
      r = png.palette[s[0]][0];
      g = png.palette[s[0]][1];
      b = png.palette[s[0]][2];
    } else if (to_gray && depth == 16) {  // libpng converts at 16 bits, then strips
      const uint32_t v = (6968u * s[0] + 23434u * s[1] + 2366u * s[2] + 16384u) >> 15;
      o[0] = (uint8_t)(v >> 8);
      return;
    } else {
      r = to8(s[0]);
      g = to8(s[1]);
      b = to8(s[2]);
    }
    if (!to_gray) {
      o[0] = (uint8_t)r;
      o[1] = (uint8_t)g;
      o[2] = (uint8_t)b;
    } else if (r == g && r == b) {
      o[0] = use_gamma ? same[r] : (uint8_t)r;
    } else if (use_gamma) {
      o[0] = from1[(6968 * to1[r] + 23434 * to1[g] + 2366 * to1[b] + 16384) >> 15];
    } else {
      o[0] = (uint8_t)((6968 * r + 23434 * g + 2366 * b) >> 15);
    }
  });
  return rc;
}

int decode_png16(const uint8_t* data, size_t size, int want_c, std::vector<uint16_t>& out, int* h, int* w) {
  if (want_c != 1) return kWrongChannels;
  Png png;
  size_t idat = 0;
  int rc = read_info(data, size, png, &idat);
  if (rc) return rc;
  if (png.depth != 16 || png.ctype != 0) return kWrongFormat;  // u16 stores hold 16-bit gray
  rc = read_rows(data, size, idat, png);
  if (rc) return rc;
  *h = (int)png.height;
  *w = (int)png.width;
  out.assign((size_t)png.height * png.width, 0);
  return for_each_pixel(png, [&](uint32_t x, uint32_t y, const int* s) {
    out[(size_t)y * png.width + x] = (uint16_t)s[0];
  });
}

}  // namespace mis_codecs
