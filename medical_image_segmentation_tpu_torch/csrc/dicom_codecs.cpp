// Compressed-DICOM pixel codecs — native fast path.
//
// JPEG Lossless, Non-Hierarchical (ITU-T T.81 process 14): the transfer
// syntaxes 1.2.840.10008.1.2.4.57/.70 that dominate compressed TCIA CT/MR
// series. The reference delegates these to pydicom's GDCM/pylibjpeg plugins
// (docker/Dockerfile:34-35); this is our own decoder, matching the
// pure-Python reference implementation in data/dicom_codecs.py bit-for-bit
// (parity-tested).
//
// Scope: Huffman (not arithmetic), non-subsampled components (Hi=Vi=1),
// 2..16-bit precision, predictors 1..7, point transform, restart markers,
// 1..3 interleaved components. Grayscale single-component is the hot path.
//
// Built into the same shared object as the MIS loader (see
// data/store/native.py).

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
  const uint8_t* data;
  int64_t n;
  int64_t i = 0;
  uint64_t acc = 0;
  int bits = 0;

  void fill() {
    while (bits <= 48 && i < n) {
      uint8_t b = data[i];
      if (b == 0xFF) {
        if (i + 1 < n && data[i + 1] == 0x00) {
          i += 2;
        } else {
          // marker reached: feed 1-bits (padding semantics)
          acc = (acc << 8) | 0xFF;
          bits += 8;
          continue;
        }
      } else {
        i += 1;
      }
      acc = (acc << 8) | b;
      bits += 8;
    }
  }

  inline uint32_t read(int k) {
    if (k == 0) return 0;
    if (bits < k) {
      fill();
      if (bits < k) {  // pad with 1s past the end
        acc = (acc << (k - bits)) | ((1ull << (k - bits)) - 1);
        bits = k;
      }
    }
    bits -= k;
    uint32_t v = (uint32_t)((acc >> bits) & ((1ull << k) - 1));
    acc &= (1ull << bits) - 1;
    return v;
  }

  // byte-align and skip one RSTn marker
  void resync() {
    acc = 0;
    bits = 0;
    while (i + 1 < n && !(data[i] == 0xFF && data[i + 1] >= 0xD0 && data[i + 1] <= 0xD7)) {
      i += 1;
    }
    i += 2;
  }
};

struct Huffman {
  int32_t mincode[17];
  int32_t maxcode[17];
  int32_t valptr[17];
  uint8_t symbols[256];
  bool valid = false;

  void build(const uint8_t* counts, const uint8_t* syms, int nsym) {
    int32_t code = 0;
    int k = 0;
    for (int ln = 1; ln <= 16; ++ln) {
      valptr[ln] = 0;
      mincode[ln] = 0;
      maxcode[ln] = -1;
      if (counts[ln - 1]) {
        valptr[ln] = k;
        mincode[ln] = code;
        code += counts[ln - 1];
        k += counts[ln - 1];
        maxcode[ln] = code - 1;
      }
      code <<= 1;
    }
    if (nsym > 256) nsym = 256;
    std::memcpy(symbols, syms, nsym);
    valid = true;
  }

  inline int decode(BitReader& br) const {
    int32_t code = (int32_t)br.read(1);
    int ln = 1;
    while (ln < 17 && code > maxcode[ln]) {
      code = (code << 1) | (int32_t)br.read(1);
      ++ln;
    }
    if (ln >= 17) return -1;
    return symbols[valptr[ln] + code - mincode[ln]];
  }
};

inline int32_t extend(uint32_t v, int t) {
  if (t == 0) return 0;
  if ((int32_t)v < (1 << (t - 1))) return (int32_t)v - (1 << t) + 1;
  return (int32_t)v;
}

struct Frame {
  int precision = 0;
  int rows = 0, cols = 0, ncomp = 0;
  int comp_table[3] = {0, 0, 0};
  int predictor = 0, pt = 0;
  int restart_interval = 0;
  const uint8_t* entropy = nullptr;
  int64_t entropy_len = 0;
  Huffman huff[4];
};

// parse markers up to SOS; returns 0 on success
int parse(const uint8_t* buf, int64_t len, Frame* f) {
  if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return 1;  // no SOI
  int64_t i = 2;
  int comp_ids[3] = {-1, -1, -1};
  while (i + 1 < len) {
    if (buf[i] != 0xFF) { ++i; continue; }
    uint8_t marker = buf[i + 1];
    i += 2;
    if (marker == 0xD8 || marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (marker == 0xD9) break;
    if (i + 2 > len) return 2;
    int seglen = (buf[i] << 8) | buf[i + 1];
    if (i + seglen > len || seglen < 2) return 2;
    const uint8_t* seg = buf + i + 2;
    int segn = seglen - 2;
    if (marker == 0xC3) {  // SOF3
      if (segn < 6) return 2;
      f->precision = seg[0];
      f->rows = (seg[1] << 8) | seg[2];
      f->cols = (seg[3] << 8) | seg[4];
      f->ncomp = seg[5];
      if (f->ncomp < 1 || f->ncomp > 3 || segn < 6 + 3 * f->ncomp) return 3;
      for (int c = 0; c < f->ncomp; ++c) {
        comp_ids[c] = seg[6 + 3 * c];
        if (seg[7 + 3 * c] != 0x11) return 4;  // subsampling unsupported
      }
    } else if (marker == 0xC4) {  // DHT
      int p = 0;
      while (p + 17 <= segn) {
        int th = seg[p] & 0x0F;
        if (th > 3) return 5;
        int nsym = 0;
        for (int l = 0; l < 16; ++l) nsym += seg[p + 1 + l];
        // sum(counts) > 256 would index decode() past symbols[256] — the
        // Python reference decoder raises for the same corrupt stream
        if (nsym > 256 || p + 17 + nsym > segn) return 5;
        f->huff[th].build(seg + p + 1, seg + p + 17, nsym);
        p += 17 + nsym;
      }
    } else if (marker == 0xDD) {  // DRI
      if (segn < 2) return 2;
      f->restart_interval = (seg[0] << 8) | seg[1];
    } else if (marker == 0xDA) {  // SOS
      if (segn < 1) return 2;
      int ns = seg[0];
      if (ns != f->ncomp || segn < 1 + 2 * ns + 3) return 6;
      for (int c = 0; c < ns; ++c) {
        int cid = seg[1 + 2 * c];
        int td = seg[2 + 2 * c] >> 4;
        if (td > 3) return 6;  // huff[] has 4 slots; Td is attacker data
        bool found = false;
        for (int k = 0; k < f->ncomp; ++k) {
          if (comp_ids[k] == cid) { f->comp_table[k] = td; found = true; }
        }
        if (!found || !f->huff[td].valid) return 6;
      }
      f->predictor = seg[1 + 2 * ns];
      f->pt = seg[3 + 2 * ns] & 0x0F;
      f->entropy = buf + i + seglen;
      f->entropy_len = len - (i + seglen);
      return 0;
    } else if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
               marker != 0xCC) {
      return 7;  // a non-lossless SOF
    }
    i += seglen;
  }
  return 8;  // no SOS
}

}  // namespace

extern "C" {

// probe dimensions; returns 0 on success
int jls_probe(const uint8_t* buf, int64_t len, int* rows, int* cols, int* ncomp) {
  Frame f;
  int rc = parse(buf, len, &f);
  if (rc != 0) return rc;
  if (f.rows <= 0 || f.cols <= 0) return 9;
  *rows = f.rows;
  *cols = f.cols;
  *ncomp = f.ncomp;
  return 0;
}

// decode into out (rows*cols*ncomp uint16, row-major, component-interleaved);
// returns 0 on success
int jls_decode(const uint8_t* buf, int64_t len, uint16_t* out, int64_t out_capacity) {
  Frame f;
  int rc = parse(buf, len, &f);
  if (rc != 0) return rc;
  const int64_t need = (int64_t)f.rows * f.cols * f.ncomp;
  if (need <= 0 || need > out_capacity) return 10;
  if (f.precision < 2 || f.precision > 16) return 11;
  if (f.predictor < 1 || f.predictor > 7) return 12;
  // point transform must leave at least one magnitude bit: pt >= precision
  // would make the default-prediction shift below UB (negative shift count)
  if (f.pt < 0 || f.pt >= f.precision) return 14;

  BitReader br{f.entropy, f.entropy_len};
  const Huffman* tabs[3];
  for (int c = 0; c < f.ncomp; ++c) tabs[c] = &f.huff[f.comp_table[c]];
  const int32_t dflt = 1 << (f.precision - f.pt - 1);
  const int rows = f.rows, cols = f.cols, nc = f.ncomp;
  const int ri = f.restart_interval;
  int64_t mcu = 0;
  // row-major reconstruction buffer is `out` itself (uint16 wraps mod 2^16,
  // matching the spec's modulo arithmetic)
  for (int y = 0; y < rows; ++y) {
    const bool first_row = (y == 0);
    for (int x = 0; x < cols; ++x) {
      if (ri && mcu && mcu % ri == 0) br.resync();
      const bool restart = ri && (mcu % ri == 0);
      uint16_t* px_out = out + ((int64_t)y * cols + x) * nc;
      for (int c = 0; c < nc; ++c) {
        int t = tabs[c]->decode(br);
        if (t < 0 || t > 16) return 13;
        int32_t diff = (t == 16) ? 32768 : extend(br.read(t), t);
        int32_t px;
        if ((first_row && x == 0) || restart) {
          px = dflt;
        } else if (first_row) {
          px = out[((int64_t)y * cols + (x - 1)) * nc + c];
        } else if (x == 0) {
          px = out[((int64_t)(y - 1) * cols + x) * nc + c];
        } else {
          int32_t ra = out[((int64_t)y * cols + (x - 1)) * nc + c];
          int32_t rb = out[((int64_t)(y - 1) * cols + x) * nc + c];
          int32_t rc2 = out[((int64_t)(y - 1) * cols + (x - 1)) * nc + c];
          switch (f.predictor) {
            case 1: px = ra; break;
            case 2: px = rb; break;
            case 3: px = rc2; break;
            case 4: px = ra + rb - rc2; break;
            case 5: px = ra + ((rb - rc2) >> 1); break;
            case 6: px = rb + ((ra - rc2) >> 1); break;
            default: px = (ra + rb) >> 1; break;
          }
        }
        px_out[c] = (uint16_t)((px + diff) & 0xFFFF);
      }
      ++mcu;
    }
  }
  if (f.pt) {
    for (int64_t k = 0; k < need; ++k) out[k] = (uint16_t)(out[k] << f.pt);
  }
  return 0;
}

}  // extern "C"
