// JPEG 2000 Part-1 (ITU-T T.800 / ISO 15444-1) decoder — C++ fast path.
//
// Port of the pure-Python reference decoder in
// medical_image_segmentation_tpu/data/jpeg2000.py (the test oracle,
// parity-tested against it and against OpenJPEG-encoded fixtures in
// tests/test_data_formats.py). The reference project decodes the DICOM
// J2K transfer syntaxes (1.2.840.10008.1.2.4.90/.91) through
// pylibjpeg-openjpeg/GDCM plugins (reference docker/Dockerfile:34-35).
//
// Scope — identical to the oracle: raw codestreams + JP2 boxes, 5/3 and 9/7
// wavelets, 1..4 components with RCT/ICT, tiles/tile-parts, custom
// precincts, SOP/EPH, all five progression orders, quality layers with
// truncation (midpoint reconstruction matching OpenJPEG bit-exactly on the
// reversible path). Unsupported structures (subsampling, code-block style
// flags, RGN/POC/PPM/PPT) return a nonzero status and the Python caller
// re-decodes with the oracle for a precise CodecError.
//
// C ABI:
//   j2k_probe(data, size, &rows, &cols, &ncomp, &precision, &signed) -> 0|err
//   j2k_decode(data, size, out_i32, out_capacity_elems)              -> 0|err
//     out layout: (rows, cols, ncomp) row-major, component-last; final
//     integer sample values (DC shift applied, clamped, round-half-even).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <tuple>
#include <vector>

namespace {

struct Err : std::runtime_error {
  explicit Err(const char* m) : std::runtime_error(m) {}
};

// b > 0; a may be negative. C++ division truncates toward zero (so the
// Python `-((-a) // b)` idiom does NOT transcribe) — adjust explicitly.
static inline int64_t ceil_div(int64_t a, int64_t b) {
  return a / b + (a % b > 0 ? 1 : 0);
}
static inline int bit_length(int64_t v) {
  int n = 0;
  while (v > 0) { v >>= 1; ++n; }
  return n;
}
static int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }
static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}

// ---------------------------------------------------------------------------
// markers
constexpr uint16_t SOC = 0xFF4F, SOT = 0xFF90, SOD = 0xFF93, EOC = 0xFFD9;
constexpr uint16_t SIZm = 0xFF51, CODm = 0xFF52, COCm = 0xFF53, QCDm = 0xFF5C,
                   QCCm = 0xFF5D;
constexpr uint16_t RGNm = 0xFF5E, POCm = 0xFF5F, PPMm = 0xFF60, PPTm = 0xFF61;

// ---------------------------------------------------------------------------
// header structures

struct Siz {
  int64_t xsiz, ysiz, xosiz, yosiz, xtsiz, ytsiz, xtosiz, ytosiz;
  int ncomp;
  int prec[4];
  bool signed_[4];
  int64_t ntx, nty;

  Siz(const uint8_t* seg, int n) {
    if (n < 36) throw Err("short SIZ");
    xsiz = be32(seg + 2); ysiz = be32(seg + 6);
    xosiz = be32(seg + 10); yosiz = be32(seg + 14);
    xtsiz = be32(seg + 18); ytsiz = be32(seg + 22);
    xtosiz = be32(seg + 26); ytosiz = be32(seg + 30);
    ncomp = be16(seg + 34);
    if (ncomp < 1 || ncomp > 4) throw Err("unsupported component count");
    if (n < 36 + 3 * ncomp) throw Err("short SIZ component table");
    for (int c = 0; c < ncomp; ++c) {
      uint8_t ssiz = seg[36 + 3 * c];
      if (seg[37 + 3 * c] != 1 || seg[38 + 3 * c] != 1)
        throw Err("component subsampling not supported");
      prec[c] = (ssiz & 0x7F) + 1;
      signed_[c] = (ssiz & 0x80) != 0;
      if (prec[c] < 1 || prec[c] > 16) throw Err("unsupported precision");
    }
    if (xsiz <= xosiz || ysiz <= yosiz) throw Err("empty image region");
    if (xtsiz == 0 || ytsiz == 0) throw Err("zero tile size");
    if (xsiz > (1 << 24) || ysiz > (1 << 24)) throw Err("image too large");
    ntx = ceil_div(xsiz - xtosiz, xtsiz);
    nty = ceil_div(ysiz - ytosiz, ytsiz);
  }
};

struct Cod {
  bool has_precincts, sop, eph;
  int progression = 0, layers = 1, mct = 0;
  int levels, xcb, ycb, transform;
  int ppx[33], ppy[33];

  Cod(uint8_t scod, const uint8_t* body, int n, bool has_sg, int prog = 0,
      int lay = 1, int mct_ = 0) {
    has_precincts = scod & 1;
    sop = scod & 2;
    eph = scod & 4;
    if (has_sg) { progression = prog; layers = lay; mct = mct_; }
    if (n < 5) throw Err("short COD body");
    levels = body[0];
    if (levels > 32) throw Err("too many decomposition levels");
    xcb = body[1] + 2;
    ycb = body[2] + 2;
    if (xcb > 10 || ycb > 10 || xcb + ycb > 12) throw Err("invalid code-block size");
    if (body[3] != 0) throw Err("code-block style flags not supported");
    transform = body[4];
    if (transform != 0 && transform != 1) throw Err("unknown wavelet transform");
    if (has_precincts) {
      if (n < 5 + levels + 1) throw Err("short precinct size list");
      for (int r = 0; r <= levels; ++r) {
        ppx[r] = body[5 + r] & 0x0F;
        ppy[r] = (body[5 + r] >> 4) & 0x0F;
        if (r > 0 && (ppx[r] == 0 || ppy[r] == 0))
          throw Err("precinct exponent 0 only valid at resolution 0");
      }
    } else {
      for (int r = 0; r <= levels; ++r) { ppx[r] = 15; ppy[r] = 15; }
    }
  }

  void clone_sg(const Cod& o) {
    progression = o.progression;
    layers = o.layers;
    mct = o.mct;
    // Scoc carries only the precinct flag (T.800 A.6.2); SOP/EPH come from
    // the main COD's Scod and apply to all components' packets.
    sop = o.sop;
    eph = o.eph;
  }
};

static Cod parse_cod(const uint8_t* seg, int n) {
  if (n < 10) throw Err("short COD");
  uint8_t scod = seg[0];
  int prog = seg[1], layers = be16(seg + 2), mct = seg[4];
  if (prog > 4) throw Err("unknown progression order");
  if (layers == 0) throw Err("zero quality layers");
  if (mct != 0 && mct != 1) throw Err("unknown MCT");
  return Cod(scod, seg + 5, n - 5, true, prog, layers, mct);
}

struct Qcd {
  int style, guard;
  std::vector<int> exps, mants;

  Qcd() : style(0), guard(0) {}
  Qcd(const uint8_t* seg, int n) {
    if (n < 1) throw Err("short QCD");
    uint8_t sqcd = seg[0];
    style = sqcd & 0x1F;
    guard = sqcd >> 5;
    const uint8_t* body = seg + 1;
    int bn = n - 1;
    if (style == 0) {  // no quantization: 8-bit exponents
      for (int i = 0; i < bn; ++i) { exps.push_back(body[i] >> 3); mants.push_back(0); }
    } else if (style == 1) {  // scalar derived
      if (bn < 2) throw Err("short QCD (derived)");
      int v = be16(body);
      exps.push_back(v >> 11);
      mants.push_back(v & 0x7FF);
    } else if (style == 2) {  // scalar expounded
      if (bn % 2) throw Err("odd QCD (expounded) length");
      for (int i = 0; i < bn; i += 2) {
        int v = be16(body + i);
        exps.push_back(v >> 11);
        mants.push_back(v & 0x7FF);
      }
    } else {
      throw Err("unknown quantization style");
    }
  }

  // (exponent, mantissa) for global band index; nb = band decomposition level
  void band_params(int levels, int band_index, int nb, int* exp, int* mant) const {
    if (style == 1) {
      *exp = exps[0] - levels + nb;
      *mant = mants[0];
      return;
    }
    if (band_index >= int(exps.size())) throw Err("QCD has too few subband entries");
    *exp = exps[band_index];
    *mant = mants[band_index];
  }
};

// ---------------------------------------------------------------------------
// packet-header bit reader (B.10.1: bit stuffing after 0xFF)

struct PacketBitReader {
  const uint8_t* data;
  int64_t n, pos;
  int byte = 0, nbits = 0;
  bool last_ff = false;

  PacketBitReader(const uint8_t* d, int64_t size, int64_t p)
      : data(d), n(size), pos(p) {}

  int read_bit() {
    if (nbits == 0) {
      if (pos >= n) throw Err("packet header overrun");
      int b = data[pos++];
      if (last_ff) {
        if (b & 0x80) throw Err("invalid stuffing after 0xFF in packet header");
        byte = b;
        nbits = 7;
      } else {
        byte = b;
        nbits = 8;
      }
      last_ff = (b == 0xFF);
    }
    --nbits;
    return (byte >> nbits) & 1;
  }

  int64_t read(int k) {
    int64_t v = 0;
    for (int i = 0; i < k; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t align() {
    nbits = 0;
    if (last_ff) {
      if (pos < n) {
        if (data[pos] & 0x80) throw Err("invalid stuffing at packet header end");
        ++pos;
      }
    }
    last_ff = false;
    return pos;
  }
};

// ---------------------------------------------------------------------------
// tag trees (B.10.2)

struct TagTree {
  struct Node {
    int parent;  // -1 for root
    int value = 0, low = 0;
    bool known = false;
  };
  std::vector<Node> nodes;  // root first, leaves last
  int leaf_base = 0, leaf_w = 0;

  TagTree() {}
  TagTree(int w, int h) {
    std::vector<std::pair<int, int>> sizes;
    int lw = std::max(w, 1), lh = std::max(h, 1);
    for (;;) {
      sizes.push_back({lw, lh});
      if (lw == 1 && lh == 1) break;
      lw = int(ceil_div(lw, 2));
      lh = int(ceil_div(lh, 2));
    }
    // levels root (smallest) → leaf (largest)
    std::vector<int> level_base;
    for (int li = int(sizes.size()) - 1; li >= 0; --li) {
      level_base.push_back(int(nodes.size()));
      int cw = sizes[li].first, ch = sizes[li].second;
      bool is_root = (li == int(sizes.size()) - 1);
      int prev_base = is_root ? -1 : level_base[level_base.size() - 2];
      int pw = is_root ? 0 : sizes[li + 1].first;
      for (int yy = 0; yy < ch; ++yy)
        for (int xx = 0; xx < cw; ++xx) {
          Node nd;
          nd.parent = is_root ? -1 : prev_base + (yy / 2) * pw + (xx / 2);
          nodes.push_back(nd);
        }
    }
    leaf_base = level_base.back();
    leaf_w = sizes[0].first;
  }

  // true iff leaf value < threshold (decoding as many bits as needed)
  bool decode(PacketBitReader& br, int x, int y, int threshold) {
    int path[40], depth = 0;
    int idx = leaf_base + y * leaf_w + x;
    while (idx >= 0) {
      path[depth++] = idx;
      idx = nodes[idx].parent;
      if (depth >= 40) throw Err("tag tree too deep");
    }
    int low = 0;
    for (int i = depth - 1; i >= 0; --i) {
      Node& nd = nodes[path[i]];
      if (nd.low < low) nd.low = low;
      while (!nd.known && nd.low < threshold) {
        if (br.read_bit()) {
          nd.value = nd.low;
          nd.known = true;
        } else {
          ++nd.low;
        }
      }
      low = nd.known ? nd.value : nd.low;
    }
    Node& leaf = nodes[path[0]];
    return leaf.known && leaf.value < threshold;
  }
};

// ---------------------------------------------------------------------------
// MQ arithmetic decoder (Annex C)

struct MQEntry { uint16_t qe; uint8_t nmps, nlps, sw; };
constexpr MQEntry kMQ[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

struct Ctx { uint8_t idx, mps; };

struct MQDecoder {
  const uint8_t* data;
  int64_t n;
  int64_t bp = 0;
  uint32_t c, a;
  int ct;

  MQDecoder(const uint8_t* d, int64_t size) : data(d), n(size) {
    c = uint32_t(B(0)) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  inline int B(int64_t i) const { return i < n ? data[i] : 0xFF; }

  void bytein() {
    if (B(bp) == 0xFF) {
      if (B(bp + 1) > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t(B(bp)) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t(B(bp)) << 8;
      ct = 8;
    }
  }

  inline void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
  }

  inline int decode(Ctx& cx) {
    const MQEntry& e = kMQ[cx.idx];
    uint32_t qe = e.qe;
    a -= qe;
    int d;
    if (((c >> 16) & 0xFFFF) < qe) {
      if (a < qe) {
        d = cx.mps;
        cx.idx = e.nmps;
      } else {
        d = 1 - cx.mps;
        if (e.sw) cx.mps = 1 - cx.mps;
        cx.idx = e.nlps;
      }
      a = qe;
      renorm();
      return d;
    }
    c -= qe << 16;
    if (a & 0x8000) return cx.mps;
    if (a < qe) {
      d = 1 - cx.mps;
      if (e.sw) cx.mps = 1 - cx.mps;
      cx.idx = e.nlps;
    } else {
      d = cx.mps;
      cx.idx = e.nmps;
    }
    renorm();
    return d;
  }
};

// ---------------------------------------------------------------------------
// EBCOT Tier-1 (Annex D)

constexpr int kCtxRL = 17, kCtxUni = 18, kNCtx = 19;

// zero-coding context LUT [family][h][v][d] (Table D.1); families:
// 0 = LL/LH, 1 = HL, 2 = HH
struct ZCLut {
  int8_t t[3][3][3][5];
  ZCLut() {
    for (int h = 0; h < 3; ++h)
      for (int v = 0; v < 3; ++v)
        for (int d = 0; d < 5; ++d) {
          int dd = d > 4 ? 4 : d;
          int c;
          // LL & LH
          if (h == 2) c = 8;
          else if (h == 1) c = v >= 1 ? 7 : (d >= 1 ? 6 : 5);
          else c = v == 2 ? 4 : (v == 1 ? 3 : (d >= 2 ? 2 : d));
          t[0][h][v][dd] = int8_t(c);
          // HL: swap h and v
          if (v == 2) c = 8;
          else if (v == 1) c = h >= 1 ? 7 : (d >= 1 ? 6 : 5);
          else c = h == 2 ? 4 : (h == 1 ? 3 : (d >= 2 ? 2 : d));
          t[1][h][v][dd] = int8_t(c);
          // HH
          int hv = h + v;
          if (d >= 3) c = 8;
          else if (d == 2) c = hv >= 1 ? 7 : 6;
          else if (d == 1) c = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
          else c = hv >= 2 ? 2 : hv;
          t[2][h][v][dd] = int8_t(c);
        }
  }
};
static const ZCLut kZC;

// sign-coding (Table D.3): (hc+1, vc+1) → {context, xorbit}
struct SCEntry { uint8_t cx, xr; };
static const SCEntry kSC[3][3] = {
    // hc = -1:       vc=-1        vc=0         vc=1
    {{13, 1}, {12, 1}, {11, 1}},
    // hc = 0:
    {{10, 1}, {9, 0}, {10, 0}},
    // hc = 1:
    {{11, 0}, {12, 0}, {13, 0}},
};

// Per-cell neighbor-flags word on the (h+2)x(w+2) padded grid. Low 8 bits
// mirror the significance of the 8 neighbors (maintained incrementally when
// a sample becomes significant), bits 8-11 the signs of the 4 H/V neighbors,
// and the high bits the cell's own state. Context formation then reads one
// word + a LUT instead of 8 scattered neighbor loads per sample (the contexts
// produced are identical to the direct Table D.1/D.3 evaluation — the LUTs
// below are built from the same kZC/kSC tables).
enum : uint32_t {
  F_SIG_W = 1u << 0, F_SIG_E = 1u << 1, F_SIG_N = 1u << 2, F_SIG_S = 1u << 3,
  F_SIG_NW = 1u << 4, F_SIG_NE = 1u << 5, F_SIG_SW = 1u << 6, F_SIG_SE = 1u << 7,
  F_SGN_W = 1u << 8, F_SGN_E = 1u << 9, F_SGN_N = 1u << 10, F_SGN_S = 1u << 11,
  F_SIG = 1u << 12, F_VISIT = 1u << 13, F_REFINED = 1u << 14, F_SGN = 1u << 15,
};

// zero-coding context by neighbor-significance byte (from kZC)
struct ZC2Lut {
  uint8_t t[3][256];
  ZC2Lut() {
    for (int fam = 0; fam < 3; ++fam)
      for (int b = 0; b < 256; ++b) {
        int hh = ((b >> 0) & 1) + ((b >> 1) & 1);
        int vv = ((b >> 2) & 1) + ((b >> 3) & 1);
        int dd = ((b >> 4) & 1) + ((b >> 5) & 1) + ((b >> 6) & 1) + ((b >> 7) & 1);
        t[fam][b] = uint8_t(
            kZC.t[fam][std::min(hh, 2)][std::min(vv, 2)][std::min(dd, 4)]);
      }
  }
};
static const ZC2Lut kZC2;

// sign-coding context by (H/V neighbor significance nibble | sign nibble<<4)
struct SC2Lut {
  SCEntry t[256];
  SC2Lut() {
    for (int b = 0; b < 256; ++b) {
      auto contrib = [&](int sigbit, int sgnbit) {
        if (!((b >> sigbit) & 1)) return 0;
        return ((b >> sgnbit) & 1) ? -1 : 1;
      };
      int hc = contrib(0, 4) + contrib(1, 5);
      int vc = contrib(2, 6) + contrib(3, 7);
      hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
      vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
      t[b] = kSC[hc + 1][vc + 1];
    }
  }
};
static const SC2Lut kSC2;

struct T1Decoder {
  int w, h, family, stride;
  std::vector<uint32_t> flags;  // (h+2)x(w+2) padded
  std::vector<int64_t> mag;     // h*w
  std::vector<int16_t> last;    // h*w — plane of last decoded bit
  Ctx ctx[kNCtx];

  T1Decoder(int w_, int h_, int fam)
      : w(w_), h(h_), family(fam), stride(w_ + 2) {
    flags.assign(size_t(h + 2) * stride, 0);
    mag.assign(size_t(h) * w, 0);
    last.assign(size_t(h) * w, 0);
    // Table D.7 initial states: all (0,0) except ZC ctx 0 → 4, RL → 3, UNI → 46
    for (int i = 0; i < kNCtx; ++i) ctx[i] = {0, 0};
    ctx[0] = {4, 0};
    ctx[kCtxRL] = {3, 0};
    ctx[kCtxUni] = {46, 0};
  }

  inline uint32_t& F(int x, int y) {
    return flags[size_t(y + 1) * stride + (x + 1)];
  }
  inline uint32_t F(int x, int y) const {
    return flags[size_t(y + 1) * stride + (x + 1)];
  }
  inline int S(int x, int y) const { return (F(x, y) & F_SIG) ? 1 : 0; }
  inline int G(int x, int y) const {
    uint32_t f = F(x, y);
    return (f & F_SIG) ? ((f & F_SGN) ? -1 : 1) : 0;
  }

  inline void become_significant(MQDecoder& mq, int x, int y, int plane) {
    uint32_t* p = &F(x, y);
    const SCEntry& e = kSC2.t[(*p & 0xF) | ((*p >> 4) & 0xF0)];
    int bit = mq.decode(ctx[e.cx]);
    uint32_t neg = uint32_t(bit ^ e.xr);
    *p |= F_SIG | (neg << 15);
    // mirror into the 8 neighbors' words (sign only for the H/V four)
    p[-1] |= F_SIG_E | (neg << 9);
    p[1] |= F_SIG_W | (neg << 8);
    p[-stride] |= F_SIG_S | (neg << 11);
    p[stride] |= F_SIG_N | (neg << 10);
    p[-stride - 1] |= F_SIG_SE;
    p[-stride + 1] |= F_SIG_SW;
    p[stride - 1] |= F_SIG_NE;
    p[stride + 1] |= F_SIG_NW;
    mag[size_t(y) * w + x] = int64_t(1) << plane;
    last[size_t(y) * w + x] = int16_t(plane);
  }

  void sig_pass(MQDecoder& mq, int plane) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          uint32_t f = F(x, y);
          if ((f & F_SIG) || !(f & 0xFF)) continue;
          F(x, y) = f | F_VISIT;
          if (mq.decode(ctx[kZC2.t[family][f & 0xFF]]))
            become_significant(mq, x, y, plane);
        }
  }

  void mag_pass(MQDecoder& mq, int plane) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          uint32_t f = F(x, y);
          if (!(f & F_SIG) || (f & F_VISIT)) continue;
          int cxi = (f & F_REFINED) ? 16 : ((f & 0xFF) ? 15 : 14);
          int bit = mq.decode(ctx[cxi]);
          F(x, y) = f | F_REFINED;
          last[size_t(y) * w + x] = int16_t(plane);
          if (bit) mag[size_t(y) * w + x] |= int64_t(1) << plane;
        }
  }

  void cleanup_pass(MQDecoder& mq, int plane) {
    for (int y0 = 0; y0 < h; y0 += 4) {
      for (int x = 0; x < w; ++x) {
        int y = y0;
        bool full = (y0 + 4 <= h);
        bool rl = full;
        if (full) {
          for (int yy = y0; yy < y0 + 4; ++yy)
            if (F(x, yy) & (F_VISIT | F_SIG | 0xFF)) { rl = false; break; }
        }
        if (rl) {
          // the whole stripe column is insignificant with no visited samples,
          // so declining the run-length leaves nothing to reset
          if (!mq.decode(ctx[kCtxRL])) continue;
          int r = (mq.decode(ctx[kCtxUni]) << 1) | mq.decode(ctx[kCtxUni]);
          y = y0 + r;
          become_significant(mq, x, y, plane);
          ++y;
        }
        for (int yy = y; yy < std::min(y0 + 4, h); ++yy) {
          uint32_t f = F(x, yy);
          if (f & (F_VISIT | F_SIG)) continue;
          if (mq.decode(ctx[kZC2.t[family][f & 0xFF]]))
            become_significant(mq, x, yy, plane);
        }
      }
    }
    for (auto& f : flags) f &= ~F_VISIT;
  }
};

// Run npasses coding passes; fills mag2 (doubled midpoint values) and sign
static void decode_codeblock(const uint8_t* data, int64_t size, int w, int h,
                             int family, int zero_planes, int npasses, int mb,
                             std::vector<int64_t>* mag2_out,
                             std::vector<int8_t>* sign_out) {
  T1Decoder t1(w, h, family);
  MQDecoder mq(data, size);
  int plane = mb - 1 - zero_planes;
  mag2_out->assign(size_t(w) * h, 0);
  sign_out->assign(size_t(w) * h, 1);
  if (plane < 0) {
    if (npasses > 0) throw Err("zero bit-planes exceed Mb");
    return;
  }
  int k = 0;
  t1.cleanup_pass(mq, plane);
  ++k;
  --plane;
  while (k < npasses) {
    if (plane < 0) throw Err("more passes than bit-planes");
    t1.sig_pass(mq, plane);
    if (++k >= npasses) break;
    t1.mag_pass(mq, plane);
    if (++k >= npasses) break;
    t1.cleanup_pass(mq, plane);
    ++k;
    --plane;
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int64_t m2 = 2 * t1.mag[y * w + x];
      if (t1.S(x, y)) m2 += int64_t(1) << t1.last[y * w + x];
      (*mag2_out)[size_t(y) * w + x] = m2;
      (*sign_out)[size_t(y) * w + x] = int8_t(t1.G(x, y) < 0 ? -1 : 1);
    }
}

// ---------------------------------------------------------------------------
// geometry

struct CodeBlock {
  int64_t x0, y0, x1, y1;
  bool included = false;
  int zero_planes = 0, npasses = 0, lblock = 3;
  std::vector<uint8_t> data;
};

struct BandT {
  int btype;  // 0=LL 1=HL 2=LH 3=HH
  int64_t x0, y0, x1, y1;
  int exp, mant, nb;
  std::vector<std::vector<CodeBlock>> cblocks;  // per precinct
  std::vector<TagTree> incl_trees, zb_trees;
  std::vector<std::pair<int, int>> cb_grid;

  int family() const { return btype == 1 ? 1 : (btype == 3 ? 2 : 0); }
};

struct ResolutionT {
  int r;
  int64_t x0, y0, x1, y1;
  int ppx, ppy;
  int64_t npw = 0, nph = 0;
  std::vector<BandT> bands;
};

struct TileComp {
  const Cod* cod;
  int64_t x0, y0, x1, y1;
  std::vector<ResolutionT> resolutions;

  TileComp(const Cod& c, const Qcd& q, int64_t tx0, int64_t ty0, int64_t tx1,
           int64_t ty1)
      : cod(&c), x0(tx0), y0(ty0), x1(tx1), y1(ty1) {
    int nl = c.levels;
    int band_idx = 0;
    for (int r = 0; r <= nl; ++r) {
      int sh = nl - r;
      ResolutionT res;
      res.r = r;
      res.x0 = ceil_div(tx0, int64_t(1) << sh);
      res.y0 = ceil_div(ty0, int64_t(1) << sh);
      res.x1 = ceil_div(tx1, int64_t(1) << sh);
      res.y1 = ceil_div(ty1, int64_t(1) << sh);
      res.ppx = c.ppx[r];
      res.ppy = c.ppy[r];
      if (res.x1 > res.x0 && res.y1 > res.y0) {
        res.npw = ceil_div(res.x1, int64_t(1) << res.ppx) - (res.x0 >> res.ppx);
        res.nph = ceil_div(res.y1, int64_t(1) << res.ppy) - (res.y0 >> res.ppy);
      }
      if (r == 0) {
        BandT b;
        b.btype = 0;
        b.x0 = res.x0; b.y0 = res.y0; b.x1 = res.x1; b.y1 = res.y1;
        q.band_params(nl, 0, nl, &b.exp, &b.mant);
        b.nb = nl;
        res.bands.push_back(std::move(b));
        band_idx = 1;
      } else {
        int nb = nl - r + 1;
        const int types[3] = {1, 2, 3};  // HL, LH, HH
        const int xob[3] = {1, 0, 1}, yob[3] = {0, 1, 1};
        for (int k = 0; k < 3; ++k) {
          BandT b;
          b.btype = types[k];
          int64_t half = int64_t(1) << (nb - 1);
          b.x0 = ceil_div(tx0 - half * xob[k], int64_t(1) << nb);
          b.x1 = ceil_div(tx1 - half * xob[k], int64_t(1) << nb);
          b.y0 = ceil_div(ty0 - half * yob[k], int64_t(1) << nb);
          b.y1 = ceil_div(ty1 - half * yob[k], int64_t(1) << nb);
          q.band_params(nl, band_idx, nb, &b.exp, &b.mant);
          ++band_idx;
          b.nb = nb;
          res.bands.push_back(std::move(b));
        }
      }
      build_precincts(res, c);
      resolutions.push_back(std::move(res));
    }
  }

  static void build_precincts(ResolutionT& res, const Cod& cod) {
    int r = res.r;
    int xcb, ycb, shift;
    if (r == 0) {
      xcb = std::min(cod.xcb, res.ppx);
      ycb = std::min(cod.ycb, res.ppy);
      shift = 0;
    } else {
      xcb = std::min(cod.xcb, res.ppx - 1);
      ycb = std::min(cod.ycb, res.ppy - 1);
      shift = 1;
    }
    for (auto& band : res.bands) {
      for (int64_t pj = 0; pj < res.nph; ++pj)
        for (int64_t pi = 0; pi < res.npw; ++pi) {
          int64_t px0 = std::max(res.x0, ((res.x0 >> res.ppx) + pi) << res.ppx);
          int64_t py0 = std::max(res.y0, ((res.y0 >> res.ppy) + pj) << res.ppy);
          int64_t px1 = std::min(res.x1, ((res.x0 >> res.ppx) + pi + 1) << res.ppx);
          int64_t py1 = std::min(res.y1, ((res.y0 >> res.ppy) + pj + 1) << res.ppy);
          int64_t bx0, by0, bx1, by1;
          if (shift) {
            bx0 = ceil_div(px0, 2); by0 = ceil_div(py0, 2);
            bx1 = ceil_div(px1, 2); by1 = ceil_div(py1, 2);
          } else {
            bx0 = px0; by0 = py0; bx1 = px1; by1 = py1;
          }
          bx0 = std::max(bx0, band.x0); by0 = std::max(by0, band.y0);
          bx1 = std::min(bx1, band.x1); by1 = std::min(by1, band.y1);
          std::vector<CodeBlock> blocks;
          int ncols = 0, nrows = 0;
          if (bx1 > bx0 && by1 > by0) {
            int64_t cx0 = (bx0 >> xcb) << xcb;
            int64_t cy0 = (by0 >> ycb) << ycb;
            ncols = int(ceil_div(bx1 - cx0, int64_t(1) << xcb));
            nrows = int(ceil_div(by1 - cy0, int64_t(1) << ycb));
            for (int cy = 0; cy < nrows; ++cy)
              for (int cx = 0; cx < ncols; ++cx) {
                CodeBlock cb;
                cb.x0 = std::max(cx0 + (int64_t(cx) << xcb), bx0);
                cb.y0 = std::max(cy0 + (int64_t(cy) << ycb), by0);
                cb.x1 = std::min(cx0 + (int64_t(cx + 1) << xcb), bx1);
                cb.y1 = std::min(cy0 + (int64_t(cy + 1) << ycb), by1);
                blocks.push_back(std::move(cb));
              }
          }
          band.cblocks.push_back(std::move(blocks));
          band.cb_grid.push_back({ncols, nrows});
          band.incl_trees.push_back(TagTree(ncols, nrows));
          band.zb_trees.push_back(TagTree(ncols, nrows));
        }
    }
  }
};

// ---------------------------------------------------------------------------
// packet decoding

static int64_t read_packet(const uint8_t* data, int64_t n, int64_t pos,
                           ResolutionT& res, int64_t precinct, int layer,
                           const Cod& cod) {
  if (cod.sop) {
    if (pos + 2 <= n && data[pos] == 0xFF && data[pos + 1] == 0x91) pos += 6;
  }
  PacketBitReader br(data, n, pos);
  if (!br.read_bit()) {  // zero-length packet
    pos = br.align();
    if (cod.eph) {
      if (pos + 2 <= n && data[pos] == 0xFF && data[pos + 1] == 0x92) pos += 2;
    }
    return pos;
  }
  struct Contribution { CodeBlock* cb; int newp; int64_t seglen; };
  std::vector<Contribution> contributions;
  for (auto& band : res.bands) {
    auto& blocks = band.cblocks[precinct];
    if (blocks.empty()) continue;
    int ncols = band.cb_grid[precinct].first;
    TagTree& incl_t = band.incl_trees[precinct];
    TagTree& zb_t = band.zb_trees[precinct];
    for (size_t bi = 0; bi < blocks.size(); ++bi) {
      CodeBlock& cb = blocks[bi];
      int cx = int(bi) % ncols, cy = int(bi) / ncols;
      bool inc;
      if (!cb.included) inc = incl_t.decode(br, cx, cy, layer + 1);
      else inc = br.read_bit() != 0;
      if (!inc) continue;
      if (!cb.included) {
        int zb = 0;
        while (!zb_t.decode(br, cx, cy, zb + 1)) {
          if (++zb > 74) throw Err("zero-bitplane count overflow");
        }
        cb.zero_planes = zb;
        cb.included = true;
        cb.lblock = 3;
      }
      // number of new passes (B.10.6)
      int newp;
      if (!br.read_bit()) newp = 1;
      else if (!br.read_bit()) newp = 2;
      else {
        int v = int(br.read(2));
        if (v < 3) newp = 3 + v;
        else {
          v = int(br.read(5));
          if (v < 31) newp = 6 + v;
          else newp = 37 + int(br.read(7));
        }
      }
      while (br.read_bit()) {
        if (++cb.lblock > 32) throw Err("Lblock overflow");
      }
      int nbits = cb.lblock + bit_length(newp) - 1;
      if (nbits > 32) throw Err("segment length field too wide");
      int64_t seglen = br.read(nbits);
      contributions.push_back({&cb, newp, seglen});
      cb.npasses += newp;
      if (cb.npasses > 3 * 40) throw Err("pass count overflow");
    }
  }
  pos = br.align();
  if (cod.eph) {
    if (pos + 2 <= n && data[pos] == 0xFF && data[pos + 1] == 0x92) pos += 2;
    else throw Err("missing EPH marker");
  }
  for (auto& ct : contributions) {
    if (pos + ct.seglen > n) throw Err("packet body overrun");
    ct.cb->data.insert(ct.cb->data.end(), data + pos, data + pos + ct.seglen);
    pos += ct.seglen;
  }
  return pos;
}

struct PacketRef { int c, r; int64_t p; int l; };

// progression order (B.12) — mirrors _packet_order in the Python oracle
static std::vector<PacketRef> packet_order(std::vector<TileComp>& tcs,
                                           const Cod& cod) {
  std::vector<PacketRef> out;
  int prog = cod.progression;
  int layers = cod.layers;
  size_t max_res = 0;
  for (auto& tc : tcs) max_res = std::max(max_res, tc.resolutions.size());
  int ncomp = int(tcs.size());

  if (prog == 0) {  // LRCP
    for (int l = 0; l < layers; ++l)
      for (size_t r = 0; r < max_res; ++r)
        for (int c = 0; c < ncomp; ++c) {
          if (r >= tcs[c].resolutions.size()) continue;
          auto& res = tcs[c].resolutions[r];
          for (int64_t p = 0; p < res.npw * res.nph; ++p)
            out.push_back({c, int(r), p, l});
        }
    return out;
  }
  if (prog == 1) {  // RLCP
    for (size_t r = 0; r < max_res; ++r)
      for (int l = 0; l < layers; ++l)
        for (int c = 0; c < ncomp; ++c) {
          if (r >= tcs[c].resolutions.size()) continue;
          auto& res = tcs[c].resolutions[r];
          for (int64_t p = 0; p < res.npw * res.nph; ++p)
            out.push_back({c, int(r), p, l});
        }
    return out;
  }
  // positional orders: project precinct top-left to tile coords
  struct Pos { int64_t y, x; int c, r; int64_t p; };
  std::vector<Pos> pos_list;
  for (int c = 0; c < ncomp; ++c) {
    int nl = tcs[c].cod->levels;
    for (size_t r = 0; r < tcs[c].resolutions.size(); ++r) {
      auto& res = tcs[c].resolutions[r];
      if (res.npw == 0 || res.nph == 0) continue;
      int sh = nl - int(r);
      for (int64_t pj = 0; pj < res.nph; ++pj)
        for (int64_t pi = 0; pi < res.npw; ++pi) {
          int64_t p = pj * res.npw + pi;
          int64_t px = std::max(res.x0, ((res.x0 >> res.ppx) + pi) << res.ppx);
          int64_t py = std::max(res.y0, ((res.y0 >> res.ppy) + pj) << res.ppy);
          pos_list.push_back({py << sh, px << sh, c, int(r), p});
        }
    }
  }
  auto emit = [&](const Pos& t) {
    for (int l = 0; l < layers; ++l) out.push_back({t.c, t.r, t.p, l});
  };
  if (prog == 2) {  // RPCL: (r, y, x, c)
    std::sort(pos_list.begin(), pos_list.end(), [](const Pos& a, const Pos& b) {
      return std::tie(a.r, a.y, a.x, a.c) < std::tie(b.r, b.y, b.x, b.c);
    });
  } else if (prog == 3) {  // PCRL: (y, x, c, r)
    std::sort(pos_list.begin(), pos_list.end(), [](const Pos& a, const Pos& b) {
      return std::tie(a.y, a.x, a.c, a.r) < std::tie(b.y, b.x, b.c, b.r);
    });
  } else {  // CPRL: (c, y, x, r)
    std::sort(pos_list.begin(), pos_list.end(), [](const Pos& a, const Pos& b) {
      return std::tie(a.c, a.y, a.x, a.r) < std::tie(b.c, b.y, b.x, b.r);
    });
  }
  for (auto& t : pos_list) emit(t);
  return out;
}

// ---------------------------------------------------------------------------
// inverse wavelet (Annex F). The 1-D synthesis (F.3.8) is applied per row for
// the horizontal pass (gather into a caller-provided workspace — no per-line
// allocation) and row-vectorized for the vertical pass (whole-row elementwise
// lifting on an interleaved plane, so column synthesis runs at memory speed
// instead of one strided gather per column).

// 5/3 (F.3.8) on a signal spanning [i0, i1); low/high are gathered inputs.
// `y` is caller scratch with capacity >= n + 4.
static void idwt53_line(const int64_t* low, const int64_t* high, int64_t i0,
                        int64_t i1, int64_t* out, int64_t* y) {
  int64_t n = i1 - i0;
  if (n == 1) {
    out[0] = (i0 % 2 == 0) ? low[0] : (high[0] >> 1);
    return;
  }
  const int64_t off = i0 - 2;
  int64_t ke = 0, ko = 0;
  for (int64_t i = i0; i < i1; ++i) {
    if (((i % 2) + 2) % 2 == 0) y[i - off] = low[ke++];
    else y[i - off] = high[ko++];
  }
  auto ext = [&](int64_t i) {
    int64_t per = 2 * (n - 1);
    int64_t j = (i - i0) % per;
    if (j < 0) j += per;
    if (j >= n) j = per - j;
    return i0 + j;
  };
  auto refresh = [&]() {
    const int64_t pts[4] = {i0 - 2, i0 - 1, i1, i1 + 1};
    for (int64_t i : pts) y[i - off] = y[ext(i) - off];
  };
  refresh();
  for (int64_t i = i0 + (((i0 % 2) + 2) % 2); i < i1; i += 2)
    y[i - off] -= (y[i - 1 - off] + y[i + 1 - off] + 2) >> 2;
  refresh();
  for (int64_t i = i0 + 1 - (((i0 % 2) + 2) % 2); i < i1; i += 2)
    y[i - off] += (y[i - 1 - off] + y[i + 1 - off]) >> 1;
  std::memcpy(out, y + (i0 - off), size_t(n) * sizeof(int64_t));
}

// 9/7 lifting constants (Table F.4)
constexpr double A97 = -1.586134342059924, B97 = -0.052980118572961,
                 G97 = 0.882911075530934, D97 = 0.443506852043971,
                 K97 = 1.230174104914001;

// `y` is caller scratch with capacity >= n + 8.
static void idwt97_line(const double* low, const double* high, int64_t i0,
                        int64_t i1, double* out, double* y) {
  int64_t n = i1 - i0;
  if (n == 1) {
    out[0] = (i0 % 2 == 0) ? low[0] : high[0];
    return;
  }
  const int64_t off = i0 - 4;
  int64_t ke = 0, ko = 0;
  for (int64_t i = i0; i < i1; ++i) {
    if (((i % 2) + 2) % 2 == 0) y[i - off] = low[ke++] * K97;
    else y[i - off] = high[ko++] / K97;
  }
  auto ext = [&](int64_t i) {
    int64_t per = 2 * (n - 1);
    int64_t j = (i - i0) % per;
    if (j < 0) j += per;
    if (j >= n) j = per - j;
    return i0 + j;
  };
  auto refresh = [&]() {
    for (int64_t i = i0 - 4; i < i0; ++i) y[i - off] = y[ext(i) - off];
    for (int64_t i = i1; i < i1 + 4; ++i) y[i - off] = y[ext(i) - off];
  };
  // lifting steps preserve the whole-sample symmetry of the extended signal,
  // so the extension is re-mirrored between steps (matches the oracle)
  const int64_t e0 = i0 + (((i0 % 2) + 2) % 2);      // first even index >= i0
  const int64_t o0 = i0 + 1 - (((i0 % 2) + 2) % 2);  // first odd index >= i0
  refresh();
  for (int64_t i = e0; i < i1; i += 2)
    y[i - off] -= D97 * (y[i - 1 - off] + y[i + 1 - off]);
  refresh();
  for (int64_t i = o0; i < i1; i += 2)
    y[i - off] -= G97 * (y[i - 1 - off] + y[i + 1 - off]);
  refresh();
  for (int64_t i = e0; i < i1; i += 2)
    y[i - off] -= B97 * (y[i - 1 - off] + y[i + 1 - off]);
  refresh();
  for (int64_t i = o0; i < i1; i += 2)
    y[i - off] -= A97 * (y[i - 1 - off] + y[i + 1 - off]);
  std::memcpy(out, y + (i0 - off), size_t(n) * sizeof(double));
}

// a simple row-major matrix of doubles (used for both int64 values — exact
// up to 2^53, guaranteed by the 16-bit + guard-bit envelope — and floats)
struct Mat {
  int64_t rows = 0, cols = 0;
  std::vector<double> v;
  Mat() {}
  Mat(int64_t r, int64_t c) : rows(r), cols(c), v(size_t(r * c), 0.0) {}
  double& at(int64_t y, int64_t x) { return v[size_t(y * cols + x)]; }
  double at(int64_t y, int64_t x) const { return v[size_t(y * cols + x)]; }
};

// A rows×cols contiguous plane of the synthesis value type (int64 for the
// reversible 5/3 path — exact; double for the irreversible 9/7 path).
template <typename T>
struct Plane {
  int64_t rows = 0, cols = 0;
  std::vector<T> v;
  Plane() {}
  Plane(int64_t r, int64_t c) : rows(r), cols(c), v(size_t(r * c), T(0)) {}
  T* row(int64_t y) { return v.data() + size_t(y) * size_t(cols); }
  const T* row(int64_t y) const { return v.data() + size_t(y) * size_t(cols); }
};

// Mirror-extension index for a signal spanning [i0, i0+n) (n >= 2): returns
// the in-range index an out-of-range i reflects to (period 2(n-1)).
static inline int64_t ext_index(int64_t i, int64_t i0, int64_t n) {
  int64_t per = 2 * (n - 1);
  int64_t j = (i - i0) % per;
  if (j < 0) j += per;
  if (j >= n) j = per - j;
  return i0 + j;
}

// Vertical (column) synthesis, executed row-wise: rows of `out` are whole-row
// elementwise lifting steps over an interleaved margin plane. Math identical
// to calling idwt{53,97}_line once per column.
static void v53_plane(const Plane<int64_t>& top, const Plane<int64_t>& bot,
                      int64_t i0, int64_t i1, Plane<int64_t>& out) {
  const int64_t n = i1 - i0, w = out.cols;
  if (n == 1) {
    if (i0 % 2 == 0) {
      std::memcpy(out.row(0), top.row(0), size_t(w) * sizeof(int64_t));
    } else {
      const int64_t* s = bot.row(0);
      int64_t* d = out.row(0);
      for (int64_t x = 0; x < w; ++x) d[x] = s[x] >> 1;
    }
    return;
  }
  Plane<int64_t> y(n + 4, w);  // rows i0-2 .. i1+1
  const int64_t off = i0 - 2;
  int64_t ke = 0, ko = 0;
  for (int64_t i = i0; i < i1; ++i)
    std::memcpy(y.row(i - off),
                (((i % 2) + 2) % 2 == 0) ? top.row(ke++) : bot.row(ko++),
                size_t(w) * sizeof(int64_t));
  auto refresh = [&]() {
    const int64_t pts[4] = {i0 - 2, i0 - 1, i1, i1 + 1};
    for (int64_t i : pts)
      std::memcpy(y.row(i - off), y.row(ext_index(i, i0, n) - off),
                  size_t(w) * sizeof(int64_t));
  };
  const int64_t e0 = i0 + (((i0 % 2) + 2) % 2);
  const int64_t o0 = i0 + 1 - (((i0 % 2) + 2) % 2);
  refresh();
  for (int64_t i = e0; i < i1; i += 2) {
    int64_t* c = y.row(i - off);
    const int64_t* a = y.row(i - 1 - off);
    const int64_t* b = y.row(i + 1 - off);
    for (int64_t x = 0; x < w; ++x) c[x] -= (a[x] + b[x] + 2) >> 2;
  }
  refresh();
  for (int64_t i = o0; i < i1; i += 2) {
    int64_t* c = y.row(i - off);
    const int64_t* a = y.row(i - 1 - off);
    const int64_t* b = y.row(i + 1 - off);
    for (int64_t x = 0; x < w; ++x) c[x] += (a[x] + b[x]) >> 1;
  }
  for (int64_t i = i0; i < i1; ++i)
    std::memcpy(out.row(i - i0), y.row(i - off), size_t(w) * sizeof(int64_t));
}

static void v97_plane(const Plane<double>& top, const Plane<double>& bot,
                      int64_t i0, int64_t i1, Plane<double>& out) {
  const int64_t n = i1 - i0, w = out.cols;
  if (n == 1) {
    std::memcpy(out.row(0), (i0 % 2 == 0) ? top.row(0) : bot.row(0),
                size_t(w) * sizeof(double));
    return;
  }
  Plane<double> y(n + 8, w);  // rows i0-4 .. i1+3
  const int64_t off = i0 - 4;
  int64_t ke = 0, ko = 0;
  for (int64_t i = i0; i < i1; ++i) {
    double* d = y.row(i - off);
    if ((((i % 2) + 2) % 2) == 0) {
      const double* s = top.row(ke++);
      for (int64_t x = 0; x < w; ++x) d[x] = s[x] * K97;
    } else {
      const double* s = bot.row(ko++);
      for (int64_t x = 0; x < w; ++x) d[x] = s[x] / K97;
    }
  }
  auto refresh = [&]() {
    for (int64_t i = i0 - 4; i < i0; ++i)
      std::memcpy(y.row(i - off), y.row(ext_index(i, i0, n) - off),
                  size_t(w) * sizeof(double));
    for (int64_t i = i1; i < i1 + 4; ++i)
      std::memcpy(y.row(i - off), y.row(ext_index(i, i0, n) - off),
                  size_t(w) * sizeof(double));
  };
  const int64_t e0 = i0 + (((i0 % 2) + 2) % 2);
  const int64_t o0 = i0 + 1 - (((i0 % 2) + 2) % 2);
  auto step = [&](int64_t s0, double k) {
    for (int64_t i = s0; i < i1; i += 2) {
      double* c = y.row(i - off);
      const double* a = y.row(i - 1 - off);
      const double* b = y.row(i + 1 - off);
      for (int64_t x = 0; x < w; ++x) c[x] -= k * (a[x] + b[x]);
    }
  };
  refresh();
  step(e0, D97);
  refresh();
  step(o0, G97);
  refresh();
  step(e0, B97);
  refresh();
  step(o0, A97);
  for (int64_t i = i0; i < i1; ++i)
    std::memcpy(out.row(i - i0), y.row(i - off), size_t(w) * sizeof(double));
}

// 2D inverse DWT: iteratively reconstruct from LL upward. Band data arrives
// as double Mats (exact for the reversible path — values fit 2^53); synthesis
// runs on typed planes and converts back to a Mat once at the end.
template <typename T>
static Mat inverse_dwt_t(TileComp& tc,
                         std::vector<std::vector<Mat>>& bands_data) {
  constexpr bool reversible = std::is_same<T, int64_t>::value;
  Plane<T> ll(bands_data[0][0].rows, bands_data[0][0].cols);
  for (size_t i = 0; i < bands_data[0][0].v.size(); ++i)
    ll.v[i] = T(bands_data[0][0].v[i]);
  std::vector<T> lbuf, hbuf, obuf, ybuf;
  for (size_t r = 1; r < tc.resolutions.size(); ++r) {
    auto& res = tc.resolutions[r];
    Mat& hl = bands_data[r][0];
    Mat& lh = bands_data[r][1];
    Mat& hh = bands_data[r][2];
    int64_t x0 = res.x0, y0 = res.y0, x1 = res.x1, y1 = res.y1;
    int64_t w = x1 - x0, h = y1 - y0;
    if (w <= 0 || h <= 0) continue;
    // horizontal pass: rows of (LL|HL) → top, (LH|HH) → bot
    Plane<T> top(ll.rows, w), bot(lh.rows, w);
    lbuf.resize(size_t(std::max(ll.cols, lh.cols) + 1));
    hbuf.resize(size_t(std::max(hl.cols, hh.cols) + 1));
    obuf.resize(size_t(w));
    ybuf.resize(size_t(w) + 8);
    for (int64_t y = 0; y < ll.rows; ++y) {
      std::memcpy(lbuf.data(), ll.row(y), size_t(ll.cols) * sizeof(T));
      for (int64_t i = 0; i < hl.cols; ++i) hbuf[i] = T(hl.at(y, i));
      if constexpr (reversible)
        idwt53_line(lbuf.data(), hbuf.data(), x0, x1, top.row(y), ybuf.data());
      else
        idwt97_line(lbuf.data(), hbuf.data(), x0, x1, top.row(y), ybuf.data());
    }
    for (int64_t y = 0; y < lh.rows; ++y) {
      for (int64_t i = 0; i < lh.cols; ++i) lbuf[i] = T(lh.at(y, i));
      for (int64_t i = 0; i < hh.cols; ++i) hbuf[i] = T(hh.at(y, i));
      if constexpr (reversible)
        idwt53_line(lbuf.data(), hbuf.data(), x0, x1, bot.row(y), ybuf.data());
      else
        idwt97_line(lbuf.data(), hbuf.data(), x0, x1, bot.row(y), ybuf.data());
    }
    // vertical pass: columns of (top|bot), executed row-wise
    Plane<T> nll(h, w);
    if constexpr (reversible)
      v53_plane(top, bot, y0, y1, nll);
    else
      v97_plane(top, bot, y0, y1, nll);
    ll = std::move(nll);
  }
  Mat out(ll.rows, ll.cols);
  for (size_t i = 0; i < ll.v.size(); ++i) out.v[i] = double(ll.v[i]);
  return out;
}

static Mat inverse_dwt(TileComp& tc, std::vector<std::vector<Mat>>& bands_data,
                       bool reversible) {
  return reversible ? inverse_dwt_t<int64_t>(tc, bands_data)
                    : inverse_dwt_t<double>(tc, bands_data);
}

// ---------------------------------------------------------------------------
// codestream parsing

struct TileData {
  std::vector<uint8_t> data;
  bool has_cod = false, has_qcd = false;
  Cod cod_override{0, (const uint8_t*)"\0\4\4\0\1", 5, false};
  Qcd qcd_override;
  std::vector<std::pair<int, Cod>> coc_over;
  std::vector<std::pair<int, Qcd>> qcc_over;
};

static const uint8_t* extract_codestream(const uint8_t* data, int64_t n,
                                         int64_t* out_n) {
  if (n >= 2 && data[0] == 0xFF && data[1] == 0x4F) {
    *out_n = n;
    return data;
  }
  static const uint8_t jp2sig[8] = {0, 0, 0, 0x0C, 'j', 'P', ' ', ' '};
  if (n >= 8 && std::memcmp(data, jp2sig, 8) == 0) {
    int64_t i = 0;
    while (i + 8 <= n) {
      int64_t blen = be32(data + i);
      const uint8_t* btype = data + i + 4;
      int64_t hdr = 8;
      if (blen == 1) {
        if (i + 16 > n) throw Err("bad JP2 box length");
        blen = (int64_t(be32(data + i + 8)) << 32) | be32(data + i + 12);
        hdr = 16;
      } else if (blen == 0) {
        blen = n - i;
      }
      if (std::memcmp(btype, "jp2c", 4) == 0) {
        if (i + blen > n) blen = n - i;
        *out_n = blen - hdr;
        return data + i + hdr;
      }
      if (blen < hdr) throw Err("bad JP2 box length");
      i += blen;
    }
    throw Err("JP2 container without jp2c box");
  }
  throw Err("not a JPEG 2000 stream");
}

struct MainHeader {
  Siz siz;
  Cod cod;
  Qcd qcd;
  std::vector<std::pair<int, Cod>> coc;
  std::vector<std::pair<int, Qcd>> qcc;
  int64_t pos;

  MainHeader(Siz s, Cod c, Qcd q, int64_t p)
      : siz(s), cod(c), qcd(q), pos(p) {}
};

static MainHeader parse_main_header(const uint8_t* cs, int64_t n) {
  if (n < 2 || cs[0] != 0xFF || cs[1] != 0x4F) throw Err("missing SOC");
  int64_t i = 2;
  bool have_siz = false, have_cod = false, have_qcd = false;
  // placeholders; replaced when markers are parsed
  std::vector<uint8_t> siz_seg, cod_seg, qcd_seg;
  std::vector<std::pair<int, Cod>> coc;
  std::vector<std::pair<int, Qcd>> qcc;
  int ncomp_so_far = 0;
  while (i + 4 <= n) {
    uint16_t marker = (uint16_t(cs[i]) << 8) | cs[i + 1];
    if (marker == SOT) break;
    if (marker < 0xFF30) throw Err("bad marker");
    int seglen = be16(cs + i + 2);
    if (seglen < 2 || i + 2 + seglen > n) throw Err("truncated marker segment");
    const uint8_t* seg = cs + i + 4;
    int sn = seglen - 2;
    if (marker == SIZm) {
      siz_seg.assign(seg, seg + sn);
      have_siz = true;
      if (sn >= 36) ncomp_so_far = be16(seg + 34);
    } else if (marker == CODm) {
      cod_seg.assign(seg, seg + sn);
      have_cod = true;
    } else if (marker == COCm) {
      if (!have_siz) throw Err("COC before SIZ");
      int ci = ncomp_so_far < 257 ? seg[0] : be16(seg);
      int off = ncomp_so_far < 257 ? 1 : 2;
      if (sn < off + 1) throw Err("short COC");
      coc.push_back({ci, Cod(seg[off], seg + off + 1, sn - off - 1, false)});
    } else if (marker == QCDm) {
      qcd_seg.assign(seg, seg + sn);
      have_qcd = true;
    } else if (marker == QCCm) {
      if (!have_siz) throw Err("QCC before SIZ");
      int ci = ncomp_so_far < 257 ? seg[0] : be16(seg);
      int off = ncomp_so_far < 257 ? 1 : 2;
      if (sn < off) throw Err("short QCC");
      qcc.push_back({ci, Qcd(seg + off, sn - off)});
    } else if (marker == RGNm || marker == POCm || marker == PPMm ||
               marker == PPTm) {
      throw Err("RGN/POC/PPM/PPT not supported");
    }
    i += 2 + seglen;
  }
  if (!have_siz || !have_cod || !have_qcd) throw Err("missing SIZ/COD/QCD");
  MainHeader h(Siz(siz_seg.data(), int(siz_seg.size())),
               parse_cod(cod_seg.data(), int(cod_seg.size())),
               Qcd(qcd_seg.data(), int(qcd_seg.size())), i);
  h.coc = std::move(coc);
  h.qcc = std::move(qcc);
  return h;
}

static void parse_tiles(const uint8_t* cs, int64_t n, int64_t start,
                        const Siz& siz, std::vector<TileData>& tiles) {
  int64_t i = start;
  while (i + 2 <= n) {
    uint16_t marker = (uint16_t(cs[i]) << 8) | cs[i + 1];
    if (marker == EOC) return;
    if (marker != SOT) throw Err("expected SOT/EOC");
    if (i + 12 > n) throw Err("truncated SOT");
    int isot = be16(cs + i + 4);
    int64_t psot = be32(cs + i + 6);
    if (isot >= siz.ntx * siz.nty) throw Err("tile index out of range");
    int64_t tp_end = psot ? i + psot : n - 2;
    if (tp_end > n) throw Err("tile-part overruns stream");
    TileData& tile = tiles[isot];
    int64_t j = i + 12;
    bool found_sod = false;
    while (j + 4 <= n) {
      uint16_t m2 = (uint16_t(cs[j]) << 8) | cs[j + 1];
      if (m2 == SOD) {
        j += 2;
        found_sod = true;
        break;
      }
      int l2 = be16(cs + j + 2);
      if (l2 < 2 || j + 2 + l2 > n) throw Err("truncated tile-part header");
      const uint8_t* seg = cs + j + 4;
      int sn = l2 - 2;
      if (m2 == CODm) {
        tile.cod_override = parse_cod(seg, sn);
        tile.has_cod = true;
      } else if (m2 == QCDm) {
        tile.qcd_override = Qcd(seg, sn);
        tile.has_qcd = true;
      } else if (m2 == COCm) {
        if (sn < 2) throw Err("short tile COC");
        tile.coc_over.push_back({seg[0], Cod(seg[1], seg + 2, sn - 2, false)});
      } else if (m2 == QCCm) {
        if (sn < 1) throw Err("short tile QCC");
        tile.qcc_over.push_back({seg[0], Qcd(seg + 1, sn - 1)});
      } else if (m2 == RGNm || m2 == POCm || m2 == PPTm) {
        throw Err("RGN/POC/PPT not supported in tile header");
      }
      j += 2 + l2;
    }
    if (!found_sod) throw Err("tile-part without SOD");
    tile.data.insert(tile.data.end(), cs + j, cs + tp_end);
    i = tp_end;
  }
  throw Err("missing EOC");
}

template <typename K, typename V>
static const V* find_pair(const std::vector<std::pair<K, V>>& v, K key) {
  for (auto& kv : v)
    if (kv.first == key) return &kv.second;
  return nullptr;
}

// ---------------------------------------------------------------------------
// top-level decode

static void decode_impl(const uint8_t* raw, int64_t raw_n, int32_t* out,
                        int64_t out_capacity) {
  int64_t n;
  const uint8_t* cs = extract_codestream(raw, raw_n, &n);
  MainHeader hdr = parse_main_header(cs, n);
  const Siz& siz = hdr.siz;
  int64_t img_w = siz.xsiz - siz.xosiz, img_h = siz.ysiz - siz.yosiz;
  if (img_h * img_w * siz.ncomp > out_capacity) throw Err("output too small");
  std::vector<TileData> tiles(size_t(siz.ntx * siz.nty));
  std::vector<bool> present(size_t(siz.ntx * siz.nty), false);
  {
    // mark present tiles by re-walking SOTs (parse_tiles fills data)
    parse_tiles(cs, n, hdr.pos, siz, tiles);
    for (size_t t = 0; t < tiles.size(); ++t) present[t] = !tiles[t].data.empty() ||
        tiles[t].has_cod || tiles[t].has_qcd;
  }
  // initialize output to the DC-shift default (absent tiles stay mid-gray /
  // zero): value 0 before shift
  std::vector<double> plane0(size_t(img_h) * img_w * siz.ncomp, 0.0);

  for (int64_t tidx = 0; tidx < siz.ntx * siz.nty; ++tidx) {
    TileData& tile = tiles[tidx];
    if (tile.data.empty() && !present[tidx]) continue;
    int64_t p = tidx % siz.ntx, q = tidx / siz.ntx;
    int64_t tx0 = std::max(siz.xtosiz + p * siz.xtsiz, siz.xosiz);
    int64_t tx1 = std::min(siz.xtosiz + (p + 1) * siz.xtsiz, siz.xsiz);
    int64_t ty0 = std::max(siz.ytosiz + q * siz.ytsiz, siz.yosiz);
    int64_t ty1 = std::min(siz.ytosiz + (q + 1) * siz.ytsiz, siz.ysiz);

    const Cod& base_cod = tile.has_cod ? tile.cod_override : hdr.cod;
    const Qcd& base_qcd = tile.has_qcd ? tile.qcd_override : hdr.qcd;
    std::vector<Cod> cods;       // owned per-component Cods
    std::vector<const Qcd*> qcds;
    for (int c = 0; c < siz.ncomp; ++c) {
      const Cod* cc = find_pair(tile.coc_over, c);
      if (!cc) cc = find_pair(hdr.coc, c);
      Cod comp_cod = cc ? *cc : base_cod;
      if (cc) comp_cod.clone_sg(base_cod);
      cods.push_back(comp_cod);
      const Qcd* qc = find_pair(tile.qcc_over, c);
      if (!qc) qc = find_pair(hdr.qcc, c);
      qcds.push_back(qc ? qc : &base_qcd);
    }
    std::vector<TileComp> tcs;
    for (int c = 0; c < siz.ncomp; ++c)
      tcs.emplace_back(cods[c], *qcds[c], tx0, ty0, tx1, ty1);

    // read packets in progression order (truncation → stop)
    if (std::getenv("J2K_DEBUG")) {
      std::fprintf(stderr,
                   "[j2k] cod: prog=%d layers=%d levels=%d xcb=%d ycb=%d "
                   "transform=%d ncomp=%d\n",
                   base_cod.progression, base_cod.layers, base_cod.levels,
                   base_cod.xcb, base_cod.ycb, base_cod.transform, siz.ncomp);
      for (size_t c = 0; c < tcs.size(); ++c)
        for (auto& res : tcs[c].resolutions)
          std::fprintf(stderr,
                       "[j2k]  c=%zu r=%d box=(%lld,%lld,%lld,%lld) pp=(%d,%d) "
                       "npw=%lld nph=%lld bands=%zu\n",
                       c, res.r, (long long)res.x0, (long long)res.y0,
                       (long long)res.x1, (long long)res.y1, res.ppx, res.ppy,
                       (long long)res.npw, (long long)res.nph, res.bands.size());
    }
    auto order = packet_order(tcs, base_cod);
    const uint8_t* td = tile.data.data();
    int64_t tn = int64_t(tile.data.size());
    int64_t dpos = 0;
    int npk = 0;
    for (auto& pk : order) {
      auto& res = tcs[pk.c].resolutions[pk.r];
      if (pk.p >= res.npw * res.nph) continue;
      if (dpos >= tn) break;
      dpos = read_packet(td, tn, dpos, res, pk.p, pk.l, *tcs[pk.c].cod);
      ++npk;
    }
    if (std::getenv("J2K_DEBUG")) {
      int ninc = 0;
      int64_t nbytes = 0;
      for (auto& tc : tcs)
        for (auto& res : tc.resolutions)
          for (auto& band : res.bands)
            for (auto& blocks : band.cblocks)
              for (auto& cb : blocks)
                if (cb.included) { ++ninc; nbytes += int64_t(cb.data.size()); }
      std::fprintf(stderr,
                   "[j2k] tile=%lld tn=%lld order=%zu read=%d dpos=%lld "
                   "included_cbs=%d cb_bytes=%lld\n",
                   (long long)tidx, (long long)tn, order.size(), npk,
                   (long long)dpos, ninc, (long long)nbytes);
    }

    // decode code-blocks, dequantize, inverse DWT
    std::vector<Mat> comps;
    std::vector<bool> comp_rev;
    for (int c = 0; c < siz.ncomp; ++c) {
      TileComp& tc = tcs[c];
      bool reversible = tc.cod->transform == 1;
      comp_rev.push_back(reversible);
      std::vector<std::vector<Mat>> bands_data;
      for (size_t r = 0; r < tc.resolutions.size(); ++r) {
        auto& res = tc.resolutions[r];
        std::vector<Mat> rb;
        for (auto& band : res.bands) {
          int64_t bw = band.x1 - band.x0, bh = band.y1 - band.y0;
          Mat arr(std::max<int64_t>(bh, 0), std::max<int64_t>(bw, 0));
          int rbit = siz.prec[c] +
                     (band.btype == 1 || band.btype == 2 ? 1
                      : band.btype == 3                  ? 2
                                                         : 0);
          int guard = qcds[c]->guard;
          int mb = band.exp + guard - 1;
          double delta =
              std::pow(2.0, rbit - band.exp) * (1.0 + band.mant / 2048.0);
          for (auto& blocks : band.cblocks) {
            for (auto& cb : blocks) {
              if (!cb.included || cb.npasses == 0) continue;
              int w = int(cb.x1 - cb.x0), h = int(cb.y1 - cb.y0);
              std::vector<int64_t> mag2;
              std::vector<int8_t> sign;
              decode_codeblock(cb.data.data(), int64_t(cb.data.size()), w, h,
                               band.family(), cb.zero_planes, cb.npasses, mb,
                               &mag2, &sign);
              for (int yy = 0; yy < h; ++yy)
                for (int xx = 0; xx < w; ++xx) {
                  int64_t m2 = mag2[size_t(yy) * w + xx];
                  int s = sign[size_t(yy) * w + xx];
                  double val;
                  if (reversible) {
                    val = double((m2 >> 1) * s);
                  } else {
                    val = double(m2) * s * (delta * 0.5);
                  }
                  arr.at(cb.y0 - band.y0 + yy, cb.x0 - band.x0 + xx) = val;
                }
            }
          }
          rb.push_back(std::move(arr));
        }
        bands_data.push_back(std::move(rb));
      }
      comps.push_back(inverse_dwt(tc, bands_data, reversible));
    }

    // inverse MCT (G.2/G.3)
    if (base_cod.mct && siz.ncomp >= 3) {
      Mat& c0 = comps[0];
      Mat& c1 = comps[1];
      Mat& c2 = comps[2];
      int64_t rows = c0.rows, cols = c0.cols;
      if (c1.rows != rows || c2.rows != rows) throw Err("MCT shape mismatch");
      if (base_cod.transform == 1) {  // RCT (integer; values exact in double)
        for (int64_t y = 0; y < rows; ++y)
          for (int64_t x = 0; x < cols; ++x) {
            int64_t a = int64_t(c0.at(y, x)), b = int64_t(c1.at(y, x)),
                    cc = int64_t(c2.at(y, x));
            // floor((b + cc) / 4) via arithmetic shift
            int64_t g = a - ((b + cc) >> 2);
            int64_t r_ = cc + g, b_ = b + g;
            c0.at(y, x) = double(r_);
            c1.at(y, x) = double(g);
            c2.at(y, x) = double(b_);
          }
      } else {  // ICT
        for (int64_t y = 0; y < rows; ++y)
          for (int64_t x = 0; x < cols; ++x) {
            double a = c0.at(y, x), b = c1.at(y, x), cc = c2.at(y, x);
            double r_ = a + 1.402 * cc;
            double g = a - 0.344136 * b - 0.714136 * cc;
            double b_ = a + 1.772 * b;
            c0.at(y, x) = r_;
            c1.at(y, x) = g;
            c2.at(y, x) = b_;
          }
      }
    }

    for (int c = 0; c < siz.ncomp; ++c) {
      Mat& arr = comps[c];
      double shift = siz.signed_[c] ? 0.0 : double(int64_t(1) << (siz.prec[c] - 1));
      for (int64_t y = 0; y < ty1 - ty0; ++y)
        for (int64_t x = 0; x < tx1 - tx0; ++x) {
          int64_t gy = ty0 - siz.yosiz + y, gx = tx0 - siz.xosiz + x;
          plane0[size_t((gy * img_w + gx) * siz.ncomp + c)] =
              (y < arr.rows && x < arr.cols ? arr.at(y, x) : 0.0) + shift;
        }
    }
  }

  // clamp + round (half-even, matching numpy rint)
  for (int c = 0; c < siz.ncomp; ++c) {
    int64_t lo, hi;
    if (siz.signed_[c]) {
      lo = -(int64_t(1) << (siz.prec[c] - 1));
      hi = (int64_t(1) << (siz.prec[c] - 1)) - 1;
    } else {
      lo = 0;
      hi = (int64_t(1) << siz.prec[c]) - 1;
    }
    for (int64_t i = c; i < img_h * img_w * siz.ncomp; i += siz.ncomp) {
      double v = std::nearbyint(plane0[size_t(i)]);
      if (v < double(lo)) v = double(lo);
      if (v > double(hi)) v = double(hi);
      out[i] = int32_t(v);
    }
  }
}

}  // namespace

extern "C" {

int j2k_probe(const uint8_t* data, int64_t size, int* rows, int* cols,
              int* ncomp, int* precision, int* signed_out) {
  try {
    int64_t n;
    const uint8_t* cs = extract_codestream(data, size, &n);
    if (n < 2 || cs[0] != 0xFF || cs[1] != 0x4F) return 2;
    int64_t i = 2;
    while (i + 4 <= n) {
      uint16_t marker = (uint16_t(cs[i]) << 8) | cs[i + 1];
      int seglen = be16(cs + i + 2);
      if (marker == SIZm) {
        if (seglen < 2 || i + 2 + seglen > n) return 3;
        Siz siz(cs + i + 4, seglen - 2);
        *rows = int(siz.ysiz - siz.yosiz);
        *cols = int(siz.xsiz - siz.xosiz);
        *ncomp = siz.ncomp;
        *precision = siz.prec[0];
        *signed_out = siz.signed_[0] ? 1 : 0;
        return 0;
      }
      if (marker == SOT) break;
      if (seglen < 2) return 4;
      i += 2 + seglen;
    }
    return 5;
  } catch (...) {
    return 1;
  }
}

int j2k_decode(const uint8_t* data, int64_t size, int32_t* out,
               int64_t out_capacity) {
  try {
    decode_impl(data, size, out, out_capacity);
    return 0;
  } catch (...) {
    return 1;
  }
}

}  // extern "C"
