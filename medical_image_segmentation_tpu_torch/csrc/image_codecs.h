// Baseline JPEG and PNG decoders of the MIS store reader (mis_loader.cpp).
//
// They give the pixels the reference reader gets from libjpeg-turbo and
// libpng (csrc/mis_loader.cpp of the JAX package) and link no library but
// the C++ runtime: the store reader builds with g++ alone.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace mis_codecs {

// Return codes, shared with mis_loader.cpp. -1, -3, -6 and -8 are the
// reference reader's; the rest name a stream that is well formed but that
// these decoders do not carry (the reference decodes it through libjpeg or
// libpng).
constexpr int kCorrupt = -1;             // malformed or truncated stream
constexpr int kWrongChannels = -3;       // channels other than 1 or 3 asked for
constexpr int kEmpty = -6;               // zero height or width
constexpr int kWrongFormat = -8;         // a u16 store's PNG that is not 16-bit gray
constexpr int kJpegProgressive = -11;    // progressive JPEG (SOF2, SOF6, SOF10, SOF14)
constexpr int kJpegNotHuffman = -12;     // arithmetic-coded, lossless or hierarchical JPEG
constexpr int kJpegPrecision = -13;      // JPEG samples of other than 8 bits
constexpr int kJpegLayout = -14;         // JPEG component layout not carried (see jpeg_decode.cpp)
constexpr int kPngColorSpace = -15;      // PNG colour management not carried (see png_decode.cpp)

// A box of output pixels: rows [y0, y1), columns [x0, x1).
struct Box {
  int y0, y1, x0, x1;
};

// One JPEG stream: parse() reads the markers up to the scan; decode()
// writes the box's pixels as (y1 - y0, x1 - x0, want_c) uint8, Huffman-
// decoding only the MCU rows down to the box's bottom and running the
// inverse DCT only on the blocks the box (and the chroma upsampling around
// it) reads. Not thread-safe: one decoder a thread.
class JpegDecoder {
 public:
  int parse(const uint8_t* data, size_t size);
  int height() const { return height_; }
  int width() const { return width_; }
  int decode(int want_c, Box box, std::vector<uint8_t>& out);

  struct Bits;  // the entropy-coded bits (jpeg_decode.cpp)

 private:
  struct Huff {
    bool defined = false;
    uint8_t counts[17] = {};
    uint8_t values[256] = {};
    int32_t maxcode[18] = {};
    int32_t valoffset[18] = {};
    uint16_t fast[512] = {};  // 9-bit lookahead: (length << 8) | symbol, 0 = longer code
    // AC tables, 10-bit lookahead of a code and its extra bits together:
    // (value << 16) | (size << 9) | (run << 5) | bits, 0 = longer
    int32_t fast_ac[1024] = {};
  };
  struct Component {
    int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
    int down_w = 0, down_h = 0;      // samples of the component in the image
    int blocks_w = 0, blocks_h = 0;  // blocks of its plane (whole MCUs)
    int need_y0 = 0, need_y1 = -1, need_x0 = 0, need_x1 = -1;  // blocks to transform
    std::vector<uint8_t> plane;
  };

  int derive(Huff& t, bool dc);
  int decode_scan(int last_mcu_row, bool want_color);

  const uint8_t* data_ = nullptr;
  size_t size_ = 0;
  size_t scan_pos_ = 0;  // first entropy-coded byte
  int height_ = 0, width_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1;
  int restart_ = 0;
  int scan_comps_[4] = {};
  int nscan_ = 0;
  uint16_t quant_[4][64] = {};
  bool quant_defined_[4] = {};
  Huff dc_[4], ac_[4];
  Component comp_[4];
};

// PNG → uint8 (h, w, want_c) as the reference's libpng calls give it:
// 16-bit samples stripped to their high byte, palette expanded, gray below
// 8 bits scaled, alpha stripped, gray → RGB or RGB → gray
// (png_set_rgb_to_gray(png, 1, -1, -1)). want_c is 1 or 3.
int decode_png(const uint8_t* data, size_t size, int want_c,
               std::vector<uint8_t>& out, int* h, int* w);

// 16-bit gray PNG → host-endian uint16 (h, w); kWrongFormat for any other.
int decode_png16(const uint8_t* data, size_t size, int want_c,
                 std::vector<uint16_t>& out, int* h, int* w);

}  // namespace mis_codecs
