// MIS store loader — multithreaded mmap + decode into caller-provided
// batch buffers. The port's copy of the JAX package's csrc/mis_loader.cpp
// (the same store format, thread pool, extern "C" API and error codes),
// whose JPEG and PNG decoders are the port's own (jpeg_decode.cpp,
// png_decode.cpp): it links no codec library, so it builds with g++ alone.
//
// This is the native half of the input pipeline, replacing the role of
// FFCV's C extension + Numba-compiled pipelines in the reference
// (ffcv.loader.Loader, see SURVEY.md §2.3: libffcv JPEG decode/resize,
// memory-mapped .beton page cache, epoch-pipelined worker threads).
// Responsibilities kept native:
//   - mmap the store once; rely on the OS page cache (os_cache=True
//     analogue) and MADV_WILLNEED readahead per batch;
//   - decode RAW (memcpy) / JPEG / PNG / JPEG-LS samples with a
//     worker-thread pool;
//   - emit fixed-shape uint8 batches (B, H, W, C) + int32 labels straight
//     into a caller buffer that Python copies to the card.
// Randomized cropping/augmentation is deliberately NOT here — it runs on
// the card (csrc/two_view_augment.cu); the host's only job is bytes →
// pixels, or with host pre-crop bytes → crop-resized views.
//
// Build (data/store/native.py): g++ -O3 -march=native -std=c++17 -shared
//   -fPIC mis_loader.cpp jpeg_decode.cpp png_decode.cpp dicom_codecs.cpp
//   jpegls_codec.cpp j2k_codec.cpp -pthread -o libmisloader-port-<digest>.so

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "image_codecs.h"

// JPEG-LS codec, linked into the same shared object (csrc/jpegls_codec.cpp)
extern "C" int jpegls_probe(const uint8_t* data, int64_t size, int* rows,
                            int* cols, int* ncomp, int* precision);
extern "C" int jpegls_decode(const uint8_t* data, int64_t size, uint16_t* out,
                             int64_t out_capacity);
extern "C" int jpegls_decode_rows(const uint8_t* data, int64_t size,
                                  uint16_t* out, int64_t out_capacity,
                                  int max_rows);

namespace {

constexpr uint64_t kHeaderSize = 64;
constexpr uint64_t kRecordSize = 32;
constexpr uint8_t kCodecRaw = 0;
constexpr uint8_t kCodecJpeg = 1;
constexpr uint8_t kCodecPng = 2;
constexpr uint8_t kCodecJls = 3;   // JPEG-LS (csrc/jpegls_codec.cpp)
constexpr uint32_t kFlagU16 = 1;   // header flag: samples are uint16 LE

#pragma pack(push, 1)
struct Header {
  char magic[8];
  uint32_t version;
  uint32_t flags;
  uint64_t num_samples;
  uint16_t height;
  uint16_t width;
  uint8_t channels;
  uint8_t default_codec;
  uint8_t label_dtype;
  uint8_t pad;
};

struct Record {
  uint64_t offset;
  uint64_t length;
  uint16_t height;
  uint16_t width;
  uint8_t channels;
  uint8_t codec;
  int16_t pad;
  int32_t label;
  int32_t reserved;
};
#pragma pack(pop)

static_assert(sizeof(Record) == kRecordSize, "record layout");

// lazily-created persistent worker pool: fetch calls dispatch a shared
// work function; threads persist across batches (FFCV-style epoch pipeline
// workers) instead of paying create/join per batch.
struct WorkerPool {
  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv_start, cv_done;
  std::function<void()> work;   // claimed cooperatively via the atomic in fetch
  uint64_t generation = 0;
  int started = 0;   // workers that claimed the current generation
  int running = 0;
  bool shutdown = false;

  void ensure(int n) {
    std::unique_lock<std::mutex> lk(mu);
    while ((int)threads.size() < n) {
      threads.emplace_back([this] {
        uint64_t seen = 0;
        while (true) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv_start.wait(lk, [&] { return shutdown || generation != seen; });
            if (shutdown) return;
            seen = generation;
            job = work;
            ++started;
            ++running;
          }
          job();
          {
            std::unique_lock<std::mutex> lk(mu);
            --running;
            cv_done.notify_all();
          }
        }
      });
    }
  }

  // run `job` on `n` workers + the caller thread; returns when all done
  void run(const std::function<void()>& job, int n) {
    ensure(n);
    int expect;
    {
      std::unique_lock<std::mutex> lk(mu);
      work = job;
      started = 0;
      expect = (int)threads.size();
      ++generation;
      cv_start.notify_all();
    }
    job();  // caller participates
    // wait until EVERY worker has claimed this generation AND finished —
    // returning while an idle worker still holds a pending claim would let
    // it run a dangling closure after the caller's stack unwinds
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return started == expect && running == 0; });
  }

  ~WorkerPool() {
    {
      std::unique_lock<std::mutex> lk(mu);
      shutdown = true;
      cv_start.notify_all();
    }
    for (auto& t : threads) t.join();
  }
};

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  Header header{};
  const Record* records = nullptr;
  WorkerPool pool;
};

// ---------------------------------------------------------------------------
// decode helpers
// ---------------------------------------------------------------------------

// one JPEG decoder a worker thread (its tables and planes are reused)
mis_codecs::JpegDecoder& jpeg_decoder() {
  thread_local mis_codecs::JpegDecoder dec;
  return dec;
}

// decode a whole JPEG into tmp (h*w*want_c); returns 0 and sets h/w
int decode_jpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>& tmp,
                int want_c, int* h, int* w) {
  mis_codecs::JpegDecoder& dec = jpeg_decoder();
  int rc = dec.parse(buf, len);
  if (rc != 0) return rc;
  *h = dec.height();
  *w = dec.width();
  return dec.decode(want_c, {0, *h, 0, *w}, tmp);
}

int decode_png(const uint8_t* buf, size_t len, std::vector<uint8_t>& tmp,
               int want_c, int* h, int* w) {
  return mis_codecs::decode_png(buf, len, want_c, tmp, h, w);
}

// 16-bit grayscale PNG → host-endian uint16 (u16 stores are 1-channel; the
// writer emits PNG_COLOR_TYPE_GRAY bit_depth 16, see store/writer.py)
int decode_png16(const uint8_t* buf, size_t len, std::vector<uint16_t>& tmp,
                 int want_c, int* h, int* w) {
  return mis_codecs::decode_png16(buf, len, want_c, tmp, h, w);
}

// JPEG-LS → uint16 plane(s); the probe supplies dims so the output buffer
// is exact. Precision <= 16; u8 callers narrow after checking precision.
int decode_jls16(const uint8_t* buf, size_t len, std::vector<uint16_t>& tmp,
                 int want_c, int* h, int* w, int* precision) {
  int rows = 0, cols = 0, ncomp = 0, prec = 0;
  if (jpegls_probe(buf, (int64_t)len, &rows, &cols, &ncomp, &prec) != 0) return -9;
  if (ncomp != want_c || rows <= 0 || cols <= 0) return -3;
  tmp.resize(size_t(rows) * cols * ncomp);
  if (jpegls_decode(buf, (int64_t)len, tmp.data(), (int64_t)tmp.size()) != 0) return -9;
  *h = rows;
  *w = cols;
  *precision = prec;
  return 0;
}

void clamp_window(const float* p, int h, int w,
                  float* y0, float* x0, float* ch, float* cw);  // below

// JPEG-LS crop-at-decode: stop entropy-decoding after the crop windows'
// union LAST ROW (+1 px bilinear margin). T.87 is line-sequential with
// causal contexts, so the prefix decode is bit-identical to a truncated
// full decode (columns cannot be skipped — every sample feeds the
// left-to-right context chain); RRC windows average well above half the
// image height, so this is a bounded (~1.1-1.2x) but free win — the JLS
// analogue of decode_jpeg_region's stop below the box.
// Decodes rows [0, dec_rows) full-width into tmp; reports full dims.
int decode_jls16_rows(const uint8_t* buf, size_t len, std::vector<uint16_t>& tmp,
                      int want_c, const float* params, int views,
                      int* h, int* w, int* dec_rows, int* precision) {
  int rows = 0, cols = 0, ncomp = 0, prec = 0;
  if (jpegls_probe(buf, (int64_t)len, &rows, &cols, &ncomp, &prec) != 0) return -9;
  if (ncomp != want_c || rows <= 0 || cols <= 0) return -3;
  float yhi = 0.f;
  for (int v = 0; v < views; ++v) {
    float y0, x0, ch, cw;
    clamp_window(params + v * 5, rows, cols, &y0, &x0, &ch, &cw);
    yhi = std::max(yhi, y0 + ch);
  }
  int y_hi = std::min(rows, (int)yhi + 2);
  if (y_hi < 1) y_hi = 1;
  tmp.resize(size_t(y_hi) * cols * ncomp);
  if (jpegls_decode_rows(buf, (int64_t)len, tmp.data(), (int64_t)tmp.size(),
                         y_hi) != 0)
    return -9;
  *h = rows;
  *w = cols;
  *dec_rows = y_hi;
  *precision = prec;
  return 0;
}

// nearest-neighbor place/resize of tmp (sh, sw, c) into out (oh, ow, c).
template <typename T>
void place(const T* src, int sh, int sw, T* out, int oh, int ow, int c) {
  if (sh == oh && sw == ow) {
    memcpy(out, src, size_t(oh) * ow * c * sizeof(T));
    return;
  }
  for (int y = 0; y < oh; ++y) {
    int sy = (int)(((int64_t)y * sh) / oh);
    const T* srow = src + size_t(sy) * sw * c;
    T* orow = out + size_t(y) * ow * c;
    for (int x = 0; x < ow; ++x) {
      int sx = (int)(((int64_t)x * sw) / ow);
      memcpy(orow + size_t(x) * c, srow + size_t(sx) * c, c * sizeof(T));
    }
  }
}

// bilinear crop-resize of one channel-interleaved image into a view.
// Half-pixel convention matching the device resampler exactly
// (ops/augment.py::_resize_matrix): src = start + (i+0.5)*size/out - 0.5,
// clipped to the (h, w) image, 2-tap lerp; a horizontal flip mirrors the
// OUTPUT coordinate. Output rounds to nearest — same quantization the
// reference's FFCV/torchvision uint8 pipeline applies after
// RandomResizedCrop. `src` holds only the decoded region (rh, rw) at image
// offset (oy, ox); the taps are computed in image coordinates, so a view
// does not depend on the region's extent. Every product and sum rounds on
// its own (no fused multiply-add), so the views equal the numpy route's
// (data/host_precrop.py::crop_resize_bilinear_np) on any host.
#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")
template <typename T>
void crop_resize_bilinear(const T* src, int h, int w, int oy, int ox, int rh, int rw, int c,
                          float y0, float x0, float ch, float cw, int flip,
                          T* out, int vh, int vw) {
  const int sh = h, sw = w;
  const float sy = ch / vh, sx = cw / vw;
  // precompute x taps once per row sweep
  thread_local std::vector<int> xl_v, xh_v;
  thread_local std::vector<float> xf_v;
  xl_v.resize(vw);
  xh_v.resize(vw);
  xf_v.resize(vw);
  for (int j = 0; j < vw; ++j) {
    float pos = flip ? (vw - (j + 0.5f)) : (j + 0.5f);
    float fx = x0 + pos * sx - 0.5f;
    if (fx < 0.f) fx = 0.f;
    const float mx = float(sw - 1);
    if (fx > mx) fx = mx;
    int lo = (int)fx;
    xl_v[j] = std::min(std::max(lo - ox, 0), rw - 1);
    xh_v[j] = std::min(std::max((lo + 1 < sw ? lo + 1 : lo) - ox, 0), rw - 1);
    xf_v[j] = fx - lo;
  }
  for (int i = 0; i < vh; ++i) {
    float fy = y0 + (i + 0.5f) * sy - 0.5f;
    if (fy < 0.f) fy = 0.f;
    const float my = float(sh - 1);
    if (fy > my) fy = my;
    int ylo = (int)fy;
    int yhi = ylo + 1 < sh ? ylo + 1 : ylo;
    float yf = fy - ylo;
    const T* r0 = src + size_t(std::min(std::max(ylo - oy, 0), rh - 1)) * rw * c;
    const T* r1 = src + size_t(std::min(std::max(yhi - oy, 0), rh - 1)) * rw * c;
    T* orow = out + size_t(i) * vw * c;
    for (int j = 0; j < vw; ++j) {
      const int xl = xl_v[j] * c, xh = xh_v[j] * c;
      const float xf = xf_v[j];
      for (int k = 0; k < c; ++k) {
        float top = r0[xl + k] + (float(r0[xh + k]) - float(r0[xl + k])) * xf;
        float bot = r1[xl + k] + (float(r1[xh + k]) - float(r1[xl + k])) * xf;
        float v = top + (bot - top) * yf;
        orow[size_t(j) * c + k] = (T)(v + 0.5f);
      }
    }
  }
}
#pragma GCC pop_options

// clamp one (y0, x0, crop_h, crop_w) window to an h x w image — degenerate
// or out-of-range windows clamp rather than fault (the caller samples
// windows in float and rounding can push y0+ch epsilon past the edge).
// Shared by the decode-window union and the per-view resample so both see
// identical geometry.
void clamp_window(const float* p, int h, int w,
                  float* y0, float* x0, float* ch, float* cw) {
  float fch = p[2], fcw = p[3];
  if (!(fch >= 1.f)) fch = 1.f;
  if (!(fcw >= 1.f)) fcw = 1.f;
  if (fch > h) fch = (float)h;
  if (fcw > w) fcw = (float)w;
  float fy0 = p[0], fx0 = p[1];
  if (!(fy0 >= 0.f)) fy0 = 0.f;
  if (!(fx0 >= 0.f)) fx0 = 0.f;
  if (fy0 > h - fch) fy0 = h - fch;
  if (fx0 > w - fcw) fx0 = w - fcw;
  *y0 = fy0;
  *x0 = fx0;
  *ch = fch;
  *cw = fcw;
}

// decode only the union bounding box of the clamped crop windows (+-1 px
// bilinear margin) — the FFCV RandomResizedCrop-at-decode trick: SSL crop
// windows average roughly half the stored image, so the rows below the box
// are never Huffman-decoded and the blocks outside it never transformed
// (jpeg_decode.cpp). Outputs the full image dims plus the decoded region's
// offset/size; pixels land in tmp as a (bh, bw, c) block, each equal to the
// whole image's.
int decode_jpeg_region(const uint8_t* buf, size_t len, std::vector<uint8_t>& tmp,
                       int want_c, const float* params, int views,
                       int* full_h, int* full_w,
                       int* bx, int* by, int* bw, int* bh) {
  mis_codecs::JpegDecoder& dec = jpeg_decoder();
  int rc = dec.parse(buf, len);
  if (rc != 0) return rc;
  const int h = dec.height(), w = dec.width();
  if (h <= 0 || w <= 0) return -6;
  float ylo = (float)h, yhi = 0.f, xlo = (float)w, xhi = 0.f;
  for (int v = 0; v < views; ++v) {
    float y0, x0, ch, cw;
    clamp_window(params + v * 5, h, w, &y0, &x0, &ch, &cw);
    ylo = std::min(ylo, y0);
    yhi = std::max(yhi, y0 + ch);
    xlo = std::min(xlo, x0);
    xhi = std::max(xhi, x0 + cw);
  }
  int y_lo = std::max(0, (int)ylo - 1);
  int y_hi = std::min(h, (int)yhi + 2);
  if (y_hi <= y_lo) y_hi = y_lo + 1;
  int x_lo = std::max(0, (int)xlo - 1);
  int x_hi = std::min(w, (int)xhi + 2);
  if (x_hi <= x_lo) x_hi = x_lo + 1;
  rc = dec.decode(want_c, {y_lo, y_hi, x_lo, x_hi}, tmp);
  if (rc != 0) return rc;
  *full_h = h;
  *full_w = w;
  *bx = x_lo;
  *by = y_lo;
  *bw = x_hi - x_lo;
  *bh = y_hi - y_lo;
  return 0;
}

// decode the payload of record r into the thread-local tmp (h*w*oc samples
// of T); shared codec dispatch for both fetch paths. T=uint8_t accepts
// RAW/JPEG/PNG/JLS(precision<=8, narrowed); T=uint16_t accepts RAW (LE
// cast)/PNG16/JLS — JPEG is 8-bit-only by construction (store/writer.py).
template <typename T>
int decode_payload(const uint8_t* payload, uint64_t length, uint8_t codec,
                   std::vector<T>& tmp, int oc, int* h, int* w) {
  if constexpr (sizeof(T) == 1) {
    if (codec == kCodecJpeg) return decode_jpeg(payload, length, tmp, oc, h, w);
    if (codec == kCodecPng) return decode_png(payload, length, tmp, oc, h, w);
    if (codec == kCodecJls) {
      thread_local std::vector<uint16_t> wide;
      int prec = 0;
      int rc = decode_jls16(payload, length, wide, oc, h, w, &prec);
      if (rc != 0) return rc;
      if (prec > 8) return -8;  // >8-bit payload in a u8 store
      tmp.resize(wide.size());
      for (size_t i = 0; i < wide.size(); ++i) tmp[i] = (uint8_t)wide[i];
      return 0;
    }
    return -3;
  } else {
    if (codec == kCodecPng) return decode_png16(payload, length, tmp, oc, h, w);
    if (codec == kCodecJls) {
      int prec = 0;
      return decode_jls16(payload, length, tmp, oc, h, w, &prec);
    }
    return -3;
  }
}

// decode sample idx at native resolution into tmp; returns 0 and sets
// (h, w, ptr) or a negative error code. RAW points into the mmap (zero
// copy — payloads are 64-byte aligned, so the uint16 cast is safe);
// compressed codecs decode into the thread-local tmp.
template <typename T>
int decode_native(const Store* s, int64_t idx, std::vector<T>& tmp,
                  int oc, int* h, int* w, const T** ptr, int32_t* label) {
  if (idx < 0 || (uint64_t)idx >= s->header.num_samples) return -2;
  const Record& r = s->records[idx];
  if (r.offset > s->size || r.length > s->size - r.offset) return -4;
  const uint8_t* payload = s->base + r.offset;
  *label = r.label;
  if (r.codec == kCodecRaw) {
    if (r.height == 0 || r.width == 0 || r.channels == 0) return -5;
    if (r.length < (uint64_t)r.height * r.width * r.channels * sizeof(T)) return -5;
    if (r.channels != oc) return -3;
    *h = r.height;
    *w = r.width;
    *ptr = reinterpret_cast<const T*>(payload);
    return 0;
  }
  int rc = decode_payload(payload, r.length, r.codec, tmp, oc, h, w);
  if (rc != 0) return rc;
  if (*h <= 0 || *w <= 0) return -6;
  *ptr = tmp.data();
  return 0;
}

template <typename T>
int decode_one(const Store* s, int64_t idx, T* out, int oh, int ow, int oc,
               int32_t* label) {
  if (idx < 0 || (uint64_t)idx >= s->header.num_samples) return -2;
  const Record& r = s->records[idx];
  // never trust on-disk offsets: a truncated/corrupted store must fail with
  // an error code, not an out-of-bounds read
  if (r.offset > s->size || r.length > s->size - r.offset) return -4;
  if (r.codec == kCodecRaw) {
    if (r.height == 0 || r.width == 0 || r.channels == 0) return -5;
    if (r.length < (uint64_t)r.height * r.width * r.channels * sizeof(T)) return -5;
  }
  const uint8_t* payload = s->base + r.offset;
  *label = r.label;
  if (r.codec == kCodecRaw) {
    if (r.channels != oc) return -3;
    place(reinterpret_cast<const T*>(payload), r.height, r.width, out, oh, ow, oc);
    return 0;
  }
  thread_local std::vector<T> tmp;
  int h = 0, w = 0;
  int rc = decode_payload(payload, r.length, r.codec, tmp, oc, &h, &w);
  if (rc != 0) return rc;
  if (h <= 0 || w <= 0) return -6;
  place(tmp.data(), h, w, out, oh, ow, oc);
  return 0;
}

}  // namespace

extern "C" {

void* mis_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Store* s = new Store();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->size = st.st_size;
  if ((size_t)st.st_size < kHeaderSize) {
    munmap(base, st.st_size);
    close(fd);
    delete s;
    return nullptr;
  }
  memcpy(&s->header, s->base, sizeof(Header));
  // overflow-safe: num_samples must fit the table region
  uint64_t max_records = ((uint64_t)st.st_size - kHeaderSize) / kRecordSize;
  if (memcmp(s->header.magic, "MISTORE1", 8) != 0 || s->header.num_samples > max_records ||
      (s->header.flags & ~kFlagU16) != 0) {
    munmap(base, st.st_size);
    close(fd);
    delete s;
    return nullptr;
  }
  s->records = reinterpret_cast<const Record*>(s->base + kHeaderSize);
  return s;
}

void mis_close(void* store) {
  Store* s = static_cast<Store*>(store);
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->base), s->size);
  close(s->fd);
  delete s;
}

int64_t mis_num_samples(void* store) {
  return static_cast<Store*>(store)->header.num_samples;
}

void mis_shape(void* store, int* h, int* w, int* c) {
  Store* s = static_cast<Store*>(store);
  *h = s->header.height;
  *w = s->header.width;
  *c = s->header.channels;
}

}  // extern "C"

namespace {

// true iff the store's sample dtype matches T — calling the u8 entry point
// on a u16 store (or vice versa) must fail loudly, not reinterpret bytes
template <typename T>
bool dtype_matches(const Store* s) {
  return ((s->header.flags & kFlagU16) != 0) == (sizeof(T) == 2);
}

template <typename T>
int mis_fetch_impl(void* store, const int64_t* indices, int n, T* out,
                   int oh, int ow, int oc, int32_t* labels, int num_threads) {
  Store* s = static_cast<Store*>(store);
  if (!dtype_matches<T>(s)) return -10;
  const size_t stride = size_t(oh) * ow * oc;

  // hint the kernel about the pages this batch touches (indices validated
  // here too — decode_one re-checks, but this loop must not read OOB either)
  for (int i = 0; i < n; ++i) {
    if (indices[i] < 0 || (uint64_t)indices[i] >= s->header.num_samples) continue;
    const Record& r = s->records[indices[i]];
    if (r.offset > s->size || r.length > s->size - r.offset) continue;
    uintptr_t a = reinterpret_cast<uintptr_t>(s->base + r.offset) & ~uintptr_t(4095);
    size_t len = (r.length + 4096 + 4095) & ~size_t(4095);
    madvise(reinterpret_cast<void*>(a), len, MADV_WILLNEED);
  }

  std::atomic<int> next{0};
  std::atomic<int> err{0};
  auto work = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = decode_one(s, indices[i], out + stride * i, oh, ow, oc, labels + i);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  if (num_threads <= 1) {
    work();
  } else {
    // persistent pool: caller + (num_threads-1) workers share the claim queue
    s->pool.run(work, num_threads - 1);
  }
  return err.load();
}

template <typename T>
int mis_fetch_views_impl(void* store, const int64_t* indices, int n,
                         const float* params, int views, T* out,
                         int vh, int vw, int oc, int32_t* labels, int num_threads) {
  Store* s = static_cast<Store*>(store);
  if (!dtype_matches<T>(s)) return -10;
  if (n <= 0 || views <= 0 || vh <= 0 || vw <= 0 || oc <= 0) return -7;
  const size_t vstride = size_t(vh) * vw * oc;

  for (int i = 0; i < n; ++i) {
    if (indices[i] < 0 || (uint64_t)indices[i] >= s->header.num_samples) continue;
    const Record& r = s->records[indices[i]];
    if (r.offset > s->size || r.length > s->size - r.offset) continue;
    uintptr_t a = reinterpret_cast<uintptr_t>(s->base + r.offset) & ~uintptr_t(4095);
    size_t len = (r.length + 4096 + 4095) & ~size_t(4095);
    madvise(reinterpret_cast<void*>(a), len, MADV_WILLNEED);
  }

  std::atomic<int> next{0};
  std::atomic<int> err{0};
  auto work = [&]() {
    thread_local std::vector<T> tmp;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      // full image dims for window clamping; (ox, oy, sh, sw) describe the
      // decoded region (whole image except for the windowed-JPEG path)
      int h = 0, w = 0, ox = 0, oy = 0, sh = 0, sw = 0;
      const T* src = nullptr;
      int rc;
      const int64_t idx = indices[i];
      const Record* rec =
          (idx >= 0 && (uint64_t)idx < s->header.num_samples) ? &s->records[idx] : nullptr;
      bool region_decoded = false;
      if constexpr (sizeof(T) == 1) {
        if (rec && rec->codec == kCodecJpeg &&
            rec->offset <= s->size && rec->length <= s->size - rec->offset) {
          // JPEG: decode only the windows' union bounding box (see
          // decode_jpeg_region) — RRC windows rarely need the whole image
          labels[i] = rec->label;
          rc = decode_jpeg_region(s->base + rec->offset, rec->length, tmp, oc,
                                  params + size_t(i) * views * 5, views,
                                  &h, &w, &ox, &oy, &sw, &sh);
          src = tmp.data();
          region_decoded = true;
        }
      }
      if (rec && rec->codec == kCodecJls && !region_decoded &&
          rec->offset <= s->size && rec->length <= s->size - rec->offset) {
        // JPEG-LS: stop entropy-decoding below the windows' union last row
        // (decode_jls16_rows) — rows only; T.87 columns are not skippable
        labels[i] = rec->label;
        int dec_rows = 0, prec = 0;
        if constexpr (sizeof(T) == 1) {
          thread_local std::vector<uint16_t> wide;
          rc = decode_jls16_rows(s->base + rec->offset, rec->length, wide, oc,
                                 params + size_t(i) * views * 5, views,
                                 &h, &w, &dec_rows, &prec);
          if (rc == 0 && prec > 8) rc = -8;  // >8-bit payload in a u8 store
          if (rc == 0) {
            tmp.resize(wide.size());
            for (size_t j = 0; j < wide.size(); ++j) tmp[j] = (T)wide[j];
            src = tmp.data();
          }
        } else {
          rc = decode_jls16_rows(s->base + rec->offset, rec->length, tmp, oc,
                                 params + size_t(i) * views * 5, views,
                                 &h, &w, &dec_rows, &prec);
          src = tmp.data();
        }
        ox = 0; oy = 0; sw = w; sh = dec_rows;
        region_decoded = true;
      }
      if (!region_decoded) {
        rc = decode_native(s, idx, tmp, oc, &h, &w, &src, labels + i);
        sh = h;
        sw = w;
      }
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
        continue;
      }
      for (int v = 0; v < views; ++v) {
        const float* p = params + (size_t(i) * views + v) * 5;
        float y0, x0, ch, cw;
        clamp_window(p, h, w, &y0, &x0, &ch, &cw);
        // taps in image coordinates; the region includes a 1-px margin
        // around every tap the bilinear filter can touch
        crop_resize_bilinear(src, h, w, oy, ox, sh, sw, oc, y0, x0, ch, cw,
                             p[4] != 0.f,
                             out + (size_t(i) * views + v) * vstride, vh, vw);
      }
    }
  };
  if (num_threads <= 1) {
    work();
  } else {
    s->pool.run(work, num_threads - 1);
  }
  return err.load();
}

}  // namespace

extern "C" {

// Decode n samples (by index) into out (n * oh * ow * oc samples) and labels.
// Returns 0 on success, or the first nonzero per-sample error code.
int mis_fetch(void* store, const int64_t* indices, int n, uint8_t* out,
              int oh, int ow, int oc, int32_t* labels, int num_threads) {
  return mis_fetch_impl(store, indices, n, out, oh, ow, oc, labels, num_threads);
}

// uint16 stores (header kFlagU16): same contract, uint16 output buffer.
int mis_fetch_u16(void* store, const int64_t* indices, int n, uint16_t* out,
                  int oh, int ow, int oc, int32_t* labels, int num_threads) {
  return mis_fetch_impl(store, indices, n, out, oh, ow, oc, labels, num_threads);
}

// sample dtype discriminator: 0 = uint8, 1 = uint16
int mis_sample_u16(void* store) {
  return (static_cast<Store*>(store)->header.flags & kFlagU16) ? 1 : 0;
}

// Host-side RandomResizedCrop fast path: decode each sample once at native
// resolution, then emit `views` bilinear crop-resized views per sample.
//
// Rationale (BASELINE.md "store mode"): shipping V pre-cropped views of
// vh*vw*oc bytes instead of one full oh*ow*oc image cuts H2D bytes ~2x for
// the canonical 256^2 store -> 2x112^2 SSL views — the win that matters on
// narrow host<->device links where the DMA, not decode, is the bottleneck.
// The crop geometry matches the device resampler (ops/augment.py) so the
// two paths are interchangeable (parity-tested in tests/test_precrop.py);
// the elementwise augmentation tail (solarize/windowing/normalize) still
// runs on device.
//
// params: n * views * 5 floats per view, laid out [sample][view][5] =
//   (y0, x0, crop_h, crop_w, flip). out: (n * views, vh, vw, oc) uint8 with
//   view v of sample i at index i*views + v — SAMPLE-major. This layout is
//   load-bearing for SPMD: the global batch is assembled by concatenating
//   per-host shards along axis 0 (parallel/mesh.py::shard_batch), and a
//   batch-sharded (B*V, ...) array reshapes to (B, V, ...) with each
//   device slicing its own rows — view-major would interleave hosts'
//   pairs wrongly and force cross-device resharding on the view split.
// Returns 0 or the first nonzero per-sample error code.
int mis_fetch_views(void* store, const int64_t* indices, int n,
                    const float* params, int views, uint8_t* out,
                    int vh, int vw, int oc, int32_t* labels, int num_threads) {
  return mis_fetch_views_impl(store, indices, n, params, views, out,
                              vh, vw, oc, labels, num_threads);
}

// uint16 stores: same contract, uint16 view buffer. JLS payloads take the
// row-limited crop-at-decode path (decode_jls16_rows — the u16 analogue of
// the windowed-JPEG fast path; rows only, T.87 columns are not skippable);
// RAW/PNG16 decode whole frames.
int mis_fetch_views_u16(void* store, const int64_t* indices, int n,
                        const float* params, int views, uint16_t* out,
                        int vh, int vw, int oc, int32_t* labels, int num_threads) {
  return mis_fetch_views_impl(store, indices, n, params, views, out,
                              vh, vw, oc, labels, num_threads);
}

}  // extern "C"
