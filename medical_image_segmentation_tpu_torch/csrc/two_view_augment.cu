// Fused two-view SSL augmentation for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// medical_image_segmentation_tpu/ops/pallas_augment.py::pallas_two_view_augment
// (body _augment_kernel, helper _interp_rows). Per sample and for both views:
// bilinear RandomResizedCrop (half-pixel centres, source coordinate clamped to
// [0, in-1], horizontal flip folded in by mirroring the output column), then
// the BT.601 grayscale mix (C=3), the CT window
// clip((x-(L-W/2))*vmax/W, 0, vmax), solarize x >= thr -> vmax-x, and the
// per-channel (x-mean)/std, all in f32, rounded once to the output type.
//
// What bounds it: bytes, not FLOPs. At the main-path shape (256^2 uint8,
// C=1 -> two 112^2 bf16 views) a sample reads 65,536 B and writes
// 2 * 112^2 * 2 = 50,176 B (~115 KB; ~118 MB per call at B=1024) for a few
// dozen FLOPs per output pixel: far under the H100's ~295 FLOP/byte balance
// point, so the kernel can only be as fast as device memory.
//
// Design. The Pallas kernel builds dense (oh,H) and (ow,W) weight matrices
// and multiplies them on the MXU, a TPU device for gathers. Here each output
// pixel is one thread that gathers its 2x2 taps directly. A block covers 256
// output pixels of one sample and emits both views, so each source tile is
// read from device memory once and served to the second view from L1/L2.
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn), rows
// first, so nvcc contracts nothing into an FMA and the result equals the
// plain PyTorch version (ops/fused_augment.py::two_view_augment_reference)
// to the bit. This first version is simple: per-thread 1-2 byte loads and
// 2 byte stores. Shared-memory staging of the source rows and 16-byte vector
// stores are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (done at first use by ops/_kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kParamsPerView = 11;  // [y0, x0, ch, cw, flip, sol, thr, gray, win, level, width]
constexpr int kNParams = 24;        // per-sample row of the (B, 24) f32 block
constexpr int kThreads = 256;

struct Norm {
  float mean[3];
  float std[3];
};

struct Tap {
  int lo, hi;        // source taps; hi is clamped to in-1, where its weight is exactly 0
  float w_lo, w_hi;  // 1 - fr, fr
};

__device__ __forceinline__ Tap make_tap(float start, float size, int in_dim, int out_dim, int i,
                                        bool mirror) {
  const float scale = __fdiv_rn(size, (float)out_dim);
  float pos = (float)i + 0.5f;
  if (mirror) pos = (float)out_dim - pos;
  float src = __fsub_rn(__fadd_rn(start, __fmul_rn(pos, scale)), 0.5f);
  src = fminf(fmaxf(src, 0.0f), (float)(in_dim - 1));
  const float lo = floorf(src);
  const float fr = __fsub_rn(src, lo);
  Tap t;
  t.lo = (int)lo;
  t.hi = min(t.lo + 1, in_dim - 1);
  t.w_lo = __fsub_rn(1.0f, fr);
  t.w_hi = fr;
  return t;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One thread per output pixel of one sample (blockIdx.y), both views.
// img: (B, H, W, C) NHWC; out1/out2: (B, OH, OW, C) NHWC.
template <typename TIn, typename TOut, int C>
__global__ void __launch_bounds__(kThreads)
two_view_augment_kernel(const TIn* __restrict__ img, const float* __restrict__ params,
                        TOut* __restrict__ out1, TOut* __restrict__ out2, int H, int W, int OH,
                        int OW, float vmax, Norm norm) {
  const int b = blockIdx.y;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= OH * OW) return;
  const int oy = pix / OW;
  const int ox = pix - oy * OW;
  const TIn* src = img + (size_t)b * H * W * C;
  const float* pb = params + (size_t)b * kNParams;

#pragma unroll
  for (int view = 0; view < 2; ++view) {
    const float* p = pb + view * kParamsPerView;
    const Tap ty = make_tap(p[0], p[2], H, OH, oy, false);
    const Tap tx = make_tap(p[1], p[3], W, OW, ox, p[4] > 0.5f);
    const float sol = p[5], thr = p[6], gray = p[7], win = p[8], level = p[9], width = p[10];

    const size_t r_lo = (size_t)ty.lo * W, r_hi = (size_t)ty.hi * W;
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float a = (float)src[(r_lo + tx.lo) * C + c];
      const float bq = (float)src[(r_hi + tx.lo) * C + c];
      const float cq = (float)src[(r_lo + tx.hi) * C + c];
      const float d = (float)src[(r_hi + tx.hi) * C + c];
      // rows first, then columns — the order of two_view_augment_reference
      const float col_lo = __fadd_rn(__fmul_rn(ty.w_lo, a), __fmul_rn(ty.w_hi, bq));
      const float col_hi = __fadd_rn(__fmul_rn(ty.w_lo, cq), __fmul_rn(ty.w_hi, d));
      v[c] = __fadd_rn(__fmul_rn(tx.w_lo, col_lo), __fmul_rn(tx.w_hi, col_hi));
    }
    if constexpr (C == 3) {
      if (gray > 0.5f) {
        const float luma = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, v[0]), __fmul_rn(0.587f, v[1])),
                                     __fmul_rn(0.114f, v[2]));
        v[0] = v[1] = v[2] = luma;
      }
    }
    const float wlo = __fsub_rn(level, __fmul_rn(width, 0.5f));
    const float wscale = __fdiv_rn(vmax, width);
    TOut* out = (view == 0 ? out1 : out2) + ((size_t)b * OH * OW + pix) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float x = v[c];
      if (win > 0.5f) x = fminf(fmaxf(__fmul_rn(__fsub_rn(x, wlo), wscale), 0.0f), vmax);
      if (sol > 0.5f && x >= thr) x = __fsub_rn(vmax, x);
      store(out + c, __fdiv_rn(__fsub_rn(x, norm.mean[c]), norm.std[c]));
    }
  }
}

template <typename TIn, typename TOut>
void launch(int C, dim3 grid, cudaStream_t stream, const void* img, const float* params,
            void* out1, void* out2, int H, int W, int OH, int OW, float vmax, Norm norm) {
  const TIn* in = static_cast<const TIn*>(img);
  TOut* o1 = static_cast<TOut*>(out1);
  TOut* o2 = static_cast<TOut*>(out2);
  if (C == 1) {
    two_view_augment_kernel<TIn, TOut, 1>
        <<<grid, kThreads, 0, stream>>>(in, params, o1, o2, H, W, OH, OW, vmax, norm);
  } else {
    two_view_augment_kernel<TIn, TOut, 3>
        <<<grid, kThreads, 0, stream>>>(in, params, o1, o2, H, W, OH, OW, vmax, norm);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates the outputs and checks shapes, types and contiguity.
// in_u16: 0 = uint8 input, 1 = uint16; out_bf16: 0 = float32 output, 1 = bfloat16.
extern "C" int mis_two_view_augment(const void* img, const float* params, void* out1, void* out2,
                                    int B, int H, int W, int C, int OH, int OW, int in_u16,
                                    int out_bf16, float vmax, float m0, float m1, float m2,
                                    float s0, float s1, float s2, void* stream) {
  if ((C != 1 && C != 3) || B < 1 || B > 65535 || OH < 1 || OW < 1 || H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Norm norm = {{m0, m1, m2}, {s0, s1, s2}};
  const dim3 grid((OH * OW + kThreads - 1) / kThreads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_u16) {
    if (out_bf16) {
      launch<uint16_t, __nv_bfloat16>(C, grid, st, img, params, out1, out2, H, W, OH, OW, vmax, norm);
    } else {
      launch<uint16_t, float>(C, grid, st, img, params, out1, out2, H, W, OH, OW, vmax, norm);
    }
  } else {
    if (out_bf16) {
      launch<uint8_t, __nv_bfloat16>(C, grid, st, img, params, out1, out2, H, W, OH, OW, vmax, norm);
    } else {
      launch<uint8_t, float>(C, grid, st, img, params, out1, out2, H, W, OH, OW, vmax, norm);
    }
  }
  return (int)cudaGetLastError();
}
