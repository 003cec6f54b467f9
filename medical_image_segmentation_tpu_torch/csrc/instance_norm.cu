// InstanceNorm + LeakyReLU for Hopper (sm_90a), plain C interface: nnU-Net's
// norm (models/plain_unet3d.py::InstanceNorm3D), forward and backward.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA. It
// replaces the port's own eager chain for a group a channel: a float32 copy
// of the bf16 activation, var_mean, the scale and shift built with
// repeat_interleave, x * scale + shift in float32, a rounding, LeakyReLU as
// one more pass, and autograd's float32 backward of each (~15 launches a
// norm forward, ~20 backward, float32 copies saved for the backward).
//
// The input is the (B, N, C) channels-last view of a (B, C, D, H, W)
// channels_last_3d activation (N = D*H*W voxels a sample), in bfloat16 or
// float32. For each (sample, channel), over the sample's N voxels:
// 1. statistics: float32 mean and invstd = 1/sqrt(var + eps), var biased.
//    Each thread sums its values shifted by the first it reads (an exact
//    difference of two bf16 values); the threads' and the slabs' (count,
//    mean less the instance's first voxel, sum of squared deviations) are
//    merged by Chan et al.'s formula in a fixed order, with no atomics, so
//    a mean far above the spread costs no precision and two calls give the
//    same bits;
// 2. normalize: y = LeakyReLU((x - mean) * invstd * w + b) in float32,
//    rounded once to the activation's type, channels-last;
// 3. backward reduce: x^ and the activation's slope recomputed from the
//    saved x and the (B, C) mean and invstd; g = dy * slope; sum g and
//    sum g*x^ for each (sample, channel); their sums over samples are the
//    bias's and the weight's gradients;
// 4. backward elementwise: dx = (w*invstd) * ((g - sum g/n) - x^ * (sum g*x^/n)).
// Each product and sum of 2 and 4 is rounded on its own (__fmul_rn,
// __fadd_rn, ...) in the plain version's order (ops/instance_norm.py), so
// given the same statistics and sums the outputs equal the plain version's.
//
// What bounds it: bytes. Let a be one bf16 read or write of every value a
// step normalizes (nnunet3d_liver.train: 714,424,320 values, a = 1.429 GB).
// The forward reads x twice (statistics, normalize) and writes y: 3a. The
// backward reads x and dy twice and writes dx: 5a. 8a = 11.4 GB a step,
// 3.4 ms at 3.35 TB/s. Three quarters of it is at the four 128^3 x 32 norms,
// where a sample is 134 MB (more than the 50 MB L2) and a row 64 bytes.
//
// The design, chosen by the instance's size (by ops/instance_norm.py, which
// calls the one-kernel entry points up to FUSED_VOXELS = 1024 voxels):
// - above it (the 128^3 ... 16^3 stages): two passes a direction, as
//   csrc/global_batchnorm.cu. Threads across C, 16 bytes a load (one value
//   where C does not allow it), the rest of a block's 256 threads across
//   rows, so a warp reads whole rows or 512 contiguous bytes of one; each
//   thread keeps kUnroll rows' loads in flight. A fixed set of row slabs of
//   each sample (from B, N, C and the SM count alone; one wave of the card)
//   writes its partial row; a small kernel merges the slabs in a fixed
//   order; the elementwise pass strides over rows with one wave of blocks.
//   Launches: 3 a forward (moments_partial, merge_moments, normalize_rows),
//   3 a backward (grad_partial, merge_grads, dx_rows).
// - at or below it (the 8^3 and 4^3 stages, bound by launch latency): one
//   kernel a direction. A block owns a tile of kFusedTx vectors of columns
//   (of one sample forward, of every sample backward, so that it also owns
//   the weight's and bias's gradients), reduces over all the rows, then
//   reads them again, from L2, for the elementwise part. Launches: 1 a
//   forward (fused_forward), 1 a backward (fused_backward).
// nnunet3d_liver.train's 22 norms a step: 16 of two passes and 6 fused,
// 54 launches forward and 54 backward.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (done at first use by ops/_kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // threads a block of the row passes
constexpr int kBlocksPerSM = 3;      // resident an SM: <= 85 registers a thread, one wave exactly
constexpr int kUnroll = 4;           // rows whose loads a thread has in flight (half as many
                                     // where it reads x and dy: the same bytes)
constexpr int kMaxTx = 64;           // vectors across a row a block of the two-pass kernels
constexpr int kSumCols = 32;         // channels a block of the merge kernels handles
constexpr int kSumRows = 32;         // and the strided subsets of slabs it splits them over
constexpr int kFusedTx = 4;          // vectors across a row a block of the one-kernel path

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// VEC consecutive values of one row: one 16-byte access, or one value.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  Pack<T, VEC> r;
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    *reinterpret_cast<uint4*>(&r) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = p[i];
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& r) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = r.v[i];
  }
}

// x^ = (x - mean) * invstd, z = x^ * w + b and the activation, as the plain
// version rounds them
__device__ __forceinline__ float xhat(float x, float mean, float invstd) {
  return __fmul_rn(__fsub_rn(x, mean), invstd);
}
__device__ __forceinline__ float affine(float h, float w, float b) { return __fadd_rn(__fmul_rn(h, w), b); }
__device__ __forceinline__ float leaky(float z, float slope) { return z > 0.0f ? z : __fmul_rn(z, slope); }
// the gradient through the activation: dy where z > 0, else dy * slope
__device__ __forceinline__ float through(float z, float d, float slope) { return z > 0.0f ? d : __fmul_rn(d, slope); }

// Chan et al.'s merge of a part (nb, mb, qb) into (n, m, q): counts, means
// and sums of squared deviations from the mean
__device__ __forceinline__ void chan(float& n, float& m, float& q, float nb, float mb, float qb) {
  if (nb == 0.0f) return;
  if (n == 0.0f) {
    n = nb;
    m = mb;
    q = qb;
    return;
  }
  const float t = n + nb, d = mb - m, f = nb * __frcp_rn(t);
  m = fmaf(d, f, m);
  q = q + qb + d * d * n * f;
  n = t;
}

__device__ __forceinline__ float invstd_of(float q, float n, float eps) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(q, n), eps)));
}

// rows r0, r0 + step, ... below r1
__device__ __forceinline__ float rows_of(long long r0, long long r1, long long step) {
  return r0 < r1 ? (float)((r1 - r0 + step - 1) / step) : 0.0f;
}

// One thread's rows r0, r0 + step, ... below r1 of the column vector at xc:
// each value's mean m, less the instance's pivot p (its first voxel), and
// sum of squared deviations q, from sums shifted by the first value the
// thread reads. The means are merged in the pivot's frame, so their
// roundings are of the spread's size and not of the mean's.
template <typename T, int VEC>
__device__ __forceinline__ void thread_moments(const T* xc, long long r0, long long r1, long long step, int C,
                                               const float (&p)[VEC], float (&m)[VEC], float (&q)[VEC]) {
  float k[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) k[i] = s1[i] = s2[i] = m[i] = q[i] = 0.0f;
  if (r0 >= r1) return;
  {
    const Pack<T, VEC> first = load<T, VEC>(xc + r0 * C);
#pragma unroll
    for (int i = 0; i < VEC; ++i) k[i] = to_float(first.v[i]);
  }
  auto add = [&](const Pack<T, VEC>& v) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = to_float(v.v[i]) - k[i];
      s1[i] += d;
      s2[i] = fmaf(d, d, s2[i]);
    }
  };
  long long r = r0;
  for (; r + (kUnroll - 1) * step < r1; r += kUnroll * step) {
    Pack<T, VEC> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load<T, VEC>(xc + (r + u * step) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add(v[u]);
  }
  for (; r < r1; r += step) add(load<T, VEC>(xc + r * C));
  const float n = rows_of(r0, r1, step);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float dm = s1[i] / n;
    m[i] = (k[i] - p[i]) + dm;
    q[i] = fmaxf(s2[i] - s1[i] * dm, 0.0f);
  }
}

// The instance's pivot for a column vector: its first voxel.
template <typename T, int VEC>
__device__ __forceinline__ void pivot(const T* xc, float (&p)[VEC]) {
  const Pack<T, VEC> v = load<T, VEC>(xc);
#pragma unroll
  for (int i = 0; i < VEC; ++i) p[i] = to_float(v.v[i]);
}

// One thread's rows of the backward: sum g and sum g*x^ of each value.
template <typename T, int VEC>
__device__ __forceinline__ void thread_grads(const T* xc, const T* dc, long long r0, long long r1, long long step,
                                             int C, const float (&m)[VEC], const float (&s)[VEC],
                                             const float (&w)[VEC], const float (&b)[VEC], float slope,
                                             float (&a)[VEC], float (&g2)[VEC]) {
  auto add = [&](const Pack<T, VEC>& px, const Pack<T, VEC>& pd) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float h = xhat(to_float(px.v[i]), m[i], s[i]);
      const float g = through(affine(h, w[i], b[i]), to_float(pd.v[i]), slope);
      a[i] += g;
      g2[i] = fmaf(g, h, g2[i]);
    }
  };
  constexpr int U = kUnroll / 2;
  long long r = r0;
  for (; r + (U - 1) * step < r1; r += U * step) {
    Pack<T, VEC> px[U], pd[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      px[u] = load<T, VEC>(xc + (r + u * step) * C);
      pd[u] = load<T, VEC>(dc + (r + u * step) * C);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) add(px[u], pd[u]);
  }
  for (; r < r1; r += step) add(load<T, VEC>(xc + r * C), load<T, VEC>(dc + r * C));
}

// The block's threads' (n, m, q) merged over threadIdx.y in a fixed order:
// column j < W = blockDim.x * VEC of the block's tile into res_m[j],
// res_q[j]. red holds 2 * blockDim.y * W floats, cnt blockDim.y.
template <int VEC>
__device__ __forceinline__ void block_moments(float* red, float* cnt, float n, const float (&m)[VEC],
                                              const float (&q)[VEC], float* res_m, float* res_q) {
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, TY = blockDim.y;
  const int W = TX * VEC;
  float* row = red + ty * 2 * W;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    row[tx * VEC + i] = m[i];
    row[W + tx * VEC + i] = q[i];
  }
  if (tx == 0) cnt[ty] = n;
  __syncthreads();
  for (int j = ty * TX + tx; j < W; j += TX * TY) {
    float an = 0.0f, am = 0.0f, aq = 0.0f;
    for (int k = 0; k < TY; ++k) chan(an, am, aq, cnt[k], red[k * 2 * W + j], red[k * 2 * W + W + j]);
    res_m[j] = am;
    res_q[j] = aq;
  }
  __syncthreads();
}

// The block's threads' two sums a and b added over threadIdx.y in a fixed
// order into res_a[j], res_b[j] for j < W.
template <int VEC>
__device__ __forceinline__ void block_sums(float* red, const float (&a)[VEC], const float (&b)[VEC], float* res_a,
                                           float* res_b) {
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, TY = blockDim.y;
  const int W = TX * VEC;
  float* row = red + ty * 2 * W;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    row[tx * VEC + i] = a[i];
    row[W + tx * VEC + i] = b[i];
  }
  __syncthreads();
  for (int j = ty * TX + tx; j < 2 * W; j += TX * TY) {
    float acc = 0.0f;
    for (int k = 0; k < TY; ++k) acc += red[k * 2 * W + j];
    (j < W ? res_a[j] : res_b[j - W]) = acc;
  }
  __syncthreads();
}

// First pass of the statistics: block (x, y, b) covers a tile of columns
// and row slab y of sample b; it writes row (b, y) of the (B, slabs, 2C)
// partials, [means less the pivots | sums of squared deviations].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    moments_partial(const T* __restrict__ x, long long N, int C, long long slab_rows, int slabs,
                    float* __restrict__ partial) {
  __shared__ float red[2 * kThreads * 8];
  __shared__ float cnt[kThreads];
  __shared__ float res[2 * kMaxTx * 8];
  const int TX = blockDim.x, TY = blockDim.y, W = TX * VEC, b = blockIdx.z;
  const int col = blockIdx.x * TX + threadIdx.x;  // in vectors
  const long long r0 = blockIdx.y * slab_rows + threadIdx.y;
  const long long r1 = min(N, (blockIdx.y + 1) * slab_rows);
  float m[VEC], q[VEC];
  if (col < C / VEC) {
    const T* xc = x + (long long)b * N * C + col * VEC;
    float p[VEC];
    pivot<T, VEC>(xc, p);
    thread_moments<T, VEC>(xc, r0, r1, TY, C, p, m, q);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) m[i] = q[i] = 0.0f;
  }
  block_moments<VEC>(red, cnt, rows_of(r0, r1, TY), m, q, res, res + W);
  float* out = partial + ((long long)b * slabs + blockIdx.y) * 2 * C;
  for (int j = threadIdx.y * TX + threadIdx.x; j < W; j += TX * TY) {
    const int c = blockIdx.x * W + j;
    if (c < C) {
      out[c] = res[j];
      out[C + c] = res[W + j];
    }
  }
}

// Second pass: block (x, b) merges each of its channels' slabs of sample b
// in a fixed order into the channel's mean and invstd.
template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumRows)
    merge_moments(const T* __restrict__ x, const float* __restrict__ partial, long long N, int C,
                  long long slab_rows, int slabs, float eps, float* __restrict__ mean, float* __restrict__ invstd) {
  __shared__ float rn[kSumRows][kSumCols + 1], rm[kSumRows][kSumCols + 1], rq[kSumRows][kSumCols + 1];
  constexpr int U = 4;  // slabs whose loads a thread has in flight
  const int tx = threadIdx.x, y = threadIdx.y, b = blockIdx.y;
  const int c = blockIdx.x * kSumCols + tx;
  float n = 0.0f, m = 0.0f, q = 0.0f;
  if (c < C) {
    const float* base = partial + (long long)b * slabs * 2 * C;
    for (int s0 = y; s0 < slabs; s0 += U * kSumRows) {
      float pn[U], pm[U], pq[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = s0 + u * kSumRows;
        pn[u] = pm[u] = pq[u] = 0.0f;
        if (s < slabs) {
          const long long lo = s * slab_rows, hi = min(N, lo + slab_rows);
          pn[u] = (float)(hi - lo);
          pm[u] = base[(long long)s * 2 * C + c];
          pq[u] = base[(long long)s * 2 * C + C + c];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) chan(n, m, q, pn[u], pm[u], pq[u]);
    }
  }
  rn[y][tx] = n;
  rm[y][tx] = m;
  rq[y][tx] = q;
  __syncthreads();
  if (y == 0 && c < C) {
    float an = 0.0f, am = 0.0f, aq = 0.0f;
    for (int k = 0; k < kSumRows; ++k) chan(an, am, aq, rn[k][tx], rm[k][tx], rq[k][tx]);
    mean[b * C + c] = __fadd_rn(to_float(x[(long long)b * N * C + c]), am);
    invstd[b * C + c] = invstd_of(aq, (float)N, eps);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_channels(const float* mean, const float* invstd, const float* weight,
                                              const float* bias, int b, int C, int col, float (&m)[VEC],
                                              float (&s)[VEC], float (&w)[VEC], float (&bb)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = col * VEC + i;
    m[i] = mean[b * C + c];
    s[i] = invstd[b * C + c];
    w[i] = weight[c];
    bb[i] = bias[c];
  }
}

// y over rows r0, r0 + step, ... < r1 of one column vector
template <typename T, int VEC>
__device__ __forceinline__ void normalize_span(const T* xc, T* yc, long long r0, long long r1, long long step, int C,
                                               const float (&m)[VEC], const float (&s)[VEC], const float (&w)[VEC],
                                               const float (&bb)[VEC], float slope) {
  auto one = [&](const Pack<T, VEC>& px, long long r) {
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out.v[i] = from_float<T>(leaky(affine(xhat(to_float(px.v[i]), m[i], s[i]), w[i], bb[i]), slope));
    }
    store<T, VEC>(yc + r * C, out);
  };
  long long r = r0;
  for (; r + (kUnroll - 1) * step < r1; r += kUnroll * step) {
    Pack<T, VEC> px[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) px[u] = load<T, VEC>(xc + (r + u * step) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) one(px[u], r + u * step);
  }
  for (; r < r1; r += step) one(load<T, VEC>(xc + r * C), r);
}

// dx over rows r0, r0 + step, ... < r1 of one column vector, from the
// sample's a = sum g / n and gg = sum g*x^ / n
template <typename T, int VEC>
__device__ __forceinline__ void dx_span(const T* xc, const T* dc, T* oc, long long r0, long long r1, long long step,
                                        int C, const float (&m)[VEC], const float (&s)[VEC], const float (&w)[VEC],
                                        const float (&bb)[VEC], const float (&a)[VEC], const float (&gg)[VEC],
                                        float slope) {
  auto one = [&](const Pack<T, VEC>& px, const Pack<T, VEC>& pd, long long r) {
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float h = xhat(to_float(px.v[i]), m[i], s[i]);
      const float g = through(affine(h, w[i], bb[i]), to_float(pd.v[i]), slope);
      const float inner = __fsub_rn(__fsub_rn(g, a[i]), __fmul_rn(h, gg[i]));
      out.v[i] = from_float<T>(__fmul_rn(__fmul_rn(w[i], s[i]), inner));
    }
    store<T, VEC>(oc + r * C, out);
  };
  constexpr int U = kUnroll / 2;
  long long r = r0;
  for (; r + (U - 1) * step < r1; r += U * step) {
    Pack<T, VEC> px[U], pd[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      px[u] = load<T, VEC>(xc + (r + u * step) * C);
      pd[u] = load<T, VEC>(dc + (r + u * step) * C);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) one(px[u], pd[u], r + u * step);
  }
  for (; r < r1; r += step) one(load<T, VEC>(xc + r * C), load<T, VEC>(dc + r * C), r);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    normalize_rows(const T* __restrict__ x, const float* __restrict__ mean, const float* __restrict__ invstd,
                   const float* __restrict__ weight, const float* __restrict__ bias, T* __restrict__ y, long long N,
                   int C, float slope) {
  const int b = blockIdx.z;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C / VEC) return;
  float m[VEC], s[VEC], w[VEC], bb[VEC];
  load_channels<T, VEC>(mean, invstd, weight, bias, b, C, col, m, s, w, bb);
  const long long base = (long long)b * N * C + col * VEC;
  normalize_span<T, VEC>(x + base, y + base, (long long)blockIdx.y * blockDim.y + threadIdx.y, N,
                         (long long)gridDim.y * blockDim.y, C, m, s, w, bb, slope);
}

// First pass of the backward sums: block (x, y, b) writes row (b, y) of the
// (B, slabs, 2C) partials, [sum g | sum g*x^].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    grad_partial(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean,
                 const float* __restrict__ invstd, const float* __restrict__ weight, const float* __restrict__ bias,
                 long long N, int C, long long slab_rows, int slabs, float slope, float* __restrict__ partial) {
  __shared__ float red[2 * kThreads * 8];
  __shared__ float res[2 * kMaxTx * 8];
  const int TX = blockDim.x, TY = blockDim.y, W = TX * VEC, b = blockIdx.z;
  const int col = blockIdx.x * TX + threadIdx.x;
  float a[VEC], g2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a[i] = g2[i] = 0.0f;
  if (col < C / VEC) {
    float m[VEC], s[VEC], w[VEC], bb[VEC];
    load_channels<T, VEC>(mean, invstd, weight, bias, b, C, col, m, s, w, bb);
    const long long base = (long long)b * N * C + col * VEC;
    thread_grads<T, VEC>(x + base, dy + base, blockIdx.y * slab_rows + threadIdx.y,
                         min(N, (blockIdx.y + 1) * slab_rows), TY, C, m, s, w, bb, slope, a, g2);
  }
  block_sums<VEC>(red, a, g2, res, res + W);
  float* out = partial + ((long long)b * slabs + blockIdx.y) * 2 * C;
  for (int j = threadIdx.y * TX + threadIdx.x; j < W; j += TX * TY) {
    const int c = blockIdx.x * W + j;
    if (c < C) {
      out[c] = res[j];
      out[C + c] = res[W + j];
    }
  }
}

// Second pass: each (sample, channel)'s slabs added in a fixed order into
// sums (B, 2C); their sums over samples, in sample order, are the bias's
// and the weight's gradients.
__global__ void __launch_bounds__(kSumCols * kSumRows)
    merge_grads(const float* __restrict__ partial, int B, int C, int slabs, float* __restrict__ sums,
                float* __restrict__ grad_weight, float* __restrict__ grad_bias) {
  __shared__ float ra[kSumRows][kSumCols + 1], rg[kSumRows][kSumCols + 1];
  const int x = threadIdx.x, y = threadIdx.y;
  const int c = blockIdx.x * kSumCols + x;
  float gw = 0.0f, gb = 0.0f;
  for (int b = 0; b < B; ++b) {
    float a = 0.0f, g = 0.0f;
    if (c < C) {
#pragma unroll 4
      for (int s = y; s < slabs; s += kSumRows) {
        const float* p = partial + ((long long)b * slabs + s) * 2 * C;
        a += p[c];
        g += p[C + c];
      }
    }
    ra[y][x] = a;
    rg[y][x] = g;
    __syncthreads();
    if (y == 0 && c < C) {
      float sa = 0.0f, sg = 0.0f;
      for (int k = 0; k < kSumRows; ++k) {
        sa += ra[k][x];
        sg += rg[k][x];
      }
      sums[b * 2 * C + c] = sa;
      sums[b * 2 * C + C + c] = sg;
      gb += sa;
      gw += sg;
    }
    __syncthreads();
  }
  if (y == 0 && c < C) {
    grad_weight[c] = gw;
    grad_bias[c] = gb;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    dx_rows(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean,
            const float* __restrict__ invstd, const float* __restrict__ weight, const float* __restrict__ bias,
            const float* __restrict__ sums, T* __restrict__ dx, long long N, int C, float slope) {
  const int b = blockIdx.z;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C / VEC) return;
  const float n = (float)N;
  float m[VEC], s[VEC], w[VEC], bb[VEC], a[VEC], gg[VEC];
  load_channels<T, VEC>(mean, invstd, weight, bias, b, C, col, m, s, w, bb);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[i] = __fdiv_rn(sums[b * 2 * C + col * VEC + i], n);
    gg[i] = __fdiv_rn(sums[b * 2 * C + C + col * VEC + i], n);
  }
  const long long base = (long long)b * N * C + col * VEC;
  dx_span<T, VEC>(x + base, dy + base, dx + base, (long long)blockIdx.y * blockDim.y + threadIdx.y, N,
                  (long long)gridDim.y * blockDim.y, C, m, s, w, bb, a, gg, slope);
}

// The forward in one kernel: block (x, b) owns a tile of columns of sample
// b, takes its statistics over every row, then normalizes the rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    fused_forward(const T* __restrict__ x, const float* __restrict__ weight, const float* __restrict__ bias,
                  T* __restrict__ y, float* __restrict__ mean, float* __restrict__ invstd, long long N, int C,
                  float eps, float slope) {
  __shared__ float red[2 * kThreads * 8];
  __shared__ float cnt[kThreads];
  __shared__ float res[2 * kFusedTx * 8];
  const int TX = blockDim.x, TY = blockDim.y, W = TX * VEC, b = blockIdx.z;
  const int col = blockIdx.x * TX + threadIdx.x;
  const bool live = col < C / VEC;
  const long long base = (long long)b * N * C + col * VEC;
  float m[VEC], q[VEC], p[VEC];
  if (live) {
    pivot<T, VEC>(x + base, p);
    thread_moments<T, VEC>(x + base, threadIdx.y, N, TY, C, p, m, q);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) m[i] = q[i] = 0.0f;
  }
  block_moments<VEC>(red, cnt, rows_of(threadIdx.y, N, TY), m, q, res, res + W);
  for (int j = threadIdx.y * TX + threadIdx.x; j < W; j += TX * TY) {
    const int c = blockIdx.x * W + j;
    res[W + j] = invstd_of(res[W + j], (float)N, eps);
    if (c < C) {
      mean[b * C + c] = __fadd_rn(to_float(x[(long long)b * N * C + c]), res[j]);
      invstd[b * C + c] = res[W + j];
    }
  }
  __syncthreads();
  if (!live) return;
  float s[VEC], w[VEC], bb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    m[i] = __fadd_rn(p[i], res[threadIdx.x * VEC + i]);
    s[i] = res[W + threadIdx.x * VEC + i];
    w[i] = weight[col * VEC + i];
    bb[i] = bias[col * VEC + i];
  }
  normalize_span<T, VEC>(x + base, y + base, threadIdx.y, N, TY, C, m, s, w, bb, slope);
}

// The backward in one kernel: block x owns a tile of columns of every
// sample, in turn: the sample's sums over every row, then its dx; the
// weight's and bias's gradients add the samples' sums in sample order.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    fused_backward(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean,
                   const float* __restrict__ invstd, const float* __restrict__ weight, const float* __restrict__ bias,
                   float* __restrict__ sums, float* __restrict__ grad_weight, float* __restrict__ grad_bias,
                   T* __restrict__ dx, int B, long long N, int C, float slope) {
  __shared__ float red[2 * kThreads * 8];
  __shared__ float res[2 * kFusedTx * 8];
  const int TX = blockDim.x, TY = blockDim.y, W = TX * VEC;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int col = blockIdx.x * TX + threadIdx.x;
  const bool live = col < C / VEC;
  const int own = blockIdx.x * W + tid;  // the channel whose gradients thread tid < W keeps
  const float n = (float)N;
  float gw = 0.0f, gb = 0.0f;
  for (int b = 0; b < B; ++b) {
    const long long base = (long long)b * N * C + col * VEC;
    float m[VEC], s[VEC], w[VEC], bb[VEC], a[VEC], g2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) a[i] = g2[i] = 0.0f;
    if (live) {
      load_channels<T, VEC>(mean, invstd, weight, bias, b, C, col, m, s, w, bb);
      thread_grads<T, VEC>(x + base, dy + base, threadIdx.y, N, TY, C, m, s, w, bb, slope, a, g2);
    }
    block_sums<VEC>(red, a, g2, res, res + W);
    if (tid < W && own < C) {
      sums[b * 2 * C + own] = res[tid];
      sums[b * 2 * C + C + own] = res[W + tid];
      gb += res[tid];
      gw += res[W + tid];
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a[i] = __fdiv_rn(res[threadIdx.x * VEC + i], n);
        g2[i] = __fdiv_rn(res[W + threadIdx.x * VEC + i], n);
      }
      dx_span<T, VEC>(x + base, dy + base, dx + base, threadIdx.y, N, TY, C, m, s, w, bb, a, g2, slope);
    }
    __syncthreads();  // res is the next sample's
  }
  if (tid < W && own < C) {
    grad_weight[own] = gw;
    grad_bias[own] = gb;
  }
}

// How a call cuts a (B, N, C) activation; every figure follows from B, N,
// C, the element size and the card's SM count.
struct Plan {
  int vec;         // values a thread loads at once
  int tx, ty;      // block: tx threads across columns (vectors), ty across rows
  int col_blocks;  // blocks across C
  int slabs;       // row slabs of a sample in the two-pass sums
  long long slab_rows;
  int row_blocks;  // blocks across a sample's rows in the elementwise passes
};

// fused: the geometry of the one-kernel entry points
bool make_plan(int B, long long N, int C, int elem, bool fused, Plan* p) {
  if (B < 1 || B > 65535 || N < 1 || C < 1 || (elem != 2 && elem != 4)) return false;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1) {
    return false;
  }
  p->vec = C % (16 / elem) == 0 ? 16 / elem : 1;
  const int v = C / p->vec;
  const int cap = fused ? kFusedTx : kMaxTx;
  p->tx = v < cap ? v : cap;
  p->ty = kThreads / p->tx;
  p->col_blocks = (v + p->tx - 1) / p->tx;
  const long long wave = (long long)sms * kBlocksPerSM;
  const long long tiles = (long long)p->col_blocks * B;
  const long long per = tiles < wave ? (wave + tiles - 1) / tiles : 1;  // blocks a (tile, sample)
  const long long by_rows = (N + (long long)p->ty * kUnroll - 1) / ((long long)p->ty * kUnroll);
  const long long by_bytes = N * elem / 128;  // 2C floats a slab <= 1/16 of the N*C*elem bytes read
  long long slabs = per < by_rows ? per : by_rows;
  slabs = slabs < by_bytes ? slabs : by_bytes;
  slabs = slabs > 1 ? slabs : 1;
  p->slab_rows = (N + slabs - 1) / slabs;
  p->slabs = (int)((N + p->slab_rows - 1) / p->slab_rows);  // none empty
  const long long rows = (N + p->ty - 1) / p->ty;
  p->row_blocks = (int)(per < rows ? per : rows);
  return true;
}

template <typename T, int VEC>
struct Kind {
  using type = T;
  static constexpr int vec = VEC;
};

// f(Kind<T, VEC>) for the activation's type and the plan's vector width
template <typename F>
int with_kind(int bf16, int vec, F f) {
  if (bf16) return vec == 8 ? f(Kind<__nv_bfloat16, 8>{}) : f(Kind<__nv_bfloat16, 1>{});
  return vec == 4 ? f(Kind<float, 4>{}) : f(Kind<float, 1>{});
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

int last_error() { return (int)cudaGetLastError(); }

int merge_blocks(int C) { return (C + kSumCols - 1) / kSumCols; }

}  // namespace

// The float32 scratch that mis_in_stats and mis_in_backward_reduce need on
// a (B, N, C) activation for their partial sums (B * slabs * 2C), into
// *work_floats.
extern "C" int mis_in_work_floats(int B, long long N, int C, int bf16, long long* work_floats) {
  Plan pl;
  if (!make_plan(B, N, C, bf16 ? 2 : 4, false, &pl)) return (int)cudaErrorInvalidValue;
  *work_floats = (long long)B * pl.slabs * 2 * C;
  return 0;
}

// mean and invstd (B, C) of x: two kernels.
extern "C" int mis_in_stats(const void* x, int B, long long N, int C, int bf16, float eps, float* work,
                            long long work_floats, float* mean, float* invstd, void* stream) {
  Plan pl;
  if (!make_plan(B, N, C, bf16 ? 2 : 4, false, &pl) || work_floats < (long long)B * pl.slabs * 2 * C) {
    return (int)cudaErrorInvalidValue;
  }
  if (pl.vec > 1 && !aligned(x)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = with_kind(bf16, pl.vec, [&](auto k) {
    using T = typename decltype(k)::type;
    moments_partial<T, decltype(k)::vec><<<dim3(pl.col_blocks, pl.slabs, B), dim3(pl.tx, pl.ty), 0, st>>>(
        static_cast<const T*>(x), N, C, pl.slab_rows, pl.slabs, work);
    return last_error();
  });
  if (err != 0) return err;
  auto merge = [&](auto k) {
    using T = typename decltype(k)::type;
    merge_moments<T><<<dim3(merge_blocks(C), B), dim3(kSumCols, kSumRows), 0, st>>>(
        static_cast<const T*>(x), work, N, C, pl.slab_rows, pl.slabs, eps, mean, invstd);
    return last_error();
  };
  return bf16 ? merge(Kind<__nv_bfloat16, 1>{}) : merge(Kind<float, 1>{});
}

// y = LeakyReLU((x - mean) * invstd * w + b): one kernel.
extern "C" int mis_in_normalize(const void* x, const float* mean, const float* invstd, const float* weight,
                                const float* bias, void* y, int B, long long N, int C, int bf16, float slope,
                                void* stream) {
  Plan pl;
  if (!make_plan(B, N, C, bf16 ? 2 : 4, false, &pl)) return (int)cudaErrorInvalidValue;
  if (pl.vec > 1 && !(aligned(x) && aligned(y))) return (int)cudaErrorMisalignedAddress;
  return with_kind(bf16, pl.vec, [&](auto k) {
    using T = typename decltype(k)::type;
    normalize_rows<T, decltype(k)::vec><<<dim3(pl.col_blocks, pl.row_blocks, B), dim3(pl.tx, pl.ty), 0,
                                          (cudaStream_t)stream>>>(
        static_cast<const T*>(x), mean, invstd, weight, bias, static_cast<T*>(y), N, C, slope);
    return last_error();
  });
}

// sums (B, 2C) = [sum g | sum g*x^] a sample, and the weight's and bias's
// gradients: two kernels.
extern "C" int mis_in_backward_reduce(const void* x, const void* dy, const float* mean, const float* invstd,
                                      const float* weight, const float* bias, int B, long long N, int C, int bf16,
                                      float slope, float* work, long long work_floats, float* sums,
                                      float* grad_weight, float* grad_bias, void* stream) {
  Plan pl;
  if (!make_plan(B, N, C, bf16 ? 2 : 4, false, &pl) || work_floats < (long long)B * pl.slabs * 2 * C) {
    return (int)cudaErrorInvalidValue;
  }
  if (pl.vec > 1 && !(aligned(x) && aligned(dy))) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = with_kind(bf16, pl.vec, [&](auto k) {
    using T = typename decltype(k)::type;
    grad_partial<T, decltype(k)::vec><<<dim3(pl.col_blocks, pl.slabs, B), dim3(pl.tx, pl.ty), 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), mean, invstd, weight, bias, N, C, pl.slab_rows,
        pl.slabs, slope, work);
    return last_error();
  });
  if (err != 0) return err;
  merge_grads<<<merge_blocks(C), dim3(kSumCols, kSumRows), 0, st>>>(work, B, C, pl.slabs, sums, grad_weight,
                                                                   grad_bias);
  return last_error();
}

// dx from the sums: one kernel.
extern "C" int mis_in_backward_elemt(const void* x, const void* dy, const float* mean, const float* invstd,
                                     const float* weight, const float* bias, const float* sums, void* dx, int B,
                                     long long N, int C, int bf16, float slope, void* stream) {
  Plan pl;
  if (!make_plan(B, N, C, bf16 ? 2 : 4, false, &pl)) return (int)cudaErrorInvalidValue;
  if (pl.vec > 1 && !(aligned(x) && aligned(dy) && aligned(dx))) return (int)cudaErrorMisalignedAddress;
  return with_kind(bf16, pl.vec, [&](auto k) {
    using T = typename decltype(k)::type;
    dx_rows<T, decltype(k)::vec><<<dim3(pl.col_blocks, pl.row_blocks, B), dim3(pl.tx, pl.ty), 0,
                                   (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), mean, invstd, weight, bias, sums, static_cast<T*>(dx),
        N, C, slope);
    return last_error();
  });
}

// The whole forward in one kernel (a fused plan): y, mean and invstd.
extern "C" int mis_in_fused_forward(const void* x, const float* weight, const float* bias, void* y, float* mean,
                                    float* invstd, int B, long long N, int C, int bf16, float eps, float slope,
                                    void* stream) {
  Plan pl;
  if (!make_plan(B, N, C, bf16 ? 2 : 4, true, &pl)) return (int)cudaErrorInvalidValue;
  if (pl.vec > 1 && !(aligned(x) && aligned(y))) return (int)cudaErrorMisalignedAddress;
  return with_kind(bf16, pl.vec, [&](auto k) {
    using T = typename decltype(k)::type;
    fused_forward<T, decltype(k)::vec><<<dim3(pl.col_blocks, 1, B), dim3(pl.tx, pl.ty), 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(x), weight, bias, static_cast<T*>(y), mean, invstd, N, C, eps, slope);
    return last_error();
  });
}

// The whole backward in one kernel (a fused plan): dx, the sums and the
// weight's and bias's gradients.
extern "C" int mis_in_fused_backward(const void* x, const void* dy, const float* mean, const float* invstd,
                                     const float* weight, const float* bias, float* sums, float* grad_weight,
                                     float* grad_bias, void* dx, int B, long long N, int C, int bf16, float slope,
                                     void* stream) {
  Plan pl;
  if (!make_plan(B, N, C, bf16 ? 2 : 4, true, &pl)) return (int)cudaErrorInvalidValue;
  if (pl.vec > 1 && !(aligned(x) && aligned(dy) && aligned(dx))) return (int)cudaErrorMisalignedAddress;
  return with_kind(bf16, pl.vec, [&](auto k) {
    using T = typename decltype(k)::type;
    fused_backward<T, decltype(k)::vec><<<pl.col_blocks, dim3(pl.tx, pl.ty), 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), mean, invstd, weight, bias, sums, grad_weight,
        grad_bias, static_cast<T*>(dx), B, N, C, slope);
    return last_error();
  });
}
