// Global (cross-rank) BatchNorm for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package leaves flax's BatchNorm to XLA,
// which fuses it over a sharded batch. It replaces the port's own eager
// float32 passes of models/batchnorm.py's global path (data-parallel
// training): a float32 copy of the activation, its square and two sums for
// the statistics; a float32 x^ then the affine and a cast for the normalize;
// float32 copies of dy and x, x^ again, a product, two sums and a five-term
// dx in the backward. Each of those was a pass over device memory with
// float32 intermediates, ~66 bytes a value forward and ~90 backward. One
// card's training BatchNorm runs the same four entry points with no
// all-reduce between them, in place of cuDNN's training batch norm, which
// reads at 16-59% of the same byte bound (chip_smoke.py's bn_kernels).
//
// The input is an (M, C) row-major matrix: a 2-D (N, C) tensor, a 4-D
// channels_last or a 5-D channels_last_3d one, in bfloat16 or float32. Four
// entry points, the same mathematics and exchange as the plain version
// (ops/global_batchnorm.py; flax's variance E[x^2] - E[x]^2):
// 1. mis_gbn_stats: this rank's [sum x, sum x^2, M] into the buffer that the
//    caller all-reduces;
// 2. mis_gbn_normalize: a prologue turns the all-reduced sums into mean,
//    var = max(sum x^2/n - mean^2, 0) and invstd = rsqrt(var + eps), keeps
//    mean and invstd for the backward and applies the running statistics'
//    momentum; then y = ((x - mean) * invstd) * w + b in float32, rounded
//    once to the activation's type;
// 3. mis_gbn_backward_reduce: this rank's [sum dy, sum dy*x^] (x^ recomputed
//    in registers) into the buffer for the all-reduce, and copies of them,
//    the bias's and scale's gradients;
// 4. mis_gbn_backward_elemt: dx = (w*invstd) * ((dy - sum dy/n) - x^ * (sum dy*x^/n)).
// Every product and sum of 2 and 4, and of the normalize's prologue, is
// rounded on its own (__fmul_rn, __fadd_rn, ...) in the plain version's
// order, so given the same sums the output equals the plain version's.
//
// What bounds it: bytes. The least a layer needs is one read of x for the
// sums, then one read of x and one write of y (6 bytes a bf16 value) forward,
// and one read of x and dy, then one read of each and a write of dx (10
// bytes) backward. At byol_r18.ddp4's shapes (a rank's 4096 views through
// ResNet-18's 20 BatchNorms in both towers) that is ~57 GB a step, ~17 ms at
// 3.35 TB/s. The design, against that bound:
// - Threads across C, 16 bytes a load (8 bf16 or 4 float32 values; one value
//   where C does not allow it), the rest of a block's 256 threads across
//   rows: a warp reads whole rows or 512 contiguous bytes of one, and keeps
//   each value's per-channel constants in registers.
// - Each thread has kUnroll rows' loads in flight before it uses them.
// - The sums are two passes with no atomics, so they are the same from run
//   to run: a fixed set of row slabs (from M, C and the card's SM count
//   alone) each writes a partial row of 2C floats after a fixed-order
//   reduction in shared memory; the second pass sums the slabs in a fixed
//   order and writes the result, and n, straight into the all-reduce buffer.
//   The slabs fill one wave of the card (kBlocksPerSM blocks an SM, which
//   the launch bounds guarantee), and their partial rows stay under 1/16 of
//   the bytes the pass reads.
// - The elementwise passes stride over rows with one wave of blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (done at first use by ops/_kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads a block of the row passes
constexpr int kBlocksPerSM = 3; // resident an SM: <= 85 registers a thread, one wave exactly
constexpr int kUnroll = 4;      // rows whose loads a thread has in flight (half as many
                                // where it reads x and dy: the same bytes)
constexpr int kSumCols = 32;    // columns a block of the second pass sums
constexpr int kSumRows = 32;    // and the strided subsets of slabs it splits them over

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

// x^ = (x - mean) * invstd, as the plain version rounds it
__device__ __forceinline__ float xhat(float x, float mean, float invstd) {
  return __fmul_rn(__fsub_rn(x, mean), invstd);
}

// One row's VEC values into the two running sums: (x, x^2) for the
// statistics, (dy, dy*x^) for the backward.
template <typename T, int VEC, bool BWD>
__device__ __forceinline__ void accumulate(const Pack<T, VEC>& px, const Pack<T, VEC>& pd, const float (&m)[VEC],
                                           const float (&s)[VEC], float (&a)[VEC], float (&b)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float xv = to_float(px.v[i]);
    if constexpr (BWD) {
      const float d = to_float(pd.v[i]);
      a[i] += d;
      b[i] = fmaf(d, xhat(xv, m[i], s[i]), b[i]);
    } else {
      a[i] += xv;
      b[i] = fmaf(xv, xv, b[i]);
    }
  }
}

// First pass of the sums: block (x, y) covers a tile of columns and the row
// slab [y * slab_rows, (y + 1) * slab_rows); it writes row y of the (slabs,
// 2C) partials, [sums a | sums b], after a fixed-order reduction over its
// threads' rows.
template <typename T, int VEC, bool BWD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    partial_sums(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean,
                 const float* __restrict__ invstd, long long M, int C, long long slab_rows,
                 float* __restrict__ partial) {
  __shared__ float red[2 * kThreads * 8];
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, TY = blockDim.y;
  const int col = blockIdx.x * TX + tx;  // in vectors
  const bool live = col < C / VEC;
  float a[VEC], b[VEC], m[VEC], s[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[i] = b[i] = 0.0f;
    m[i] = s[i] = 0.0f;
    if (BWD && live) {
      m[i] = mean[col * VEC + i];
      s[i] = invstd[col * VEC + i];
    }
  }
  if (live) {
    const long long r0 = blockIdx.y * slab_rows;
    const long long r1 = min(M, r0 + slab_rows);
    const T* xc = x + col * VEC;
    const T* dc = BWD ? dy + col * VEC : xc;
    constexpr int U = BWD ? kUnroll / 2 : kUnroll;
    long long r = r0 + ty;
    for (; r + (U - 1) * TY < r1; r += U * TY) {
      Pack<T, VEC> px[U], pd[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        px[u] = load<T, VEC>(xc + (r + u * TY) * C);
        if constexpr (BWD) pd[u] = load<T, VEC>(dc + (r + u * TY) * C);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) accumulate<T, VEC, BWD>(px[u], BWD ? pd[u] : px[u], m, s, a, b);
    }
    for (; r < r1; r += TY) {
      const Pack<T, VEC> px = load<T, VEC>(xc + r * C);
      const Pack<T, VEC> pd = BWD ? load<T, VEC>(dc + r * C) : px;
      accumulate<T, VEC, BWD>(px, pd, m, s, a, b);
    }
  }
  const int width = TX * VEC;  // values of a block row
  float* row = red + ty * 2 * width;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    row[tx * VEC + i] = a[i];
    row[width + tx * VEC + i] = b[i];
  }
  __syncthreads();
  for (int j = ty * TX + tx; j < 2 * width; j += TX * TY) {
    float acc = 0.0f;
    for (int k = 0; k < TY; ++k) acc += red[k * 2 * width + j];
    const int hi = j >= width;
    const int c = blockIdx.x * width + (j - hi * width);
    if (c < C) partial[(long long)blockIdx.y * 2 * C + hi * C + c] = acc;
  }
}

// Second pass: each of the 2C columns summed over the slabs in a fixed order
// into out; lo and hi (may be null) take copies of the first and second C;
// count >= 0 is written after them, at out[2C].
__global__ void __launch_bounds__(kSumCols * kSumRows)
    sum_slabs(const float* __restrict__ partial, int slabs, int width, float* __restrict__ out,
              float* __restrict__ lo, float* __restrict__ hi, float count) {
  __shared__ float red[kSumRows][kSumCols + 1];
  const int j = blockIdx.x * kSumCols + threadIdx.x;
  float acc = 0.0f;
  if (j < width) {
#pragma unroll 8
    for (int g = threadIdx.y; g < slabs; g += kSumRows) acc += partial[(long long)g * width + j];
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float sum = 0.0f;
    for (int k = 0; k < kSumRows; ++k) sum += red[k][threadIdx.x];
    out[j] = sum;
    const int half = width / 2;
    if (j < half && lo != nullptr) lo[j] = sum;
    if (j >= half && hi != nullptr) hi[j - half] = sum;
  }
  if (count >= 0.0f && blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) out[width] = count;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    normalize_rows(const T* __restrict__ x, const float* __restrict__ sums, const float* __restrict__ weight,
                   const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ mean_out,
                   float* __restrict__ invstd_out, float* __restrict__ running_mean, float* __restrict__ running_var,
                   float keep, float take, float eps, long long M, int C) {
  const int TY = blockDim.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C / VEC) return;  // no barrier below
  const float n = sums[2 * C];
  const bool owner = blockIdx.y == 0 && threadIdx.y == 0;  // one writer a channel
  float m[VEC], s[VEC], w[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = col * VEC + i;
    m[i] = __fdiv_rn(sums[c], n);
    float var = __fsub_rn(__fdiv_rn(sums[C + c], n), __fmul_rn(m[i], m[i]));
    var = var < 0.0f ? 0.0f : var;  // keeps a NaN, as clamp_min does
    s[i] = rsqrtf(__fadd_rn(var, eps));
    w[i] = weight[c];
    b[i] = bias[c];
    if (owner) {
      mean_out[c] = m[i];
      invstd_out[c] = s[i];
      if (running_mean != nullptr) {
        running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], keep), __fmul_rn(m[i], take));
        running_var[c] = __fadd_rn(__fmul_rn(running_var[c], keep), __fmul_rn(var, take));
      }
    }
  }
  const long long step = (long long)gridDim.y * TY;
  const T* xc = x + col * VEC;
  T* yc = y + col * VEC;
  auto one = [&](const Pack<T, VEC>& px, long long r) {
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out.v[i] = from_float<T>(__fadd_rn(__fmul_rn(xhat(to_float(px.v[i]), m[i], s[i]), w[i]), b[i]));
    }
    store<T, VEC>(yc + r * C, out);
  };
  long long r = (long long)blockIdx.y * TY + threadIdx.y;
  for (; r + (kUnroll - 1) * step < M; r += kUnroll * step) {
    Pack<T, VEC> px[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) px[u] = load<T, VEC>(xc + (r + u * step) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) one(px[u], r + u * step);
  }
  for (; r < M; r += step) one(load<T, VEC>(xc + r * C), r);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    backward_rows(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ weight,
                  const float* __restrict__ mean, const float* __restrict__ invstd, const float* __restrict__ sums,
                  const float* __restrict__ count, T* __restrict__ dx, long long M, int C) {
  const int TY = blockDim.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C / VEC) return;
  const float n = count[0];
  float m[VEC], s[VEC], k[VEC], a[VEC], g[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = col * VEC + i;
    m[i] = mean[c];
    s[i] = invstd[c];
    k[i] = __fmul_rn(weight[c], s[i]);
    a[i] = __fdiv_rn(sums[c], n);
    g[i] = __fdiv_rn(sums[C + c], n);
  }
  const long long step = (long long)gridDim.y * TY;
  const T* xc = x + col * VEC;
  const T* dc = dy + col * VEC;
  T* oc = dx + col * VEC;
  auto one = [&](const Pack<T, VEC>& px, const Pack<T, VEC>& pd, long long r) {
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float h = xhat(to_float(px.v[i]), m[i], s[i]);
      const float inner = __fsub_rn(__fsub_rn(to_float(pd.v[i]), a[i]), __fmul_rn(h, g[i]));
      out.v[i] = from_float<T>(__fmul_rn(k[i], inner));
    }
    store<T, VEC>(oc + r * C, out);
  };
  long long r = (long long)blockIdx.y * TY + threadIdx.y;
  constexpr int U = kUnroll / 2;
  for (; r + (U - 1) * step < M; r += U * step) {
    Pack<T, VEC> px[U], pd[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      px[u] = load<T, VEC>(xc + (r + u * step) * C);
      pd[u] = load<T, VEC>(dc + (r + u * step) * C);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) one(px[u], pd[u], r + u * step);
  }
  for (; r < M; r += step) one(load<T, VEC>(xc + r * C), load<T, VEC>(dc + r * C), r);
}

// How a call cuts an (M, C) matrix; every figure follows from M, C, the
// element size and the card's SM count.
struct Plan {
  int vec;         // values a thread loads at once
  int tx, ty;      // block: tx threads across columns (vectors), ty across rows
  int col_blocks;  // blocks across C
  int slabs;       // row slabs of the two-pass sums
  int row_blocks;  // blocks across rows of the elementwise passes
  long long slab_rows;
};

bool make_plan(long long M, int C, int elem, Plan* p) {
  if (M < 1 || C < 1 || (elem != 2 && elem != 4)) return false;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1) {
    return false;
  }
  p->vec = C % (16 / elem) == 0 ? 16 / elem : 1;
  const int v = C / p->vec;
  p->tx = v < kThreads ? v : kThreads;
  p->ty = kThreads / p->tx;
  p->col_blocks = (v + p->tx - 1) / p->tx;
  const long long wave = (long long)sms * kBlocksPerSM;
  const long long per_col = (wave + p->col_blocks - 1) / p->col_blocks;
  const long long by_rows = (M + (long long)p->ty * kUnroll - 1) / ((long long)p->ty * kUnroll);  // kUnroll rows a thread
  const long long by_bytes = M * elem / 128;  // 2C floats a slab <= 1/16 of the M*C*elem bytes read
  long long slabs = per_col < by_rows ? per_col : by_rows;
  slabs = slabs < by_bytes ? slabs : by_bytes;
  p->slabs = (int)(slabs > 1 ? slabs : 1);
  p->slab_rows = (M + p->slabs - 1) / p->slabs;
  const long long rows = (M + p->ty - 1) / p->ty;
  p->row_blocks = (int)(per_col < rows ? per_col : rows);
  return p->col_blocks <= 65535;
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

// Both passes of a sum over rows into out[0 .. 2C) (and out[2C] = count if
// count >= 0; copies into lo and hi if they are not null).
template <typename T, int VEC, bool BWD>
int two_pass(const Plan& pl, const void* x, const void* dy, const float* mean, const float* invstd, long long M,
             int C, float* work, float* out, float* lo, float* hi, float count, cudaStream_t st) {
  partial_sums<T, VEC, BWD><<<dim3(pl.col_blocks, pl.slabs), dim3(pl.tx, pl.ty), 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, invstd, M, C, pl.slab_rows, work);
  int err = last_error();
  if (err != 0) return err;
  sum_slabs<<<(2 * C + kSumCols - 1) / kSumCols, dim3(kSumCols, kSumRows), 0, st>>>(work, pl.slabs, 2 * C, out, lo,
                                                                                      hi, count);
  return last_error();
}

}  // namespace

// The float32 scratch a call of mis_gbn_stats or mis_gbn_backward_reduce on
// an (M, C) matrix needs for its partial sums, into *floats.
extern "C" int mis_gbn_work_floats(long long M, int C, int bf16, long long* floats) {
  Plan pl;
  if (!make_plan(M, C, bf16 ? 2 : 4, &pl)) return (int)cudaErrorInvalidValue;
  *floats = (long long)pl.slabs * 2 * C;
  return 0;
}

extern "C" int mis_gbn_stats(const void* x, long long M, int C, int bf16, float* work, long long work_floats,
                             float* out, void* stream) {
  Plan pl;
  if (!make_plan(M, C, bf16 ? 2 : 4, &pl) || work_floats < (long long)pl.slabs * 2 * C) {
    return (int)cudaErrorInvalidValue;
  }
  if (pl.vec > 1 && !aligned(x)) return (int)cudaErrorMisalignedAddress;
  return with_kind(bf16, pl.vec, [&](auto k) {
    using T = typename decltype(k)::type;
    return two_pass<T, decltype(k)::vec, false>(pl, x, nullptr, nullptr, nullptr, M, C, work, out, nullptr, nullptr,
                                                (float)M, (cudaStream_t)stream);
  });
}

extern "C" int mis_gbn_normalize(const void* x, const float* sums, const float* weight, const float* bias, void* y,
                                 float* mean, float* invstd, float* running_mean, float* running_var, float keep,
                                 float take, float eps, long long M, int C, int bf16, void* stream) {
  Plan pl;
  if (!make_plan(M, C, bf16 ? 2 : 4, &pl) || ((running_mean == nullptr) != (running_var == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (pl.vec > 1 && !(aligned(x) && aligned(y))) return (int)cudaErrorMisalignedAddress;
  return with_kind(bf16, pl.vec, [&](auto k) {
    using T = typename decltype(k)::type;
    normalize_rows<T, decltype(k)::vec><<<dim3(pl.col_blocks, pl.row_blocks), dim3(pl.tx, pl.ty), 0,
                                          (cudaStream_t)stream>>>(
        static_cast<const T*>(x), sums, weight, bias, static_cast<T*>(y), mean, invstd, running_mean, running_var,
        keep, take, eps, M, C);
    return last_error();
  });
}

extern "C" int mis_gbn_backward_reduce(const void* x, const void* dy, const float* mean, const float* invstd,
                                       long long M, int C, int bf16, float* work, long long work_floats,
                                       float* out, float* grad_weight, float* grad_bias, void* stream) {
  Plan pl;
  if (!make_plan(M, C, bf16 ? 2 : 4, &pl) || work_floats < (long long)pl.slabs * 2 * C) {
    return (int)cudaErrorInvalidValue;
  }
  if (pl.vec > 1 && !(aligned(x) && aligned(dy))) return (int)cudaErrorMisalignedAddress;
  return with_kind(bf16, pl.vec, [&](auto k) {
    using T = typename decltype(k)::type;
    return two_pass<T, decltype(k)::vec, true>(pl, x, dy, mean, invstd, M, C, work, out, grad_bias, grad_weight,
                                               -1.0f, (cudaStream_t)stream);
  });
}

extern "C" int mis_gbn_backward_elemt(const void* x, const void* dy, const float* weight, const float* mean,
                                      const float* invstd, const float* sums, const float* count, void* dx,
                                      long long M, int C, int bf16, void* stream) {
  Plan pl;
  if (!make_plan(M, C, bf16 ? 2 : 4, &pl)) return (int)cudaErrorInvalidValue;
  if (pl.vec > 1 && !(aligned(x) && aligned(dy) && aligned(dx))) return (int)cudaErrorMisalignedAddress;
  return with_kind(bf16, pl.vec, [&](auto k) {
    using T = typename decltype(k)::type;
    backward_rows<T, decltype(k)::vec><<<dim3(pl.col_blocks, pl.row_blocks), dim3(pl.tx, pl.ty), 0,
                                         (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), weight, mean, invstd, sums, count,
        static_cast<T*>(dx), M, C);
    return last_error();
  });
}
