// The UNet's GroupNorm as two fused passes for Hopper (sm_90a): one read of
// an NHWC activation for its per-channel moments, one read and one write for
// the folded affine and the SiLU ahead of the next convolution.
//
// Replaces no TPU kernel: it ports the reference's XLA fusion of GroupNorm,
// image_restoration_platform_tpu/models/nn.py:81-125 (group_norm_stats,
// group_norm, _apply_affine, group_norm_cat). The reference writes
// GroupNorm as one-pass moments (sum x, sum x^2 per (n, c)) so that XLA fuses
// both reductions into the producing conv's epilogue, and folds
// (x - mean) * inv * scale + bias into one per-(n, c) affine so that the
// apply pass fuses into the SiLU and the next conv's prologue. Eager PyTorch
// runs the same formula as a chain of passes (casts to f32, a squared copy,
// two reductions, scale, shift, cast back, SiLU, and the conv bias add and
// FiLM before them); these two kernels give it the reference's traffic.
//
// gn_moments: s1[n, c] = sum_hw y, s2[n, c] = sum_hw y^2, f32, over an NHWC
// bf16 or f32 tensor. With the FiLM prologue the kernel reads the raw conv
// output r and builds y = (r + b) * (1 + gamma) + beta, rounding to the
// activation type after each of the four operations as the eager chain does
// (bias add, 1 + gamma, the product, + beta), writes y and sums it: y is the
// eager chain's bit for bit. The sums are deterministic: blocks split H*W in
// fixed chunks, each block reduces its rows in a fixed order through shared
// memory and writes its partial sums, and a second kernel adds the partials
// of every (n, c) in a fixed order (no atomics).
//
// gn_affine_silu: out = silu(cast(x * scale[n, c] + bias[n, c])) with the
// folded [N, C] f32 affine; the SiLU can be left off (the attention norm).
// It is _affine + F.silu bit for bit: __fmul_rn and __fadd_rn keep nvcc from
// contracting the affine into an FMA, the result is rounded to the
// activation type, then x / (1 + expf(-x)) in f32 (IEEE divide, no
// fast-math) and one more rounding.
//
// What bounds them on an H100 SXM (3.35 TB/s): bytes. Both do a few flops
// an element against 2 bytes of bf16 read (and 2 written); at the first
// folded level of a 512 b8 step ([8, 256, 128, 128] bf16, 67 MB) the
// moments must read 67 MB (0.020 ms), the FiLM prologue read and write
// 134 MB (0.040 ms), the affine + SiLU read and write 134 MB (0.040 ms).
// What the design does about it:
//
// * 16-byte loads and stores: a thread owns kVec consecutive channels (8
//   bf16 or 4 f32) of a pixel, so a warp reads whole 512-byte runs of a row
//   of channels; the wrappers refuse C that is no multiple of kVec and
//   pointers that are not 16-byte aligned.
// * the moments split H*W over enough blocks to fill the 132 SMs (the plan
//   is in ops/cuda/group_norm.py: about eight blocks an SM, at least two
//   pixels a thread): the smallest served tensor, [1, 128, 64, 128] at
//   256 b1, is one image of 128 channels. A thread keeps its channels for
//   all its pixels, so the FiLM vectors are loaded once a thread.
// * no f32 copy of the activation, no squared copy: the f32 sums stay in
//   registers and shared memory; the partials are N * splits * C floats,
//   added by a second kernel whose warps read 32 channels of a split and
//   whose eight lanes a channel split the splits (a fixed order still).
// * the affine reads its [N, C] vectors through a row stride, so each part
//   of the decoder's virtual concat takes its column slice without a copy.
//
// C interface (loaded with ctypes): each entry returns the cudaError_t of
// its launches; it launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Act;

template <>
struct Act<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ static float round(float x) { return x; }
};

template <>
struct Act<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
  __device__ __forceinline__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

// kVec f32 values from an f32 array (the folded affine)
template <int kVec>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x, v[i + 1] = a.y, v[i + 2] = a.z, v[i + 3] = a.w;
  }
}

// Partial moments of one (image, H*W chunk, channel tile). grid (splits,
// channel tiles, N). A tile is up to kThreads channel vectors; thread t owns
// vector t % cvt of it and walks pixels t / cvt, + rows, ... of the chunk.
// partial is [2, N, splits, C]: s1 then s2.
template <typename T, bool kFilm>
__global__ void __launch_bounds__(kThreads)
    gn_moments_partial(const T* __restrict__ x, const T* __restrict__ conv_bias, const T* __restrict__ film,
                       T* __restrict__ y, float* __restrict__ partial, int n_images, int hw, int c, int splits,
                       int chunk) {
  constexpr int V = Act<T>::kVec;
  __shared__ float red[2][kThreads * V];
  const int split = blockIdx.x, n = blockIdx.z, t = threadIdx.x;
  const int cv0 = blockIdx.y * kThreads;
  const int cvt = min(kThreads, c / V - cv0);
  const int rows = kThreads / cvt;
  const int rg = t / cvt;
  const bool active = rg < rows;
  const int ch = (cv0 + t % cvt) * V;

  float s1[V], s2[V], bias[V], gain[V], shift[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = 0.f, s2[k] = 0.f;
  if (kFilm && active) {
    Act<T>::load(conv_bias + ch, bias);
    Act<T>::load(film + (size_t)n * 2 * c + ch, gain);
    Act<T>::load(film + (size_t)n * 2 * c + c + ch, shift);
#pragma unroll
    for (int k = 0; k < V; ++k) gain[k] = Act<T>::round(__fadd_rn(1.f, gain[k]));
  }
  if (active) {
    const int p1 = min(hw, (split + 1) * chunk);
#pragma unroll 4
    for (int p = split * chunk + rg; p < p1; p += rows) {
      const size_t off = ((size_t)n * hw + p) * c + ch;
      float v[V];
      Act<T>::load(x + off, v);
      if (kFilm) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          v[k] = Act<T>::round(__fadd_rn(v[k], bias[k]));
          v[k] = Act<T>::round(__fmul_rn(v[k], gain[k]));
          v[k] = Act<T>::round(__fadd_rn(v[k], shift[k]));
        }
        Act<T>::store(y + off, v);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s1[k] += v[k];
        s2[k] = fmaf(v[k], v[k], s2[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) red[0][t * V + k] = s1[k], red[1][t * V + k] = s2[k];
  }
  __syncthreads();
  if (t < cvt) {  // row group 0 adds the others' sums in row-group order
    for (int r = 1; r < rows; ++r) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s1[k] += red[0][(r * cvt + t) * V + k];
        s2[k] += red[1][(r * cvt + t) * V + k];
      }
    }
    const size_t base = ((size_t)n * splits + split) * c + ch;
    const size_t plane = (size_t)n_images * splits * c;
#pragma unroll
    for (int k = 0; k < V; ++k) partial[base + k] = s1[k], partial[plane + base + k] = s2[k];
  }
}

// out[plane, n, c] = the sum over splits of partial[plane, n, :, c] in a
// fixed order: lane l of kCombineLanes adds splits l, l + kCombineLanes, ...
// in turn, then lane 0 adds the lanes' sums in lane order. grid (C / 32
// rounded up, N, 2); a warp reads 32 neighbouring channels of a split.
constexpr int kCombineLanes = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    gn_moments_combine(const float* __restrict__ partial, float* __restrict__ out, int n_images, int c, int splits) {
  __shared__ float red[kCombineLanes][32];
  const int lane_c = threadIdx.x % 32, lane_s = threadIdx.x / 32;
  const int ch = blockIdx.x * 32 + lane_c, n = blockIdx.y, plane = blockIdx.z;
  float acc = 0.f;
  if (ch < c) {
    const float* p = partial + ((size_t)plane * n_images * splits + (size_t)n * splits) * c + ch;
    for (int s = lane_s; s < splits; s += kCombineLanes) acc += p[(size_t)s * c];
  }
  red[lane_s][lane_c] = acc;
  __syncthreads();
  if (lane_s == 0 && ch < c) {
    for (int l = 1; l < kCombineLanes; ++l) acc += red[l][lane_c];
    out[((size_t)plane * n_images + n) * c + ch] = acc;
  }
}

// grid (vectors of one image / kThreads, N); row n of scale and bias starts
// at n * ld (the affine of one part of a virtual concat is a column slice)
template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreads)
    gn_affine_silu(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
                   T* __restrict__ out, int hw, int c, int ld) {
  constexpr int V = Act<T>::kVec;
  const unsigned per_image = (unsigned)hw * (unsigned)c;
  const unsigned e = (blockIdx.x * kThreads + threadIdx.x) * (unsigned)V;
  if (e >= per_image) return;
  const int n = blockIdx.y;
  const int ch = e % (unsigned)c;
  const size_t off = (size_t)n * per_image + e;
  float v[V], sc[V], bi[V];
  Act<T>::load(x + off, v);
  load_f32<V>(scale + (size_t)n * ld + ch, sc);
  load_f32<V>(bias + (size_t)n * ld + ch, bi);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float a = Act<T>::round(__fadd_rn(__fmul_rn(v[k], sc[k]), bi[k]));
    if (kSilu) a = Act<T>::round(a / (1.0f + expf(-a)));
    v[k] = a;
  }
  Act<T>::store(out + off, v);
}

template <typename T>
int launch_moments(const void* x, const void* conv_bias, const void* film, void* y, float* partial, float* out,
                   int n, int hw, int c, int splits, int chunk, bool with_film, cudaStream_t stream) {
  constexpr int V = Act<T>::kVec;
  if (n <= 0 || n > 65535 || hw <= 0 || c <= 0 || c % V || splits <= 0 || chunk <= 0 ||
      (long long)(splits - 1) * chunk >= hw || (long long)splits * chunk < hw)
    return cudaErrorInvalidValue;
  const int tiles = (c / V + kThreads - 1) / kThreads;
  // one split writes its sums straight into out ([2, N, 1, C] is [2, N, C])
  float* dst = splits == 1 ? out : partial;
  const dim3 grid(splits, tiles, n);
  if (with_film) {
    gn_moments_partial<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(conv_bias), static_cast<const T*>(film), static_cast<T*>(y),
        dst, n, hw, c, splits, chunk);
  } else {
    gn_moments_partial<T, false><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), nullptr, nullptr, nullptr,
                                                                dst, n, hw, c, splits, chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  gn_moments_combine<<<dim3((c + 31) / 32, n, 2), kThreads, 0, stream>>>(partial, out, n, c, splits);
  return cudaGetLastError();
}

template <typename T>
int launch_affine(const void* x, const float* scale, const float* bias, void* out, int n, int hw, int c, int ld,
                  bool silu, cudaStream_t stream) {
  constexpr int V = Act<T>::kVec;
  if (n <= 0 || n > 65535 || hw <= 0 || c <= 0 || c % V || ld < c || ld % 4 || (long long)hw * c >= (1LL << 31))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((long long)hw * c / V + kThreads - 1) / kThreads), n);
  if (silu) {
    gn_affine_silu<T, true><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), scale, bias,
                                                           static_cast<T*>(out), hw, c, ld);
  } else {
    gn_affine_silu<T, false><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), scale, bias,
                                                            static_cast<T*>(out), hw, c, ld);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16. x [N, H*W, C]; with film, conv_bias [C] and film
// [N, 2C] (gamma | beta) in x's type, and y [N, H*W, C] written. partial
// [2, N, splits, C] f32 scratch (unused when splits == 1), out [2, N, C] f32.
int irp_gn_moments(const void* x, const void* conv_bias, const void* film, void* y, void* partial, void* out, int n,
                   int hw, int c, int splits, int chunk, int dtype, int with_film, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (dtype == 1)
    return launch_moments<__nv_bfloat16>(x, conv_bias, film, y, p, o, n, hw, c, splits, chunk, with_film != 0, s);
  if (dtype == 0) return launch_moments<float>(x, conv_bias, film, y, p, o, n, hw, c, splits, chunk, with_film != 0, s);
  return cudaErrorInvalidValue;
}

// out = silu(cast(x * scale + bias)) (silu = 0: the cast affine alone);
// x and out [N, H*W, C] of dtype, scale and bias [N, C] f32 rows ld floats
// apart (ld >= C, a multiple of 4).
int irp_gn_affine_silu(const void* x, const void* scale, const void* bias, void* out, int n, int hw, int c, int ld,
                       int dtype, int silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 1) return launch_affine<__nv_bfloat16>(x, sc, bi, out, n, hw, c, ld, silu != 0, s);
  if (dtype == 0) return launch_affine<float>(x, sc, bi, out, n, hw, c, ld, silu != 0, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
