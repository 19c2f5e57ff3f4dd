// Residual add and LayerNorm of the Swin transformer's token stream, with the
// shifted windows' addressing, for Hopper (sm_90a). SwinIR's Swin layer
// (models/swinir.py) calls it twice:
//
//   to_windows   x [B, H, W, C] and an optional a [B, H, W, C], both in token
//                order: writes s = x + a in token order (nothing when a is
//                absent: s is x) and LayerNorm(s) in the rolled window layout
//                [B * nW, 64, C] that the qkv linear reads, row (n, t) holding
//                the token at ((wy * 8 + t / 8 + shift) mod H,
//                (wx * 8 + t % 8 + shift) mod W) of window n = (b, wy, wx):
//                torch.roll(-shift) then the window partition;
//   from_windows x [B, H, W, C] in token order and the proj linear's output p
//                [B * nW, 64, C] in that window layout: writes s = x +
//                roll(+shift)(window_reverse(p)) and LayerNorm(s), both in
//                token order. p is gathered through the same map.
//
// All tensors are bf16. Each sum is rounded to bf16 once, from the f32 sum
// of its two bf16 terms, as PyTorch's bf16 add rounds it. The LayerNorm takes
// f32 statistics of the bf16 sum (the mean, then the mean square deviation:
// both passes over values held in registers), rstd = rsqrt(var + eps), and
// writes gamma * (rstd * (s - mean)) + beta in f32, rounded to bf16, with the
// affine read in bf16: F.layer_norm on a bf16 tensor does the same, its
// statistics by Welford's update, so the two agree within one bf16 ulp.
//
// It replaces no TPU kernel: the JAX package has no transformer. It takes the
// place of five PyTorch passes around the window attention (the LayerNorm,
// both torch.rolls, the window partition and reverse copies, the residual
// adds), each of which read and wrote the whole residual stream.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. A launch reads x and its
// operand and writes the sum and the normalised copy, 4 * 64 * C * 2 bytes a
// window, against ~10 operations an element. At SwinIR-M's chunk of 8 tiles
// of 256 x 256 (8,192 windows, C = 180) that is 754,974,720 bytes, 0.225 ms at
// the memory rate (half of it where a is absent). What the design does about
// it:
//
// * one block a window, its 64 rows in pairs: two neighbouring tokens 2t and
//   2t + 1 of a window row are 2C bf16, a contiguous run in both layouts.
//   The roll never separates them (the shift is even and so is W), and with
//   C % 4 == 0 every pair starts on a 16-byte boundary (a 180-wide token row
//   is only 8-byte aligned, a pair is 720 bytes), so the window's rows of x
//   and of the operand are copied into shared memory with 16-byte cp.async,
//   neighbouring threads on neighbouring addresses: a window row is one
//   2,880-byte run of the image, or two of 1,440 bytes at the image's last
//   window column under the roll;
// * up to four blocks on an SM (46 KB of shared memory each at C = 180):
//   while one block normalises, the others' copies are in flight;
// * a warp then takes two tokens at a time: each lane adds and holds its
//   bf16 pairs of both tokens in f32 registers, the warp's butterfly gives
//   every lane the sums, and the sums and the normalised values leave the
//   registers as 4-byte stores, 128 contiguous bytes a warp instruction, in
//   the layout each output wants. Nothing is read twice from device memory.
//
// C interface (loaded with ctypes): irp_swin_add_norm returns the cudaError_t
// of the launch; it launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 8;
constexpr int kTokens = kWindow * kWindow;  // 64 rows a window
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChannels = 256;
constexpr int kMaxWords = kMaxChannels / 64;  // bf16 pairs of a token a lane holds
constexpr int kRows = 2;                      // tokens a warp normalises at once

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool kToWindows, bool kAdd>
__global__ void __launch_bounds__(kThreads, 4)
    swin_add_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                         const __nv_bfloat16* __restrict__ gamma, const __nv_bfloat16* __restrict__ beta,
                         __nv_bfloat16* __restrict__ sum, __nv_bfloat16* __restrict__ norm, int channels,
                         int grid_h, int grid_w, int shift, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [64, C], window rows in order
  __nv_bfloat16* as = xs + kTokens * channels;                 // [64, C], the operand (kAdd)

  // the window's place: image b, window (wy, wx); its rows' tokens in the image
  const int window = blockIdx.x;
  const int per_image = grid_h * grid_w;
  const int b = window / per_image;
  const int wy = (window - b * per_image) / grid_w;
  const int wx = window - b * per_image - wy * grid_w;
  const int image_h = grid_h * kWindow, image_w = grid_w * kWindow;
  const size_t image0 = static_cast<size_t>(b) * image_h * image_w;
  // the token-order row of window row t (roll(-shift), then partition)
  auto token = [&](int t) -> size_t {
    int y = wy * kWindow + (t >> 3) + shift;
    int xx = wx * kWindow + (t & 7) + shift;
    if (y >= image_h) y -= image_h;
    if (xx >= image_w) xx -= image_w;
    return image0 + static_cast<size_t>(y) * image_w + xx;
  };
  const size_t row0 = static_cast<size_t>(window) * kTokens;  // the window layout's first row

  // x's and the operand's rows into shared memory, a pair of tokens at a time
  const int per_pair = channels / 4;  // 16-byte copies in 2C bf16
  const int copies = (kTokens / 2) * per_pair;
  for (int i = threadIdx.x; i < copies; i += kThreads) {
    const int pair = i / per_pair;
    const int part = i - pair * per_pair;
    const int t = 2 * pair;
    const size_t tok = token(t);
    const size_t dst = static_cast<size_t>(t) * channels + 8 * part;
    cp_async16(xs + dst, x + tok * channels + 8 * part);
    if (kAdd) cp_async16(as + dst, a + (kToWindows ? tok : row0 + t) * channels + 8 * part);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int words = channels / 2;  // bf16 pairs of a token; lane owns words lane + 32k
  float2 g[kMaxWords], be[kMaxWords];
#pragma unroll
  for (int k = 0; k < kMaxWords; ++k) {
    const int j = lane + 32 * k;
    g[k] = be[k] = make_float2(0.f, 0.f);
    if (j < words) {
      g[k] = unpack(reinterpret_cast<const uint32_t*>(gamma)[j]);
      be[k] = unpack(reinterpret_cast<const uint32_t*>(beta)[j]);
    }
  }

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int t0 = warp; t0 < kTokens; t0 += kRows * kWarps) {
    float2 v[kRows][kMaxWords];  // the bf16 sums, exactly, in f32
    float mean[kRows], var[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + r * kWarps;
      const uint32_t* xr = reinterpret_cast<const uint32_t*>(xs + t * channels);
      const uint32_t* ar = reinterpret_cast<const uint32_t*>(as + t * channels);
      mean[r] = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k) {
        const int j = lane + 32 * k;
        v[r][k] = make_float2(0.f, 0.f);
        if (j < words) {
          v[r][k] = unpack(xr[j]);
          if (kAdd) {
            const float2 av = unpack(ar[j]);
            v[r][k] = unpack(pack(v[r][k].x + av.x, v[r][k].y + av.y));
          }
          mean[r] += v[r][k].x + v[r][k].y;
        }
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) mean[r] += __shfl_xor_sync(0xffffffffu, mean[r], m);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      mean[r] /= static_cast<float>(channels);
      var[r] = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k) {
        if (lane + 32 * k < words) {
          const float dx = v[r][k].x - mean[r], dy = v[r][k].y - mean[r];
          var[r] += dx * dx + dy * dy;
        }
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) var[r] += __shfl_xor_sync(0xffffffffu, var[r], m);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + r * kWarps;
      const float rstd = rsqrtf(var[r] / static_cast<float>(channels) + eps);
      const size_t tok = token(t);
      uint32_t* srow = reinterpret_cast<uint32_t*>(sum + tok * channels);
      uint32_t* nrow = reinterpret_cast<uint32_t*>(norm + (kToWindows ? row0 + t : tok) * channels);
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k) {
        const int j = lane + 32 * k;
        if (j < words) {
          if (kAdd) srow[j] = pack(v[r][k].x, v[r][k].y);  // exact: v holds bf16 values
          nrow[j] = pack(g[k].x * (rstd * (v[r][k].x - mean[r])) + be[k].x,
                         g[k].y * (rstd * (v[r][k].y - mean[r])) + be[k].y);
        }
      }
    }
  }
}

template <bool kToWindows, bool kAdd>
cudaError_t launch(const void* x, const void* a, const void* gamma, const void* beta, void* sum, void* norm,
                   int windows, int channels, int grid_h, int grid_w, int shift, float eps, cudaStream_t stream) {
  const int smem_bytes = (kAdd ? 2 : 1) * kTokens * channels * 2;
  auto* kernel = swin_add_norm_kernel<kToWindows, kAdd>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<windows, kThreads, smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(gamma), static_cast<const __nv_bfloat16*>(beta),
      static_cast<__nv_bfloat16*>(sum), static_cast<__nv_bfloat16*>(norm), channels, grid_h, grid_w, shift, eps);
  return cudaGetLastError();
}

}  // namespace

// to_windows: 1 for the to_windows form (a in token order, or null: no add,
// sum unused), 0 for from_windows (a is p in the window layout, not null);
// windows: B * grid_h * grid_w, batch-major, rows of each row-major;
// channels: C, a multiple of 4 up to 256; shift: 0 or an even roll below 8.
// x, a, sum and norm are 16-byte aligned.
extern "C" int irp_swin_add_norm(const void* x, const void* a, const void* gamma, const void* beta, void* sum,
                                 void* norm, int to_windows, int windows, int channels, int grid_h, int grid_w,
                                 int shift, float eps, void* stream) {
  if (channels < 4 || channels > kMaxChannels || channels % 4 != 0 || windows < 1 || grid_h < 1 || grid_w < 1 ||
      windows % (grid_h * grid_w) != 0 || shift < 0 || shift >= kWindow || shift % 2 != 0 ||
      (!to_windows && a == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!to_windows) {
    err = launch<false, true>(x, a, gamma, beta, sum, norm, windows, channels, grid_h, grid_w, shift, eps, s);
  } else if (a != nullptr) {
    err = launch<true, true>(x, a, gamma, beta, sum, norm, windows, channels, grid_h, grid_w, shift, eps, s);
  } else {
    err = launch<true, false>(x, a, gamma, beta, sum, norm, windows, channels, grid_h, grid_w, shift, eps, s);
  }
  return static_cast<int>(err);
}
