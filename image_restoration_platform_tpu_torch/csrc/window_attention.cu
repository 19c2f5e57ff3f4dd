// Shifted-window multi-head self-attention of the Swin transformer (SwinIR's
// W-MSA and SW-MSA) for Hopper (sm_90a). qkv [windows, 64, 3 * C] bf16, the
// qkv linear's output as it stands (per token: the heads' q, then their k,
// then their v, each head D = C / heads wide); out [windows, 64, C] bf16, the
// heads side by side as the proj linear reads them. For each window and head:
//
//   softmax(Q K^T * scale + B[h] + M) V
//
// with the relative-position bias B[h][i, j] = table[rel(i, j), h] read from
// the [(2 * 8 - 1)^2, heads] f32 table, and on shifted layers M[i, j] = -100
// where tokens i and j lie in different regions of the rolled image (the
// published SW-MSA mask), 0 elsewhere.
//
// It replaces no TPU kernel: the JAX package has no transformer. It was added
// because nothing else computes this attention on the card: the flash kernel
// (flash_attention.cu) takes no bias or mask and D of 32 or 64 only, and a
// plain product would write the 64 x 64 scores of every (window, head) to
// memory and read them back several times, more bytes than q, k, v and o
// together.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. A window's q, k and v are
// read once and its o written once, 4 * 64 * C * 2 bytes, against
// 4 * 64 * 64 * C operations (QK^T and PV): 32 operations a byte, far below
// the ~295 at which the tensor cores would be the limit. At SwinIR-M's shape
// (8 tiles of 256 x 256, 8,192 windows, C = 180 = 6 x 30) a launch moves
// 754,974,720 bytes, 0.225 ms at the memory rate. What the design does about
// it:
//
// * one block a window: its 64 x 3C bf16 (69,120 bytes at C = 180) is one
//   contiguous, 16-byte aligned run of qkv, copied whole into shared memory
//   with 16-byte cp.async, so the loads are as wide and as coalesced as the
//   card allows and no permute of q, k, v ever goes through device memory;
// * three blocks on an SM (69 KB of shared memory each, 256 threads): while
//   one block computes, the others' copies are in flight;
// * the softmax and both products stay in registers: a warp owns 16 query
//   rows of one head (a unit; 4 x heads units a window, 3 a warp at 6 heads)
//   and computes its 16 x 64 scores with mma.sync m16n8k16 (bf16 in, f32
//   accumulate; D is padded to 32 with zeros in the fragments, not in
//   memory), adds the bias and the mask, takes the softmax in f32, rounds the
//   probabilities to bf16 and multiplies them by V from shared memory;
// * the mask is never read: each block works out the regions of its tokens
//   from its window's place (wy, wx) in the (grid_h, grid_w) window grid,
//   as the published mask is built from slices of the image;
// * o is written straight from the accumulators, 4 bytes a lane; L2 merges a
//   window's rows before they reach device memory.
//
// Round-off: the scores are f32, the softmax's exponent is exp2 of
// log2(e)-scaled scores, the probabilities are rounded to bf16 before PV and
// divided by their f32 row sum after it. The plain version
// (ops/cuda/window_attention.py: window_attention_reference) rounds at the
// same two places.
//
// C interface (loaded with ctypes): irp_window_attention returns the
// cudaError_t of the launch; it launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 8;
constexpr int kTokens = kWindow * kWindow;  // 64
constexpr int kSpan = 2 * kWindow - 1;      // 15: relative offsets per axis
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 32;
constexpr int kMaxHeads = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -100.0f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t lds_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// D = A * B + D, A 16x16 row-major bf16, B 16x8 col-major bf16, D 16x8 f32.
// With g = lane / 4 and c = lane % 4, A regs hold (row g | g+8, cols 2c, 2c+1
// | +8), B regs hold (k = 2c, 2c+1 | +8, n = g), the accumulator holds (row
// g | g+8, cols 2c, 2c+1): the accumulators of two neighbouring 8-key tiles
// are the A fragment of a 16-key step.
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The region of a row (or column) `pos` of the rolled image of `size` rows:
// the published mask's slices (0, -window), (-window, -shift), (-shift, end).
__device__ __forceinline__ int region(int pos, int size, int shift) {
  return pos < size - kWindow ? 0 : (pos < size - shift ? 1 : 2);
}

__global__ void __launch_bounds__(kThreads, 3)
    window_attention_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ table,
                            __nv_bfloat16* __restrict__ out, int heads, int head_dim, int grid_h,
                            int grid_w, int shift, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const __nv_bfloat16* sm = reinterpret_cast<const __nv_bfloat16*>(smem);
  const int channels = heads * head_dim;
  const int row = 3 * channels;  // a token's q | k | v, in elements
  const size_t window = blockIdx.x;

  // the window's 64 rows of q | k | v, 16 bytes a copy
  const unsigned char* src = reinterpret_cast<const unsigned char*>(qkv + window * kTokens * row);
  const int chunks = kTokens * row * 2 / 16;
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem + 16 * i)),
                 "l"(src + 16 * static_cast<size_t>(i))
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int in_image = static_cast<int>(window % static_cast<size_t>(grid_h * grid_w));
  const int y0 = (in_image / grid_w) * kWindow;  // the window's first row and column in the image
  const int x0 = (in_image % grid_w) * kWindow;
  const int image_h = grid_h * kWindow;
  const int image_w = grid_w * kWindow;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int units = heads * (kTokens / 16);
  for (int unit = warp; unit < units; unit += kWarps) {
    const int h = unit >> 2;
    const int r0 = (unit & 3) * 16;  // the unit's first query row; its rows are r0 + g and r0 + g + 8
    const __nv_bfloat16* qs = sm + h * head_dim;
    const __nv_bfloat16* ks = sm + channels + h * head_dim;
    const __nv_bfloat16* vs = sm + 2 * channels + h * head_dim;

    // S = Q K^T: 16 rows by 64 keys in eight 8-key tiles, D in two 16-wide steps
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxHeadDim / 16; ++kk) {
      const int d = 16 * kk + 2 * c;  // D is even, so d < D holds for d + 1 too
      const bool lo = d < head_dim, hi = d + 8 < head_dim;
      uint32_t a[4];
      a[0] = lo ? lds_u32(qs + (r0 + g) * row + d) : 0u;
      a[1] = lo ? lds_u32(qs + (r0 + g + 8) * row + d) : 0u;
      a[2] = hi ? lds_u32(qs + (r0 + g) * row + d + 8) : 0u;
      a[3] = hi ? lds_u32(qs + (r0 + g + 8) * row + d + 8) : 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kr = ks + (8 * j + g) * row;
        mma_bf16_16816(s[j], a, lo ? lds_u32(kr + d) : 0u, hi ? lds_u32(kr + d + 8) : 0u);
      }
    }

    // scale, bias and mask, in log2 units; query tokens (qy[i], g), key tokens (j, 2c + e)
    const int qy[2] = {r0 >> 3, (r0 >> 3) + 1};
    int q_region[2] = {0, 0};
    if (shift > 0) {
      const int rx = region(x0 + g, image_w, shift);
      q_region[0] = 3 * region(y0 + qy[0], image_h, shift) + rx;
      q_region[1] = 3 * region(y0 + qy[1], image_h, shift) + rx;
    }
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k_row_region = shift > 0 ? 3 * region(y0 + j, image_h, shift) : 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kx = 2 * c + e;
        const int k_region = shift > 0 ? k_row_region + region(x0 + kx, image_w, shift) : 0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rel = (qy[i] - j + kWindow - 1) * kSpan + (g - kx + kWindow - 1);
          float v = s[j][2 * i + e] * scale_log2 + __ldg(table + rel * heads + h) * kLog2e;
          if (k_region != q_region[i]) v += kMaskValue * kLog2e;
          s[j][2 * i + e] = v;
          m[i] = fmaxf(m[i], v);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[j][r] = exp2f(s[j][r] - m[r >> 1]);
        l[r >> 1] += s[j][r];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }

    // O = P V: keys in four 16-wide steps, D in four 8-wide tiles
    float o[4][4];
#pragma unroll
    for (int jd = 0; jd < 4; ++jd) o[jd][0] = o[jd][1] = o[jd][2] = o[jd][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = 16 * kk + 2 * c;
#pragma unroll
      for (int jd = 0; jd < 4; ++jd) {
        const int d = 8 * jd + g;
        uint32_t b0 = 0u, b1 = 0u;
        if (d < head_dim) {
          const __nv_bfloat16* vc = vs + d;
          b0 = pack_bf16(vc[key * row], vc[(key + 1) * row]);
          b1 = pack_bf16(vc[(key + 8) * row], vc[(key + 9) * row]);
        }
        mma_bf16_16816(o[jd], a, b0, b1);
      }
    }

    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    __nv_bfloat16* orow = out + window * kTokens * channels + h * head_dim;
#pragma unroll
    for (int jd = 0; jd < 4; ++jd) {
      const int d = 8 * jd + 2 * c;
      if (d < head_dim) {
        *reinterpret_cast<uint32_t*>(orow + (r0 + g) * channels + d) =
            pack_f32(o[jd][0] * inv[0], o[jd][1] * inv[0]);
        *reinterpret_cast<uint32_t*>(orow + (r0 + g + 8) * channels + d) =
            pack_f32(o[jd][2] * inv[1], o[jd][3] * inv[1]);
      }
    }
  }
}

}  // namespace

// windows: B * grid_h * grid_w, batch-major, each window's tokens row-major;
// shift: 0 (W-MSA) or the roll of the shifted layer (SW-MSA), < 8;
// scale: the scores' factor, D^-1/2.
extern "C" int irp_window_attention(const void* qkv, const void* table, void* out, int windows,
                                    int heads, int head_dim, int grid_h, int grid_w, int shift,
                                    float scale, void* stream) {
  if (heads < 1 || heads > kMaxHeads || head_dim < 2 || head_dim > kMaxHeadDim || head_dim % 2 != 0 ||
      windows < 1 || grid_h < 1 || grid_w < 1 || windows % (grid_h * grid_w) != 0 || shift < 0 ||
      shift >= kWindow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem_bytes = kTokens * 3 * heads * head_dim * 2;
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_kernel<<<windows, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(table),
      static_cast<__nv_bfloat16*>(out), heads, head_dim, grid_h, grid_w, shift, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
