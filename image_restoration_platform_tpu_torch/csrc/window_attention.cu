// Shifted-window multi-head self-attention of the Swin transformer (SwinIR's
// W-MSA and SW-MSA on windows of 8, HAT's HABs on windows of 16) for Hopper
// (sm_90a). qkv [windows, T, 3 * C] bf16 (T = 64 or 256), the qkv linear's
// output as it stands (per token: the heads' q, then their k, then their v,
// each head D = C / heads wide); out [windows, T, C] bf16, the heads side by
// side as the proj linear reads them. For each window and head:
//
//   softmax(Q K^T * scale + B[h] + M) V
//
// with the relative-position bias B[h][i, j] = table[rel(i, j), h] read from
// the [(2 * w - 1)^2, heads] f32 table, and on shifted layers M[i, j] = -100
// where tokens i and j lie in different regions of the rolled image (the
// published SW-MSA mask), 0 elsewhere. Windows of 8 take the first kernel
// below (window_attention_kernel), windows of 16 the second
// (window_attention_kernel_w16, after it).
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
// Windows of 16 (HAT): a window's q | k | v is 256 x 3C x 2 = 276,480 bytes
// at C = 180, more than an SM's shared memory, and the scores of a head are
// 256 x 256, four times a window of 8's. A launch moves the same bytes as at
// 8 (755 MB at HAT's chunk of 8 tiles: 2,048 windows of 256 tokens), 0.225
// ms at the memory rate, with 4 x the products (128 operations a byte) and 4 x
// the exponentials (805 M; 0.19 ms at the MUFU rate). What the design does:
//
// * one block a (window, head): the head's 256 rows of q, k and v (D = 30
//   of each 3C-wide row, 60 bytes from a 4-byte aligned offset) copied with
//   4-byte cp.async into rows of 40 bf16, zeros from D to 32, 61,440 bytes,
//   beside the head's column of the [961, heads] table scaled by log2(e)
//   (3,844 bytes): two blocks an SM, and a window's other heads read the
//   rest of its rows from L2;
// * K's and V's mma fragments come from ldmatrix (V's transposed), one
//   instruction for four: the 80-byte rows put the 8 rows of each 8 x 8
//   matrix in 32 distinct banks;
// * a warp owns one row of the window (16 query tokens) at a time, two rows
//   a warp, and runs through the keys 64 at a time with the online softmax
//   (running max and sum in f32; the accumulators rescaled when the max
//   moves), so a warp holds 16 x 64 scores, as at 8, never 16 x 256;
// * bias and mask as at 8: the bias from shared memory, the mask worked out
//   from the tokens' regions.
//
// Round-off at 16: the probabilities are rounded to bf16 relative to the
// running max, not the row's final max, so they may round differently from
// the plain version's in the last bit; the bar of the card tests covers it.
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

// ---------------------------------------------------------- windows of 16

constexpr int kWindow16 = 16;
constexpr int kTokens16 = kWindow16 * kWindow16;  // 256
constexpr int kSpan16 = 2 * kWindow16 - 1;        // 31
constexpr int kRow16 = 40;                        // a head's row of q, k or v in shared memory, in bf16
constexpr int kKeyStep = 64;                      // keys a warp scores at once

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// Four 8 x 8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; r[i] holds (row g, columns 2c, 2c + 1) of matrix
// i, or with .trans (rows 2c, 2c + 1, column g): the mma's B fragments of K
// (rows: keys, 8 d each) and of V (rows: keys, transposed).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ int region16(int pos, int size, int shift) {
  return pos < size - kWindow16 ? 0 : (pos < size - shift ? 1 : 2);
}

__global__ void __launch_bounds__(kThreads, 2)
    window_attention_kernel_w16(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ table,
                                __nv_bfloat16* __restrict__ out, int heads, int head_dim, int grid_h,
                                int grid_w, int shift, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [256, kRow16] each
  __nv_bfloat16* ks = qs + kTokens16 * kRow16;
  __nv_bfloat16* vs = ks + kTokens16 * kRow16;
  float* bias = reinterpret_cast<float*>(vs + kTokens16 * kRow16);  // [31 * 31], times log2(e)
  const int channels = heads * head_dim;
  const int row = 3 * channels;
  const size_t window = blockIdx.x / heads;
  const int h = static_cast<int>(blockIdx.x - window * heads);

  // the head's 256 rows of q, k and v, 4 bytes a copy, zeros from D to 32
  const __nv_bfloat16* src = qkv + window * kTokens16 * row + h * head_dim;
  const int words = head_dim / 2;
  for (int i = threadIdx.x; i < kTokens16 * 3 * 16; i += kThreads) {
    const int t = i / 48;
    const int r = i - t * 48;
    const int part = r >> 4;  // 0: q, 1: k, 2: v
    const int w = r & 15;
    __nv_bfloat16* dst = qs + (part * kTokens16 + t) * kRow16 + 2 * w;
    if (w < words) {
      cp_async4(dst, src + static_cast<size_t>(t) * row + part * channels + 2 * w);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = 0u;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < kSpan16 * kSpan16; i += kThreads) bias[i] = __ldg(table + i * heads + h) * kLog2e;

  const int in_image = static_cast<int>(window % static_cast<size_t>(grid_h * grid_w));
  const int y0 = (in_image / grid_w) * kWindow16;
  const int x0 = (in_image % grid_w) * kWindow16;
  const int image_h = grid_h * kWindow16;
  const int image_w = grid_w * kWindow16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int qy = warp; qy < kWindow16; qy += kWarps) {
    // the unit: window row qy, query tokens (qy, g) in accumulator rows g and (qy, g + 8) in rows g + 8
    const __nv_bfloat16* qr = qs + qy * kWindow16 * kRow16;
    uint32_t aq[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int d = 16 * kk + 2 * c;
      aq[kk][0] = lds_u32(qr + g * kRow16 + d);
      aq[kk][1] = lds_u32(qr + (g + 8) * kRow16 + d);
      aq[kk][2] = lds_u32(qr + g * kRow16 + d + 8);
      aq[kk][3] = lds_u32(qr + (g + 8) * kRow16 + d + 8);
    }
    int q_region[2] = {0, 0};
    if (shift > 0) {
      const int ry = 3 * region16(y0 + qy, image_h, shift);
      q_region[0] = ry + region16(x0 + g, image_w, shift);
      q_region[1] = ry + region16(x0 + g + 8, image_w, shift);
    }
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float o[4][4];
#pragma unroll
    for (int jd = 0; jd < 4; ++jd) o[jd][0] = o[jd][1] = o[jd][2] = o[jd][3] = 0.f;

    for (int k0 = 0; k0 < kTokens16; k0 += kKeyStep) {
      // S = Q K^T over keys k0 .. k0 + 63, eight 8-key tiles: tile j holds key row (k0 + 8j) / 16
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t kb[4];  // d 0-7, 8-15, 16-23, 24-31 of the tile's 8 keys
        ldmatrix_x4(kb, ks + (k0 + 8 * j + (lane & 7)) * kRow16 + 8 * (lane >> 3));
        mma_bf16_16816(s[j], aq[0], kb[0], kb[1]);
        mma_bf16_16816(s[j], aq[1], kb[2], kb[3]);
      }
      // scale, bias and mask, in log2 units; query tokens (qy, g + 8i), key tokens (ky, kx)
      float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ky = (k0 >> 4) + (j >> 1);
        const int k_row_region = shift > 0 ? 3 * region16(y0 + ky, image_h, shift) : 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kx = 8 * (j & 1) + 2 * c + e;
          const int k_region = shift > 0 ? k_row_region + region16(x0 + kx, image_w, shift) : 0;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int rel = (qy - ky + kWindow16 - 1) * kSpan16 + (g + 8 * i - kx + kWindow16 - 1);
            float v = s[j][2 * i + e] * scale_log2 + bias[rel];
            if (k_region != q_region[i]) v += kMaskValue * kLog2e;
            s[j][2 * i + e] = v;
            mc[i] = fmaxf(mc[i], v);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
        mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
        const float m_new = fmaxf(m[i], mc[i]);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int jd = 0; jd < 4; ++jd) {
        o[jd][0] *= alpha[0];
        o[jd][1] *= alpha[0];
        o[jd][2] *= alpha[1];
        o[jd][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[j][r] = exp2f(s[j][r] - m[r >> 1]);
          l[r >> 1] += s[j][r];
        }
      }
      // O += P V: these 64 keys in four 16-wide steps, D in four 8-wide tiles
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        // keys 0-7 and 8-15 of the step for d 0-7 and 8-15, then for d 16-23 and 24-31
        const __nv_bfloat16* vr = vs + (k0 + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kRow16 + 8 * (lane >> 4);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vr + 16 * p);
          mma_bf16_16816(o[2 * p], a, vb[0], vb[1]);
          mma_bf16_16816(o[2 * p + 1], a, vb[2], vb[3]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    __nv_bfloat16* orow = out + (window * kTokens16 + qy * kWindow16) * channels + h * head_dim;
#pragma unroll
    for (int jd = 0; jd < 4; ++jd) {
      const int d = 8 * jd + 2 * c;
      if (d < head_dim) {
        *reinterpret_cast<uint32_t*>(orow + g * channels + d) = pack_f32(o[jd][0] * inv[0], o[jd][1] * inv[0]);
        *reinterpret_cast<uint32_t*>(orow + (g + 8) * channels + d) = pack_f32(o[jd][2] * inv[1], o[jd][3] * inv[1]);
      }
    }
  }
}

}  // namespace

// windows: B * grid_h * grid_w, batch-major, each window's tokens row-major;
// window: 8 or 16; shift: 0 (W-MSA) or the roll of the shifted layer
// (SW-MSA), below the window; scale: the scores' factor, D^-1/2.
extern "C" int irp_window_attention(const void* qkv, const void* table, void* out, int windows, int window,
                                    int heads, int head_dim, int grid_h, int grid_w, int shift,
                                    float scale, void* stream) {
  if (heads < 1 || heads > kMaxHeads || head_dim < 2 || head_dim > kMaxHeadDim || head_dim % 2 != 0 ||
      windows < 1 || grid_h < 1 || grid_w < 1 || windows % (grid_h * grid_w) != 0 || shift < 0 ||
      (window != kWindow && window != kWindow16) || shift >= window) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (window == kWindow16) {
    const int smem16 = 3 * kTokens16 * kRow16 * 2 + kSpan16 * kSpan16 * 4;
    cudaError_t err = cudaFuncSetAttribute(window_attention_kernel_w16,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem16);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_kernel_w16<<<windows * heads, kThreads, smem16, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(table),
        static_cast<__nv_bfloat16*>(out), heads, head_dim, grid_h, grid_w, shift, scale * kLog2e);
    return static_cast<int>(cudaGetLastError());
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
