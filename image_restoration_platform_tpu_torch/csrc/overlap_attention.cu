// Overlapping cross-window attention of HAT's OCAB (models/hat.py) for Hopper
// (sm_90a). qkv [windows, 256, 3 * C] bf16, the qkv linear's output in the
// window layout at shift 0 (window n = (b, wy, wx) of the image's 16 x 16
// windows, its 256 tokens row-major; per token the heads' q, then their k,
// then their v, each head D = C / heads wide); out [windows, 256, C] bf16, the
// heads side by side as the proj linear reads them. For each window and head:
//
//   softmax(Q K^T * scale + B[h]) V
//
// with Q the window's 256 queries, K and V the 576 tokens of the 24 x 24
// window around it (rows and columns -4 .. 19 of the window; a token past the
// image's border is a zero row, which takes part in the softmax with its
// bias), and B[h][i, j] = table[idx(i, j), h] from the [39^2, heads] f32
// table at the published calculate_rpi_oca index, (ky - qy - 7) * 39 +
// (kx - qx - 7) for query (qy, qx) and key (ky, kx) of the 24 x 24 window,
// wrapped into the table as PyTorch's indexing wraps a negative index.
//
// It replaces no TPU kernel: the JAX package has no transformer. It was added
// because nothing else computes this attention on the card: the flash kernel
// takes no bias and D of 32 or 64 only, and the window kernel's keys are its
// own window's; the published model cuts k and v with F.unfold, which would
// write 2 x 2.25 x 189 MB for each OCAB and chunk.
//
// What bounds it on an H100 SXM: both. A launch at HAT's chunk of 8 tiles of
// 256 (2,048 windows, C = 180 = 6 x 30) reads q, k and v once and writes o
// once, 755 MB, 0.225 ms at 3.35 TB/s, and its two products are 4 x 524,288
// x 576 x 180 = 217 GFLOP, 0.220 ms at 989 TFLOP/s: 288 operations a byte,
// on the ridge; its 1.8 G exponentials take 0.43 ms at the MUFU rate. What
// the design does about it:
//
// * one block a (window, head): the head's 576 key and value rows (60 bytes
//   each from a 4-byte aligned offset of a token's 3C-wide row) gathered from
//   the up to nine windows they lie in, with 4-byte cp.async, into rows of 40
//   bf16, zeros where the window passes the border and from D to 32; 92,160
//   bytes with the head's column of the table, scaled by log2(e) and laid
//   out by offset (6,084 bytes): two blocks an SM. A window's heads run side
//   by side, so the other heads, and the neighbouring windows, find the rows
//   in L2;
// * K's and V's mma fragments come from ldmatrix (V's transposed), one
//   instruction for four: the 80-byte rows put the 8 rows of each 8 x 8
//   matrix in 32 distinct banks;
// * a warp owns one row of the window (16 queries) at a time, two a warp; its
//   Q fragments come straight from device memory into registers (the queries
//   are read once), and it runs through the keys 64 at a time (one 24-key row
//   is three 8-key tiles) with the online softmax, as the window kernel does
//   at 16: f32 scores, bias added, running max and sum in f32, the
//   probabilities rounded to bf16 for PV and divided by the f32 sum at the
//   end;
// * no unfolded tensor and no mask: the zero rows are zeros in shared memory.
//
// Round-off: the probabilities are rounded to bf16 relative to the running
// max, so they may round differently from the plain version's
// (ops/cuda/overlap_attention.py: overlap_attention_reference) in the last
// bit; the bar of the card tests covers it.
//
// C interface (loaded with ctypes): irp_overlap_attention returns the
// cudaError_t of the launch; it launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 16;
constexpr int kTokens = kWindow * kWindow;  // 256 queries
constexpr int kOverlap = 24;
constexpr int kPad = (kOverlap - kWindow) / 2;  // 4
constexpr int kKeys = kOverlap * kOverlap;      // 576
constexpr int kSpan = kWindow + kOverlap - 1;   // 39: offsets per axis, and the published index's stride
constexpr int kRow = 40;                        // a head's key or value row in shared memory, in bf16
constexpr int kKeyStep = 64;                    // keys a warp scores at once
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 32;
constexpr int kMaxHeads = 8;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

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

// D = A * B + D, A 16x16 row-major bf16, B 16x8 col-major bf16, D 16x8 f32
// (the fragment layout of csrc/window_attention.cu).
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
    overlap_attention_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ table,
                             __nv_bfloat16* __restrict__ out, int heads, int head_dim, int grid_h, int grid_w,
                             float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [576, kRow] each
  __nv_bfloat16* vs = ks + kKeys * kRow;
  float* bias = reinterpret_cast<float*>(vs + kKeys * kRow);  // [39 * 39] by offset (dy + 15, dx + 15), times log2(e)
  const int channels = heads * head_dim;
  const int row = 3 * channels;
  const size_t window = blockIdx.x / heads;
  const int h = static_cast<int>(blockIdx.x - window * heads);
  const int per_image = grid_h * grid_w;
  const size_t image = window / per_image;
  const int in_image = static_cast<int>(window - image * per_image);
  const int wy = in_image / grid_w;
  const int wx = in_image - wy * grid_w;
  const int image_h = grid_h * kWindow;
  const int image_w = grid_w * kWindow;

  // the 24 x 24 window's key and value rows of the head, 4 bytes a copy, from
  // the windows they lie in; zeros past the border, and from D to 32
  const int words = head_dim / 2;
  for (int i = threadIdx.x; i < kKeys * 2 * 16; i += kThreads) {
    const int n = i >> 5;
    const int part = (i >> 4) & 1;  // 0: k, 1: v
    const int w = i & 15;
    const int y = wy * kWindow - kPad + n / kOverlap;
    const int x = wx * kWindow - kPad + n % kOverlap;
    __nv_bfloat16* dst = ks + (part * kKeys + n) * kRow + 2 * w;
    if (w >= words || y < 0 || y >= image_h || x < 0 || x >= image_w) {
      *reinterpret_cast<uint32_t*>(dst) = 0u;
    } else {
      const size_t src_row = ((image * grid_h + y / kWindow) * grid_w + x / kWindow) * kTokens +
                             (y % kWindow) * kWindow + x % kWindow;
      cp_async4(dst, qkv + src_row * row + (part + 1) * channels + h * head_dim + 2 * w);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // bias[(a, b)] for the key's offset from the query (a - 15, b - 15) rows and
  // columns of the 24 x 24 window against the 16 x 16: the published index
  // (a - 22) * 39 + (b - 22), wrapped as a negative index wraps
  for (int i = threadIdx.x; i < kSpan * kSpan; i += kThreads) {
    int idx = (i / kSpan - 22) * kSpan + (i % kSpan - 22);
    if (idx < 0) idx += kSpan * kSpan;
    bias[i] = __ldg(table + idx * heads + h) * kLog2e;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int qy = warp; qy < kWindow; qy += kWarps) {
    // the unit: window row qy, query tokens (qy, g) in accumulator rows g and (qy, g + 8) in rows g + 8
    const __nv_bfloat16* qr = qkv + (window * kTokens + qy * kWindow) * row + h * head_dim;
    uint32_t aq[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int d = 16 * kk + 2 * c;
      const bool lo = d < head_dim, hi = d + 8 < head_dim;
      aq[kk][0] = lo ? __ldg(reinterpret_cast<const unsigned int*>(qr + g * row + d)) : 0u;
      aq[kk][1] = lo ? __ldg(reinterpret_cast<const unsigned int*>(qr + (g + 8) * row + d)) : 0u;
      aq[kk][2] = hi ? __ldg(reinterpret_cast<const unsigned int*>(qr + g * row + d + 8)) : 0u;
      aq[kk][3] = hi ? __ldg(reinterpret_cast<const unsigned int*>(qr + (g + 8) * row + d + 8)) : 0u;
    }
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float o[4][4];
#pragma unroll
    for (int jd = 0; jd < 4; ++jd) o[jd][0] = o[jd][1] = o[jd][2] = o[jd][3] = 0.f;

    for (int k0 = 0; k0 < kKeys; k0 += kKeyStep) {
      // S = Q K^T over keys k0 .. k0 + 63: tile j is keys k0 + 8j .. + 7, a third of key row (k0 + 8j) / 24
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t kb[4];  // d 0-7, 8-15, 16-23, 24-31 of the tile's 8 keys
        ldmatrix_x4(kb, ks + (k0 + 8 * j + (lane & 7)) * kRow + 8 * (lane >> 3));
        mma_bf16_16816(s[j], aq[0], kb[0], kb[1]);
        mma_bf16_16816(s[j], aq[1], kb[2], kb[3]);
      }
      // scale and bias, in log2 units; query tokens (qy, g + 8i), key tokens (ky, kx)
      float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int tile = (k0 >> 3) + j;
        const int ky = tile / 3;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kx = 8 * (tile - 3 * ky) + 2 * c + e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float v = s[j][2 * i + e] * scale_log2 + bias[(ky - qy + 15) * kSpan + (kx - g - 8 * i + 15)];
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
        const __nv_bfloat16* vr = vs + (k0 + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kRow + 8 * (lane >> 4);
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
    __nv_bfloat16* orow = out + (window * kTokens + qy * kWindow) * channels + h * head_dim;
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

// windows: B * grid_h * grid_w, batch-major, each window's 256 tokens
// row-major; scale: the scores' factor, D^-1/2.
extern "C" int irp_overlap_attention(const void* qkv, const void* table, void* out, int windows, int heads,
                                     int head_dim, int grid_h, int grid_w, float scale, void* stream) {
  if (heads < 1 || heads > kMaxHeads || head_dim < 2 || head_dim > kMaxHeadDim || head_dim % 2 != 0 ||
      windows < 1 || grid_h < 1 || grid_w < 1 || windows % (grid_h * grid_w) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem_bytes = 2 * kKeys * kRow * 2 + kSpan * kSpan * 4;
  cudaError_t err =
      cudaFuncSetAttribute(overlap_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  overlap_attention_kernel<<<windows * heads, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(table), static_cast<__nv_bfloat16*>(out),
      heads, head_dim, grid_h, grid_w, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
