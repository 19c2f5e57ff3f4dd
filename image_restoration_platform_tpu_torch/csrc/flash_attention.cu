// Bottleneck self-attention forward for Hopper (sm_90a): exact non-causal
// softmax(Q K^T / sqrt(D)) V per (batch * head), flash-2 style.
//
// Replaces the TPU kernel image_restoration_platform_tpu/ops/pallas/attention.py
// (_attn_kernel, launched by _attention_nh through pl.pallas_call). That kernel
// keeps the whole K/V of one head resident in VMEM (1 MB per head in bf16 at
// T = 4096), which does not fit in the 227 KB of shared memory a Hopper block
// may use. Here one block owns one (batch*head, 64-query) tile and streams K/V
// through shared memory in 64-token tiles, keeping a running row max and row
// sum in f32 registers (online softmax). The 1/rowsum divide happens once, on
// the [64, D] output, as the TPU kernel's LATE_DIV does; the unnormalised
// probabilities are rounded to the input type before the P V product.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the
// 512 bucket, batch 8, [32, 4096, 64] bf16 it does 4 * 32 * 4096^2 * 64 =
// 137 GFLOP (0.14 ms at peak) and must move 4 * 32 * 4096 * 64 * 2 B = 67 MB of
// q/k/v/o (0.02 ms), so it is compute-bound; at the 256 bucket, batch 1
// ([4, 1024, 64], 1.1 GFLOP) it is bound by the launch itself. The design
// answers the compute bound only partly: the products run on the tensor cores
// through mma.sync m16n8k16 (bf16 in, f32 accumulate), logits never leave
// registers, and K/V are read from L2 once per query tile. wgmma, TMA and warp
// specialisation, which the full rate needs, are later work.
//
// float32 inputs take a plain SIMT path (one thread per query row, f32 FMA),
// so an f32 engine gets f32 attention rather than TF32.
//
// C interface (loaded with ctypes): irp_flash_attention_fwd returns the
// cudaError_t of the launch; it launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // queries per block
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kWarps = kBlockQ / 16;  // one warp per 16 query rows

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A * B + D, A 16x16 row-major bf16, B 16x8 col-major bf16, D 16x8 f32.
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two transposed 8x8 b16 matrices from shared memory: lanes 0-7 address the
// rows of the first, lanes 8-15 those of the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// bf16: 4 warps, each owns 16 query rows of the block's 64.
//
// Fragment layouts (PTX ISA, mma.m16n8k16): with g = lane / 4 and c = lane % 4,
// A regs hold (row g | g+8, cols 2c, 2c+1 | +8), B regs hold (k = 2c, 2c+1 | +8,
// n = g), and the f32 accumulator holds (row g | g+8, cols 2c, 2c+1). The
// accumulator of two neighbouring 8-key tiles is therefore exactly the A
// fragment of a 16-key step, which is how P goes from the first product into
// the second without touching shared memory.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int t,
                   float scale_log2) {
  constexpr int kLd = D + 8;  // padded row stride: conflict-free fragment loads
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * kLd];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const size_t head = static_cast<size_t>(blockIdx.y) * t * D;
  const int row0 = blockIdx.x * kBlockQ + warp * 16;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + 2 * c;
    qa[kk][0] = load_u32(qh + static_cast<size_t>(row0 + g) * D + col);
    qa[kk][1] = load_u32(qh + static_cast<size_t>(row0 + g + 8) * D + col);
    qa[kk][2] = load_u32(qh + static_cast<size_t>(row0 + g) * D + col + 8);
    qa[kk][3] = load_u32(qh + static_cast<size_t>(row0 + g + 8) * D + col + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max (log2 units), rows g, g+8
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of the row sums

  constexpr int kChunks = kBlockK * D / 8;  // 16-byte chunks per tile
  for (int kt = 0; kt < t; kt += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kChunks; i += kWarps * 32) {
      const int r = i / (D / 8);
      const int cc = (i % (D / 8)) * 8;
      const size_t src = static_cast<size_t>(kt + r) * D + cc;
      *reinterpret_cast<uint4*>(&ks[r * kLd + cc]) = *reinterpret_cast<const uint4*>(kh + src);
      *reinterpret_cast<uint4*>(&vs[r * kLd + cc]) = *reinterpret_cast<const uint4*>(vh + src);
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys, f32 in registers
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[(nt * 8 + g) * kLd + kk * 16 + 2 * c];
        mma_bf16_16816(s[nt], qa[kk], load_u32(kr), load_u32(kr + 8));
      }
    }

    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] *= scale_log2;
      s[nt][1] *= scale_log2;
      s[nt][2] *= scale_log2;
      s[nt][3] *= scale_log2;
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
    // the four lanes of a quad share a row
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float alpha_lo = exp2f(m_lo - mx_lo);  // 0 on the first tile
    const float alpha_hi = exp2f(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;

    uint32_t pa[kBlockK / 16][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - mx_lo);
      const float p1 = exp2f(s[nt][1] - mx_lo);
      const float p2 = exp2f(s[nt][2] - mx_hi);
      const float p3 = exp2f(s[nt][3] - mx_hi);
      sum_lo += p0 + p1;  // the sum uses the unrounded f32 probabilities
      sum_hi += p2 + p3;
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16x2(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha_lo;
      acc[dt][1] *= alpha_lo;
      acc[dt][2] *= alpha_hi;
      acc[dt][3] *= alpha_hi;
    }

    // O += P V; V^T fragments come straight from the row-major tile
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &vs[(kk * 16 + (lane & 15)) * kLd + dt * 8]);
        mma_bf16_16816(acc[dt], pa[kk], b0, b1);
      }
    }
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);

  __nv_bfloat16* oh = o + head;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(oh + static_cast<size_t>(row0 + g) * D + col) =
        pack_bf16x2(acc[dt][0] / l_lo, acc[dt][1] / l_lo);
    *reinterpret_cast<uint32_t*>(oh + static_cast<size_t>(row0 + g + 8) * D + col) =
        pack_bf16x2(acc[dt][2] / l_hi, acc[dt][3] / l_hi);
  }
}

// float32: one thread per query row; K/V tiles in shared memory are read by
// every thread of the block at the same address (broadcast).
template <int D>
__global__ void __launch_bounds__(kBlockQ)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int t, float scale) {
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];

  const size_t head = static_cast<size_t>(blockIdx.y) * t * D;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const float* qr = q + head + static_cast<size_t>(row) * D;

  float qv[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qv[d] = qr[d];
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  constexpr int kChunks = kBlockK * D / 4;
  for (int kt = 0; kt < t; kt += kBlockK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunks; i += kBlockQ) {
      const int r = i / (D / 4);
      const int cc = (i % (D / 4)) * 4;
      const size_t src = head + static_cast<size_t>(kt + r) * D + cc;
      *reinterpret_cast<float4*>(&ks[r][cc]) = *reinterpret_cast<const float4*>(k + src);
      *reinterpret_cast<float4*>(&vs[r][cc]) = *reinterpret_cast<const float4*>(v + src);
    }
    __syncthreads();
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qv[d], ks[j][d], dot);
      const float s = dot * scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d] * alpha);
      m = m_new;
    }
  }

  float* orow = o + head + static_cast<size_t>(row) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = acc[d] / l;
}

}  // namespace

extern "C" int irp_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int nh, int t, int d, int is_bf16, float scale,
                                       void* stream) {
  if (nh <= 0 || t <= 0 || t % kBlockQ != 0 || nh > 65535) return cudaErrorInvalidValue;
  const dim3 grid(t / kBlockQ, nh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(o);
    if (d == 64) {
      flash_fwd_bf16<64><<<grid, kWarps * 32, 0, s>>>(qb, kb, vb, ob, t, scale_log2);
    } else if (d == 32) {
      flash_fwd_bf16<32><<<grid, kWarps * 32, 0, s>>>(qb, kb, vb, ob, t, scale_log2);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(o);
    if (d == 64) {
      flash_fwd_f32<64><<<grid, kBlockQ, 0, s>>>(qf, kf, vf, of, t, scale);
    } else if (d == 32) {
      flash_fwd_f32<32><<<grid, kBlockQ, 0, s>>>(qf, kf, vf, of, t, scale);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
