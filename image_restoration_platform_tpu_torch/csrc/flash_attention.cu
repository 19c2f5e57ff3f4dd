// Bottleneck self-attention forward for Hopper (sm_90a): exact non-causal
// softmax(Q K^T / sqrt(D)) V per (batch * head), with an online softmax.
//
// Replaces the TPU kernel image_restoration_platform_tpu/ops/pallas/attention.py
// (_attn_kernel, launched by _attention_nh through pl.pallas_call). That kernel
// keeps the whole K/V of one head resident in VMEM (1 MB per head in bf16 at
// T = 4096), which does not fit in the 227 KB of shared memory a Hopper block
// may use, so every variant here streams K/V through shared memory in tiles and
// keeps a running row max and row sum in f32 registers. The TPU kernel's
// numerics are kept: f32 logits, the row sum taken over the unrounded f32
// probabilities, probabilities rounded to the input type before P V, f32
// accumulation, one late divide on the [rows, D] output (its LATE_DIV).
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at
// [32, 4096, 64] bf16 it does 4 * 32 * 4096^2 * 64 = 137 GFLOP (0.139 ms at
// peak) and must move 67 MB of q/k/v/o (0.02 ms): operations. A second limit
// sits beside the first: 32 * 4096^2 = 537 M exponentials at 16 per clock per
// SM take about as long again (~0.13 ms), and so do the ~4.5 instructions per
// logit of the softmax (max, scale, sum, round) at one a clock per scheduler.
// The three have to overlap. At D = 32 the exponentials are the larger limit
// (each logit costs one ex2 and only 32 multiply-adds a product). At
// [4, 1024, 64] (1.1 GFLOP) it is bound by the launch, by how many SMs the
// grid reaches and by the serial rounds of one block.
//
// Variants (the wrapper, ops/cuda/attention.py launch_plan, picks one per call):
//
// * wgmma (bf16, D = 32 or 64, T a multiple of 128). Warp-specialised. One
//   producer warp keeps TMA loads of 128-key K and V tiles in flight through a
//   ring of up to 4 stages in dynamic shared memory (a row of D bf16 is one
//   swizzle row: the 128-byte swizzle at D = 64, the 64-byte one at D = 32),
//   with full/empty mbarriers per stage, K and V apart so that S can start
//   before V has landed. One or three consumer warpgroups own 64 query rows
//   each. S = Q K^T is wgmma m64n128k16 (D / 16 steps) with both operands in
//   shared memory (K as it lies, K-major); the f32 accumulator of S, rounded to
//   bf16, is the A fragment of O += P V (m64nDk16, A from registers), whose B
//   is the V tile as it lies, read MN-major through the descriptor, so nothing
//   is transposed or copied. Schedule per warpgroup: S of tile j and P V of
//   tile j-1 are issued together, then the softmax of tile j. The three
//   warpgroups of a block issue in turn (named barriers), so one runs its
//   exponentials while another's products are in the tensor cores; three, not
//   two, because with 12 consumer warps each scheduler has three instruction
//   streams to fill its issue slots from. They get 160 registers each (64 S +
//   32 O + 32 P), the producer gives its own up (setmaxnreg 24 / 160).
//   A launch is a list of (head, query block) units, 192 rows (the last of a
//   head may reach past T and stores only its own rows), 128 rows (the third
//   warpgroup leaves at once; the wrapper gives the last heads such blocks so
//   that the last wave is short) or 64. Three schedules walk it:
//   - one block a unit (the grid);
//   - persistent: at most one block an SM, each walking the units round-robin
//     (no counter: nothing to reset inside a CUDA graph, the order fixed); the
//     producer loads the next unit's Q into a second buffer and its first K/V
//     tiles while the consumers finish the current unit, so the prologue is
//     paid once an SM and the tail is one unit long;
//   - a key split where the units are fewer than the SMs: a cluster of 2 or 4
//     blocks a unit, each on its share of the keys with its own running max;
//     blocks 1.. write their unnormalised f32 O, max and row sums into block
//     0's shared memory (distributed shared memory, one mbarrier), and block 0
//     rescales them to the common max, adds them in split order (no float
//     atomics, the same bits every run, one launch) and does the late divide.
//   Measured on an H100 SXM at 700 W: 0.267 ms at [32, 4096, 64] (the mma.sync
//   kernel before it: 0.666 ms), 0.43 ms at [64, 4096, 32] (mma.sync: 0.80 ms;
//   the exponentials' limit there is 0.26 ms). History, method and the times
//   of every plan at the launched shapes: PERF.md section 6.
// * mma.sync (bf16, D = 32 or 64 with T a multiple of 64 but not of 128): the
//   first port's kernel, 4 warps on 64 queries, 64-key tiles, m16n8k16. No
//   served path launches it.
// * SIMT f32 (f32 inputs, so an f32 engine gets f32 attention, no TF32): 128
//   threads on 32 queries, each thread a 4 x 4 register tile of S, 64-key K/V
//   tiles double-buffered with cp.async, P handed to the second product through
//   shared memory inside a half-warp. Measured: 0.0507 ms at [4, 1024, 64],
//   32 % of the f32 bound (67 TFLOP/s outside the tensor cores).
//
// C interface (loaded with ctypes): irp_flash_attention_fwd returns 0, the
// cudaError_t of the launch, or 10000 + the CUresult of a failed tensor-map
// encode; it launches on the given stream, does not synchronise and allocates
// nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------- wgmma variant (bf16, D = 32 | 64)

constexpr int kWgRows = 64;        // query rows per consumer warpgroup
constexpr int kTileKeys = 128;     // keys per K/V stage
constexpr int kMaxStages = 4;
constexpr int kMaxSplits = 4;      // blocks of a cluster that share out the keys
constexpr int kSmemAlign = 1024;   // the 128-byte swizzle pattern repeats every 8 rows

// The tiles of one head dimension. A row of D bf16 is one swizzle row: 128
// bytes at D = 64 (128-byte swizzle), 64 bytes at D = 32 (64-byte swizzle);
// 8-row core-matrix groups lie 8 rows apart either way.
template <int D>
struct Tiles {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  static constexpr int kRowBytes = D * 2;
  static constexpr int kGroupBytes = 8 * kRowBytes;         // 1024 or 512
  static constexpr int kQBytes = kWgRows * kRowBytes;       // per warpgroup: 8 or 4 KB
  static constexpr int kTileBytes = kTileKeys * kRowBytes;  // 16 or 8 KB
  static constexpr uint64_t kSwizzleMode = D == 64 ? 1 : 2;  // the descriptor's code: 128 B, 64 B
  static constexpr int kAccRegs = D / 2;                    // f32 registers of O per thread
  // what a split hands to the cluster's first block, per consumer thread:
  // its O accumulator, the running max and its share of the row sums (rows g, g+8)
  static constexpr int kCombineFloats = kAccRegs + 4;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier has left the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The same, acquiring at cluster scope what other blocks of the cluster
// released when they arrived.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- thread-block clusters: the blocks of one unit's key split
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of the same shared-memory byte in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void mbar_arrive_cluster(uint32_t remote_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote_bar)
               : "memory");
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Where a tile lies in the ring: tile j is in stage j % stages, and its
// barriers are in the phase of parity (j / stages) & 1. Kept by counting, so
// that the loops divide by nothing.
struct RingSlot {
  int stage = 0;
  uint32_t parity = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      parity ^= 1;
    }
  }
};

// One [rows, D] bf16 box at (column 0, row) of a 2-D tensor map into shared memory.
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row)
      : "memory");
}

// Shared-memory matrix descriptor of a tile whose rows are one swizzle row
// (128 bytes at D = 64, 64 at D = 32) and swizzled by that width: 8-row groups
// lie kGroupBytes apart (the stride offset). The leading offset is not read
// when the tile is one swizzle row wide; it is set to the same value.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>(Tiles<D>::kGroupBytes >> 4) << 16;
  d |= static_cast<uint64_t>(Tiles<D>::kGroupBytes >> 4) << 32;
  d |= Tiles<D>::kSwizzleMode << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties a register to a point in the instruction stream: the compiler may not
// move its uses across (wgmma reads and writes registers asynchronously).
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, A and B in shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B in shared memory
// with its N dimension contiguous (MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], the same at D = 32.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S = Q K^T over D: D / 16 k-steps of 16, each 32 bytes further along the
// swizzled row (2 in the descriptor's 16-byte units).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t desc_q, uint64_t desc_k) {
#pragma unroll
  for (int i = 0; i < 64; ++i) reg_fence(s[i]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_m64n128k16_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
  }
  wgmma_commit();
}

// O += P V over 128 keys: eight k-steps of 16 keys, each 16 rows (16 * 2D
// bytes, 2D in the descriptor's units) further down the V tile.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], uint32_t (&p)[8][4], uint64_t desc_v) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) reg_fence(o[i]);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) reg_fence(p[kk][i]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTileKeys / 16; ++kk) {
    if constexpr (D == 64) {
      wgmma_m64n64k16_rs(o, p[kk], desc_v + 2 * D * kk);
    } else {
      wgmma_m64n32k16_rs(o, p[kk], desc_v + 2 * D * kk);
    }
  }
  wgmma_commit();
}

// Online softmax of one 64 x 128 tile of raw logits, in base 2: on return s
// holds p = 2^((s - m) * scale * log2 e) in f32, m the new running max of the
// raw logits (rows g and g + 8 of the warp's 16), l this thread's share of the
// row sums over the unrounded p, and alpha what the old accumulator is worth
// under the new max (0 on the first tile, where m comes in as -inf).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float& m_lo, float& m_hi, float& l_lo,
                                             float& l_hi, float& alpha_lo, float& alpha_hi,
                                             float scale_log2) {
  // Four partial maxima and sums per row: a scheduler has one to three
  // consumer warps, and one chain of 32 dependent operations would leave it
  // idle. The first four chunks start the partials, so that nothing is added
  // to a zero or compared with -inf.
  float pm_lo[4], pm_hi[4];
#pragma unroll
  for (int jn = 0; jn < 16; ++jn) {
    if (jn < 4) {
      pm_lo[jn] = fmaxf(s[4 * jn], s[4 * jn + 1]);
      pm_hi[jn] = fmaxf(s[4 * jn + 2], s[4 * jn + 3]);
    } else {
      pm_lo[jn & 3] = fmaxf(pm_lo[jn & 3], fmaxf(s[4 * jn], s[4 * jn + 1]));
      pm_hi[jn & 3] = fmaxf(pm_hi[jn & 3], fmaxf(s[4 * jn + 2], s[4 * jn + 3]));
    }
  }
  pm_lo[0] = fmaxf(pm_lo[0], m_lo);
  pm_hi[0] = fmaxf(pm_hi[0], m_hi);
  float mx_lo = fmaxf(fmaxf(pm_lo[0], pm_lo[1]), fmaxf(pm_lo[2], pm_lo[3]));
  float mx_hi = fmaxf(fmaxf(pm_hi[0], pm_hi[1]), fmaxf(pm_hi[2], pm_hi[3]));
  // the four lanes of a quad share a row
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  alpha_lo = fast_exp2((m_lo - mx_lo) * scale_log2);
  alpha_hi = fast_exp2((m_hi - mx_hi) * scale_log2);
  m_lo = mx_lo;
  m_hi = mx_hi;
  const float off_lo = -mx_lo * scale_log2;
  const float off_hi = -mx_hi * scale_log2;
  float ps_lo[4], ps_hi[4];
#pragma unroll
  for (int jn = 0; jn < 16; ++jn) {
    s[4 * jn] = fast_exp2(fmaf(s[4 * jn], scale_log2, off_lo));
    s[4 * jn + 1] = fast_exp2(fmaf(s[4 * jn + 1], scale_log2, off_lo));
    s[4 * jn + 2] = fast_exp2(fmaf(s[4 * jn + 2], scale_log2, off_hi));
    s[4 * jn + 3] = fast_exp2(fmaf(s[4 * jn + 3], scale_log2, off_hi));
    if (jn < 4) {
      ps_lo[jn] = s[4 * jn] + s[4 * jn + 1];
      ps_hi[jn] = s[4 * jn + 2] + s[4 * jn + 3];
    } else {
      ps_lo[jn & 3] += s[4 * jn] + s[4 * jn + 1];  // the sums use the unrounded f32 probabilities
      ps_hi[jn & 3] += s[4 * jn + 2] + s[4 * jn + 3];
    }
  }
  const float sum_lo = (ps_lo[0] + ps_lo[1]) + (ps_lo[2] + ps_lo[3]);
  const float sum_hi = (ps_hi[0] + ps_hi[1]) + (ps_hi[2] + ps_hi[3]);
  l_lo = l_lo * alpha_lo + sum_lo;
  l_hi = l_hi * alpha_hi + sum_hi;
}

// The f32 accumulator layout of S, rounded to bf16, as the A fragments of P V.
__device__ __forceinline__ void pack_probabilities(uint32_t (&p)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    p[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// n / d for 0 <= n < 2^31 by a multiply-high and a shift, with d's multiplier
// ceil(2^(31 + l) / d), l = ceil(log2 d), worked out on the host: a block
// decodes its first unit ahead of its first load, and a division by a value
// known only at run time is a few dozen instructions there.
struct FastDiv {
  int d;
  uint32_t mul, shr;
  explicit FastDiv(int d_) : d(d_), mul(0), shr(0) {
    if (d > 1) {
      uint32_t l = 0;
      while ((1u << l) < static_cast<uint32_t>(d)) ++l;
      mul = static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d);
      shr = l - 1;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), mul) >> shr);
  }
};

// The query blocks of a launch, as one list of units in the order the blocks
// take them: the first full_heads heads are cut into blocks of kConsumers * 64
// rows (the last may reach past T), the other heads into blocks of one
// warpgroup fewer (the wrapper mixes the two so that the last wave is short).
// Made on the host and passed to the kernel.
template <int kConsumers>
struct Units {
  int full_heads, full_units, count;
  FastDiv per_full, per_small;  // units a head: full ones, smaller ones
  Units(int nh, int t, int full_heads_)
      : full_heads(full_heads_),
        full_units(0),
        count(0),
        per_full((t + kConsumers * kWgRows - 1) / (kConsumers * kWgRows)),
        per_small(kConsumers > 1 ? t / ((kConsumers > 1 ? kConsumers - 1 : 1) * kWgRows) : 1) {
    full_units = full_heads * per_full.d;
    count = full_units + (kConsumers > 1 ? (nh - full_heads) * per_small.d : 0);
  }
  // the head, the first query row in it and the warpgroups that work on unit u
  __device__ __forceinline__ void decode(int u, int& head, int& row, int& active) const {
    if (u < full_units) {
      head = per_full.div(u);
      row = (u - head * per_full.d) * (kConsumers * kWgRows);
      active = kConsumers;
    } else {
      const int v = u - full_units;
      const int i = per_small.div(v);
      head = full_heads + i;
      row = (v - i * per_small.d) * ((kConsumers - 1) * kWgRows);
      active = kConsumers - 1;
    }
  }
};

// Accumulator layout of wgmma m64nN (PTX ISA): warp w of the warpgroup owns
// rows 16w .. 16w+15; with g = lane / 4 and c = lane % 4, registers 4j, 4j+1
// hold (row g, columns 8j + 2c, +1) and 4j+2, 4j+3 hold (row g + 8, same
// columns). The A fragment of a 16-deep step from registers is (row g | g+8,
// columns 2c, 2c+1 | +8), so the accumulator of two neighbouring 8-key chunks,
// rounded to bf16, is exactly the A fragment of one 16-key step of P V.
//
// Schedules: one block a unit (kGrid), a persistent grid (kPersistent), a key
// split over clusters (kSplit); each its own instantiation, so that the grid's
// code is one unit's straight line with no unit loop or combine around it.
constexpr int kGrid = 0, kPersistent = 1, kSplit = 2;

// The grid is gridDim.x / splits clusters of `splits` blocks each. Cluster c
// walks units c, c + clusters, c + 2 clusters, ... (a persistent grid when
// clusters < n_units: the producer loads the next unit's Q, into the other of
// q_buffers = 2 buffers, and its first K/V tiles while the consumers finish
// the current unit). Block r of a cluster takes the r-th of `splits` equal
// shares of the keys; with splits > 1 the others hand their partial O, max
// and row sums to block 0 through distributed shared memory, and block 0
// combines them in order 0, 1, ... and stores O (one unit per cluster then).
template <int kConsumers, int D, int kSchedule>
__global__ void __launch_bounds__((kConsumers + 1) * 128, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o, int t,
                    int stages, const Units<kConsumers> units, int split_count, int q_buffers,
                    float scale_log2) {
  using Tl = Tiles<D>;
  constexpr int F = Tl::kCombineFloats;
  const int splits = kSchedule == kSplit ? split_count : 1;  // a constant outside the split's kernel
  const int n_units = units.count;
  const int clusters = gridDim.x / splits;
  const int first_unit = blockIdx.x / splits;
  const uint32_t rank = kSchedule == kSplit ? cluster_rank() : 0;
  const int n_tiles = t / kTileKeys / splits;  // this block's share of the keys
  const int first_key = static_cast<int>(rank) * n_tiles * kTileKeys;

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q_full[2], bar_q_empty[2], bar_full_k[kMaxStages], bar_full_v[kMaxStages],
      bar_empty_k[kMaxStages], bar_empty_v[kMaxStages], bar_combine;

  // [Q: q_buffers x kConsumers x kQBytes][K: stages][V: stages]
  // [the splits' partials: (splits - 1) x kConsumers x F x 128 floats], 1024-aligned
  const uint32_t base = (smem_u32(smem_raw) + kSmemAlign - 1) & ~static_cast<uint32_t>(kSmemAlign - 1);
  const uint32_t q_smem = base;
  const uint32_t k_smem = q_smem + q_buffers * kConsumers * Tl::kQBytes;
  const uint32_t v_smem = k_smem + stages * Tl::kTileBytes;
  const uint32_t combine_smem = v_smem + stages * Tl::kTileBytes;

  // every unit of a block has the same warpgroups (the wrapper makes the
  // units of a persistent grid alike)
  int head, block_row, active;
  units.decode(first_unit, head, block_row, active);

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(&bar_q_full[b]), 1);
      mbar_init(smem_u32(&bar_q_empty[b]), active * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(smem_u32(&bar_full_k[s]), 1);
      mbar_init(smem_u32(&bar_full_v[s]), 1);
      mbar_init(smem_u32(&bar_empty_k[s]), active * 4);
      mbar_init(smem_u32(&bar_empty_v[s]), active * 4);
    }
    // one arrival per consumer thread of every other block of the cluster
    mbar_init(smem_u32(&bar_combine), splits > 1 ? (splits - 1) * active * 128 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // block 0's barriers are initialised before another block of its cluster arrives on them
  if constexpr (kSchedule == kSplit) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  const int wg = threadIdx.x >> 7;
  if (wg < kConsumers && wg >= active) return;  // the warpgroup a smaller block leaves out

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    if constexpr (kConsumers == 3) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      RingSlot slot;  // of the g-th tile this block loads; a slot is free once its tile of the round before was used
      int g = 0;
      int i = 0;  // the i-th unit of this block
      for (int u = first_unit; u < n_units; u += clusters, ++i) {
        int unit_head, unit_row, unit_active;
        units.decode(u, unit_head, unit_row, unit_active);
        const int head_row = unit_head * t;  // first row of this (batch * head)
        const int qb = kSchedule == kPersistent ? (i & 1) : 0;
        if (kSchedule == kPersistent && i >= 2) mbar_wait(smem_u32(&bar_q_empty[qb]), ((i >> 1) - 1) & 1);
        mbar_expect_tx(smem_u32(&bar_q_full[qb]), unit_active * Tl::kQBytes);
        for (int w = 0; w < unit_active; ++w) {
          tma_load_rows(q_smem + (qb * kConsumers + w) * Tl::kQBytes, &map_q, smem_u32(&bar_q_full[qb]),
                        head_row + unit_row + w * kWgRows);
        }
        for (int j = 0; j < n_tiles; ++j, ++g, slot.advance(stages)) {
          const int s = slot.stage;
          const int key_row = head_row + first_key + j * kTileKeys;
          if (g >= stages) mbar_wait(smem_u32(&bar_empty_k[s]), slot.parity ^ 1);
          mbar_expect_tx(smem_u32(&bar_full_k[s]), Tl::kTileBytes);
          tma_load_rows(k_smem + s * Tl::kTileBytes, &map_k, smem_u32(&bar_full_k[s]), key_row);
          if (g >= stages) mbar_wait(smem_u32(&bar_empty_v[s]), slot.parity ^ 1);
          mbar_expect_tx(smem_u32(&bar_full_v[s]), Tl::kTileBytes);
          tma_load_rows(v_smem + s * Tl::kTileBytes, &map_v, smem_u32(&bar_full_v[s]), key_row);
        }
        if constexpr (kSchedule != kPersistent) break;  // one unit a block
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    if constexpr (kConsumers == 3) asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x & 127) >> 5;
    const int g = lane >> 2;
    const int c = lane & 3;

    auto release = [&](uint64_t* bar) {  // every warp of every consumer warpgroup arrives once
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(bar));
    };
    // a stage further on is kTileBytes >> 4 more in a descriptor's address field
    const uint64_t desc_k0 = smem_desc<D>(k_smem), desc_v0 = smem_desc<D>(v_smem);

    // The warpgroups issue their products in turn (named barrier 1 + wg is
    // the turn of warpgroup wg, passed on as soon as the products are issued),
    // so that they stay a third of a round apart: while one waits for its S
    // and the tensor cores work, the others run their exponentials. The turn
    // passes on across units: every warpgroup takes as many turns a unit.
    auto turn_wait = [&]() {
      if (kConsumers > 1) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
    };
    const int next_wg = wg + 1 == active ? 0 : wg + 1;
    auto turn_pass = [&]() {
      if (kConsumers > 1) asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + next_wg) : "memory");
    };
    if (kConsumers > 1 && wg == active - 1) asm volatile("bar.arrive %0, 256;\n" ::"r"(1) : "memory");

    RingSlot slot, prev;  // of tile j and of tile j-1, counted across units
    int i = 0;
    for (int u = first_unit; u < n_units; u += clusters, ++i) {
      units.decode(u, head, block_row, active);
      const int qb = kSchedule == kPersistent ? (i & 1) : 0;
      const uint64_t desc_q = smem_desc<D>(q_smem + (qb * kConsumers + wg) * Tl::kQBytes);

      float s[64];
      float acc[Tl::kAccRegs];
      uint32_t p[8][4];
#pragma unroll
      for (int r = 0; r < Tl::kAccRegs; ++r) acc[r] = 0.f;
      float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of the raw logits, rows g, g+8
      float l_lo = 0.f, l_hi = 0.f;              // this thread's share of the row sums
      float alpha_lo, alpha_hi;

      auto issue_s = [&](const RingSlot& sl) {  // S of a tile, when its K has landed
        mbar_wait(smem_u32(&bar_full_k[sl.stage]), sl.parity);
        issue_qk<D>(s, desc_q, desc_k0 + sl.stage * (Tl::kTileBytes >> 4));
      };
      auto issue_o = [&](const RingSlot& sl) {  // O += P V of a tile, when its V has landed
        mbar_wait(smem_u32(&bar_full_v[sl.stage]), sl.parity);
        issue_pv<D>(acc, p, desc_v0 + sl.stage * (Tl::kTileBytes >> 4));
      };

      // Tile 0 alone: S, softmax, P. Every later round issues S of tile j and
      // P V of tile j-1 together and waits for both before it ends, so that no
      // product is in flight across the loop's back edge (ptxas serialises the
      // wgmmas of a loop that carries one over).
      mbar_wait(smem_u32(&bar_q_full[qb]), (i >> 1) & 1);
      issue_s(slot);
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < 64; ++r) reg_fence(s[r]);
      release(&bar_empty_k[slot.stage]);
      softmax_tile(s, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi, scale_log2);
      pack_probabilities(p, s);

      for (int j = 1; j < n_tiles; ++j) {
        prev = slot;
        slot.advance(stages);
        turn_wait();
        issue_s(slot);
        issue_o(prev);
        turn_pass();
        wgmma_wait<1>();  // S of tile j is complete; P V of tile j-1 may still run
#pragma unroll
        for (int r = 0; r < 64; ++r) reg_fence(s[r]);
        release(&bar_empty_k[slot.stage]);

        softmax_tile(s, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi, scale_log2);

        wgmma_wait<0>();  // P V of tile j-1 is complete: acc and p are ours again
#pragma unroll
        for (int r = 0; r < Tl::kAccRegs; ++r) reg_fence(acc[r]);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) reg_fence(p[kk][r]);
        }
        release(&bar_empty_v[prev.stage]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          acc[4 * dn] *= alpha_lo;
          acc[4 * dn + 1] *= alpha_lo;
          acc[4 * dn + 2] *= alpha_hi;
          acc[4 * dn + 3] *= alpha_hi;
        }
        pack_probabilities(p, s);
      }
      // the last tile's P V
      issue_o(slot);
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < Tl::kAccRegs; ++r) reg_fence(acc[r]);
      if constexpr (kSchedule == kPersistent) {
        // Q and the last V are free; the producer has the next unit's Q in the
        // other buffer already (a release inside the tile loop costs the 4096-key
        // units a few per cent)
        release(&bar_q_empty[qb]);
        release(&bar_empty_v[slot.stage]);
        slot.advance(stages);  // where the next unit's first tile lands
      }

      if constexpr (kSchedule == kSplit) {
        // Thread x of warpgroup w holds the same rows and columns in every
        // block of the cluster: partial f of split r lies at float
        // ((r - 1) * kConsumers + w) * F * 128 + f * 128 + x of block 0's region.
        const int x = threadIdx.x & 127;
        const uint32_t mine = combine_smem + 4u * static_cast<uint32_t>(wg * F * 128 + x);
        constexpr uint32_t kSplitStride = 4u * kConsumers * F * 128;
        if (rank != 0) {
          const uint32_t dst = cluster_map(mine + (rank - 1) * kSplitStride, 0);
#pragma unroll
          for (int f = 0; f < Tl::kAccRegs; ++f) st_cluster_f32(dst + 4u * f * 128, acc[f]);
          st_cluster_f32(dst + 4u * (Tl::kAccRegs + 0) * 128, m_lo);
          st_cluster_f32(dst + 4u * (Tl::kAccRegs + 1) * 128, m_hi);
          st_cluster_f32(dst + 4u * (Tl::kAccRegs + 2) * 128, l_lo);
          st_cluster_f32(dst + 4u * (Tl::kAccRegs + 3) * 128, l_hi);
          mbar_arrive_cluster(cluster_map(smem_u32(&bar_combine), 0));
          continue;  // block 0 stores the unit
        }
        mbar_wait_cluster(smem_u32(&bar_combine), 0);
        // the common max, then each split's share rescaled to it, in split order
        float mx_lo = m_lo, mx_hi = m_hi;
        for (int r = 1; r < splits; ++r) {
          const uint32_t part = mine + (r - 1) * kSplitStride;
          mx_lo = fmaxf(mx_lo, ld_shared_f32(part + 4u * (Tl::kAccRegs + 0) * 128));
          mx_hi = fmaxf(mx_hi, ld_shared_f32(part + 4u * (Tl::kAccRegs + 1) * 128));
        }
        const float w_lo = fast_exp2((m_lo - mx_lo) * scale_log2);
        const float w_hi = fast_exp2((m_hi - mx_hi) * scale_log2);
        l_lo *= w_lo;
        l_hi *= w_hi;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          acc[4 * dn] *= w_lo;
          acc[4 * dn + 1] *= w_lo;
          acc[4 * dn + 2] *= w_hi;
          acc[4 * dn + 3] *= w_hi;
        }
        for (int r = 1; r < splits; ++r) {
          const uint32_t part = mine + (r - 1) * kSplitStride;
          const float wr_lo = fast_exp2((ld_shared_f32(part + 4u * (Tl::kAccRegs + 0) * 128) - mx_lo) * scale_log2);
          const float wr_hi = fast_exp2((ld_shared_f32(part + 4u * (Tl::kAccRegs + 1) * 128) - mx_hi) * scale_log2);
          l_lo = fmaf(ld_shared_f32(part + 4u * (Tl::kAccRegs + 2) * 128), wr_lo, l_lo);
          l_hi = fmaf(ld_shared_f32(part + 4u * (Tl::kAccRegs + 3) * 128), wr_hi, l_hi);
#pragma unroll
          for (int dn = 0; dn < D / 8; ++dn) {
            acc[4 * dn] = fmaf(ld_shared_f32(part + 4u * (4 * dn) * 128), wr_lo, acc[4 * dn]);
            acc[4 * dn + 1] = fmaf(ld_shared_f32(part + 4u * (4 * dn + 1) * 128), wr_lo, acc[4 * dn + 1]);
            acc[4 * dn + 2] = fmaf(ld_shared_f32(part + 4u * (4 * dn + 2) * 128), wr_hi, acc[4 * dn + 2]);
            acc[4 * dn + 3] = fmaf(ld_shared_f32(part + 4u * (4 * dn + 3) * 128), wr_hi, acc[4 * dn + 3]);
          }
        }
      }

      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
      const float inv_lo = 1.f / l_lo;
      const float inv_hi = 1.f / l_hi;

      // the last block of a head may reach past it (T need not divide by the
      // block's rows): those rows were computed on whatever the load brought and
      // are not stored
      const int row_in_head = block_row + wg * kWgRows + warp * 16 + g;
      const size_t row = static_cast<size_t>(head) * t + row_in_head;
      __nv_bfloat16* o_lo = o + row * D + 2 * c;
      __nv_bfloat16* o_hi = o_lo + 8 * D;
      const bool lo_in = row_in_head < t, hi_in = row_in_head + 8 < t;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        if (lo_in) {
          *reinterpret_cast<uint32_t*>(o_lo + 8 * dn) =
              pack_bf16x2(acc[4 * dn] * inv_lo, acc[4 * dn + 1] * inv_lo);
        }
        if (hi_in) {
          *reinterpret_cast<uint32_t*>(o_hi + 8 * dn) =
              pack_bf16x2(acc[4 * dn + 2] * inv_hi, acc[4 * dn + 3] * inv_hi);
        }
      }
      if constexpr (kSchedule != kPersistent) break;  // one unit a block
    }
  }
}

// -------------------------------------------- mma.sync variant (bf16, D = 32 | 64)

constexpr int kBlockQ = 64;  // queries per block
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kWarps = kBlockQ / 16;  // one warp per 16 query rows

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
  const uint32_t addr = smem_u32(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// 4 warps, each owns 16 query rows of the block's 64.
//
// Fragment layouts (PTX ISA, mma.m16n8k16): with g = lane / 4 and c = lane % 4,
// A regs hold (row g | g+8, cols 2c, 2c+1 | +8), B regs hold (k = 2c, 2c+1 | +8,
// n = g), and the f32 accumulator holds (row g | g+8, cols 2c, 2c+1). The
// accumulator of two neighbouring 8-key tiles is therefore exactly the A
// fragment of a 16-key step, which is how P goes from the first product into
// the second without touching shared memory.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_mma_sync(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
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

// ------------------------------------------------------- SIMT variant (f32)

constexpr int kF32BlockQ = 32;   // queries per block
constexpr int kF32BlockK = 64;   // keys per tile
constexpr int kF32Threads = 128;  // 8 row groups of 4 queries x 16 column groups
constexpr int kF32Pad = 4;       // row stride D + 4 floats: conflict-free 16-byte loads

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

template <int D>
__device__ __forceinline__ void f32_load_rows(float* dst, const float* src, int rows) {
  constexpr int kLd = D + kF32Pad;
  for (int i = threadIdx.x; i < rows * (D / 4); i += kF32Threads) {
    const int r = i / (D / 4);
    const int cc = (i % (D / 4)) * 4;
    cp_async_16(dst + r * kLd + cc, src + static_cast<size_t>(r) * D + cc);
  }
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4 ty .. 4 ty + 3. In S
// it owns keys tx, tx + 16, tx + 32, tx + 48 of the tile; in O it owns the D / 16
// columns from tx * D / 16. The 16 threads that share a row are one half-warp:
// the row max and the final row sum cross it with shuffles, and P reaches the
// second product through shared memory behind a __syncwarp.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int t, float scale_log2) {
  constexpr int kLd = D + kF32Pad;
  constexpr int kPLd = kF32BlockK + kF32Pad;
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ uint8_t smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [32][kLd]
  float* ks = qs + kF32BlockQ * kLd;                // [2][64][kLd]
  float* vs = ks + 2 * kF32BlockK * kLd;            // [2][64][kLd]
  float* ps = vs + 2 * kF32BlockK * kLd;            // [32][kPLd]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t head = static_cast<size_t>(blockIdx.y) * t * D;
  const float* qh = q + head + static_cast<size_t>(blockIdx.x) * kF32BlockQ * D;
  const float* kh = k + head;
  const float* vh = v + head;

  f32_load_rows<D>(qs, qh, kF32BlockQ);
  f32_load_rows<D>(ks, kh, kF32BlockK);
  f32_load_rows<D>(vs, vh, kF32BlockK);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[i][cc] = 0.f;
  }

  const int n_tiles = t / kF32BlockK;
  for (int j = 0; j < n_tiles; ++j) {
    const float* kt = ks + (j & 1) * kF32BlockK * kLd;
    const float* vt = vs + (j & 1) * kF32BlockK * kLd;
    if (j + 1 < n_tiles) {
      const size_t next = static_cast<size_t>(j + 1) * kF32BlockK * D;
      f32_load_rows<D>(ks + ((j + 1) & 1) * kF32BlockK * kLd, kh + next, kF32BlockK);
      f32_load_rows<D>(vs + ((j + 1) & 1) * kF32BlockK * kLd, vh + next, kF32BlockK);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    // S = Q K^T: 4 rows x 4 keys per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kLd + d0);
        kv[i] = *reinterpret_cast<const float4*>(kt + (tx + 16 * i) * kLd + d0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
        }
      }
    }

    // online softmax in base 2; P to shared memory for the second product
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] *= scale_log2;
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, m[i]);
      const float alpha = exp2f(m[i] - mx);  // 0 on the first tile
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float pj = exp2f(s[i][jj] - mx);
        sum += pj;
        ps[(4 * ty + i) * kPLd + tx + 16 * jj] = pj;
      }
      l[i] = l[i] * alpha + sum;  // this thread's share of the row sum
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[i][cc] *= alpha;
    }
    __syncwarp();  // the rows of P a thread reads were written by its own half-warp

    // O += P V: 4 rows x D / 16 columns per thread
#pragma unroll 2
    for (int k0 = 0; k0 < kF32BlockK; k0 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kPLd + k0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float vv[kCols];
        const float* vr = vt + (k0 + kk) * kLd + tx * kCols;
        if constexpr (kCols == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vr);
          vv[0] = x.x, vv[1] = x.y, vv[2] = x.z, vv[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vr);
          vv[0] = x.x, vv[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pk = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y : kk == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) acc[i][cc] = fmaf(pk, vv[cc], acc[i][cc]);
        }
      }
    }
    __syncthreads();  // the tile and P are free for the next round
  }

  float* oh = o + head + static_cast<size_t>(blockIdx.x) * kF32BlockQ * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    float* orow = oh + static_cast<size_t>(4 * ty + i) * D + tx * kCols;
    if constexpr (kCols == 4) {
      *reinterpret_cast<float4*>(orow) =
          make_float4(acc[i][0] / sum, acc[i][1] / sum, acc[i][2] / sum, acc[i][3] / sum);
    } else {
      *reinterpret_cast<float2*>(orow) = make_float2(acc[i][0] / sum, acc[i][1] / sum);
    }
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled out of the libcuda that the runtime has loaded: this
// library is not linked against it.
EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A [rows, D] bf16 matrix as a 2-D tensor map with boxes of box_rows rows,
// written to shared memory with the swizzle of one D-wide row (128 or 64 bytes).
template <int D>
CUresult encode_rows(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, uint64_t rows,
                     uint32_t box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), rows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(D), box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// grid_units clusters of `splits` blocks walk the launch's units (a persistent
// grid when fewer than the units; their units must then be alike and the keys
// unsplit). The plan's stages, full_heads and smem_bytes are checked, not trusted.
template <int kConsumers, int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int nh, int t, int stages,
                 int full_heads, int grid_units, int splits, int smem_bytes, float scale_log2,
                 cudaStream_t stream) {
  using Tl = Tiles<D>;
  const int key_tiles = t / kTileKeys;
  if (t % kTileKeys != 0 || splits < 1 || splits > kMaxSplits || key_tiles % splits != 0 ||
      full_heads < 0 || full_heads > nh || (kConsumers == 1 && full_heads != nh)) {
    return cudaErrorInvalidValue;
  }
  const int n_tiles = key_tiles / splits;
  if (stages < 1 || stages > kMaxStages || (stages < 2 && n_tiles > 1)) return cudaErrorInvalidValue;
  const Units<kConsumers> units(nh, t, full_heads);
  const int n_units = units.count;
  if (grid_units < 1 || grid_units > n_units) return cudaErrorInvalidValue;
  const bool persistent = grid_units < n_units;
  if (persistent && (splits != 1 || (full_heads != nh && full_heads != 0))) return cudaErrorInvalidValue;
  const int q_buffers = persistent ? 2 : 1;
  const int need = kSmemAlign + q_buffers * kConsumers * Tl::kQBytes + 2 * stages * Tl::kTileBytes +
                   (splits - 1) * kConsumers * Tl::kCombineFloats * 128 * 4;
  if (smem_bytes != need) return cudaErrorInvalidValue;
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap map_q, map_k, map_v;
  const uint64_t all_rows = static_cast<uint64_t>(nh) * t;
  CUresult res = encode_rows<D>(fn, &map_q, q, all_rows, kWgRows);
  if (res == CUDA_SUCCESS) res = encode_rows<D>(fn, &map_k, k, all_rows, kTileKeys);
  if (res == CUDA_SUCCESS) res = encode_rows<D>(fn, &map_v, v, all_rows, kTileKeys);
  if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
  auto kernel = splits > 1 ? flash_fwd_wgmma<kConsumers, D, kSplit>
                : persistent ? flash_fwd_wgmma<kConsumers, D, kPersistent>
                             : flash_fwd_wgmma<kConsumers, D, kGrid>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  if (splits == 1) {
    kernel<<<grid_units, (kConsumers + 1) * 128, smem_bytes, stream>>>(
        map_q, map_k, map_v, ob, t, stages, units, 1, q_buffers, scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid_units * splits);
  config.blockDim = dim3((kConsumers + 1) * 128);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, map_q, map_k, map_v, ob, t, stages, units, splits,
                           q_buffers, scale_log2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* o, int nh, int t,
               int smem_bytes, float scale_log2, cudaStream_t stream) {
  constexpr int kNeed =
      4 * ((kF32BlockQ + 4 * kF32BlockK) * (D + kF32Pad) + kF32BlockQ * (kF32BlockK + kF32Pad));
  if (t % kF32BlockK != 0 || smem_bytes != kNeed) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_f32<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(t / kF32BlockQ, nh), kF32Threads, smem_bytes, stream>>>(q, k, v, o, t, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 mma.sync bf16, 1 wgmma with one consumer warpgroup (64 queries a
// unit), 2 wgmma with three (192 queries a unit for the first full_heads
// heads, 128 with two of the three for the rest), 3 SIMT f32. grid_units is
// the number of clusters that walk the wgmma kernel's units, splits the blocks
// of a cluster (the key split); the other variants take one block per query
// block and no split. stages, full_heads, grid_units, splits and smem_bytes
// are the wrapper's launch plan; they are checked, not trusted.
extern "C" int irp_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int nh, int t, int d, int variant, int stages,
                                       int full_heads, int grid_units, int splits, int smem_bytes,
                                       float scale, void* stream) {
  if (nh <= 0 || t <= 0 || nh > 65535 || static_cast<int64_t>(nh) * t > INT32_MAX) {
    return cudaErrorInvalidValue;  // rows are counted in 32 bits, as the tensor maps' coordinates are
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)
  if (variant == 1 || variant == 2) {
    if (d == 64) {
      return variant == 1 ? launch_wgmma<1, 64>(q, k, v, o, nh, t, stages, full_heads, grid_units,
                                                splits, smem_bytes, scale_log2, s)
                          : launch_wgmma<3, 64>(q, k, v, o, nh, t, stages, full_heads, grid_units,
                                                splits, smem_bytes, scale_log2, s);
    }
    if (d == 32) {
      return variant == 1 ? launch_wgmma<1, 32>(q, k, v, o, nh, t, stages, full_heads, grid_units,
                                                splits, smem_bytes, scale_log2, s)
                          : launch_wgmma<3, 32>(q, k, v, o, nh, t, stages, full_heads, grid_units,
                                                splits, smem_bytes, scale_log2, s);
    }
    return cudaErrorInvalidValue;
  }
  if (splits != 1) return cudaErrorInvalidValue;
  if (variant == 0) {
    if (t % kBlockQ != 0 || smem_bytes != 0 || grid_units != nh * (t / kBlockQ)) {
      return cudaErrorInvalidValue;
    }
    const dim3 grid(t / kBlockQ, nh);
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(o);
    if (d == 64) {
      flash_fwd_mma_sync<64><<<grid, kWarps * 32, 0, s>>>(qb, kb, vb, ob, t, scale_log2);
    } else if (d == 32) {
      flash_fwd_mma_sync<32><<<grid, kWarps * 32, 0, s>>>(qb, kb, vb, ob, t, scale_log2);
    } else {
      return cudaErrorInvalidValue;
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 3) {
    if (t % kF32BlockQ != 0 || grid_units != nh * (t / kF32BlockQ)) return cudaErrorInvalidValue;
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(o);
    if (d == 64) return launch_f32<64>(qf, kf, vf, of, nh, t, smem_bytes, scale_log2, s);
    if (d == 32) return launch_f32<32>(qf, kf, vf, of, nh, t, smem_bytes, scale_log2, s);
    return cudaErrorInvalidValue;
  }
  return cudaErrorInvalidValue;
}

