// The Swin transformer's MLP for Hopper (sm_90a): for tokens x [M, C] bf16,
//
//   m = GELU(x W1 + b1) W2 + b2,   W1 [C, H], W2 [H, C], GELU the erf form,
//
// with f32 products, the biases added in f32, the hidden value rounded to
// bf16 once (as the second product's operand) and m rounded to bf16 [M, C]
// in token order. SwinIR's Swin layer (models/swinir.py:Mlp) calls it once
// a layer; at SwinIR-M's width C = 180, H = 360.
//
// It replaces no TPU kernel: the JAX package has no transformer. It takes the
// place of three PyTorch passes (fc1, GELU, fc2): fc1 wrote the [M, H] hidden
// tensor, GELU read it and wrote it again, and fc2 read it, so that 1.9 GB
// crossed device memory a chunk of 8 tiles for an MLP whose input and output
// are 189 MB each. Here the hidden tensor never leaves the SM.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s):
// operations. At a chunk of 8 tiles of 256 x 256 (M = 524,288) it does
// 4 M C H = 135.9 GFLOP (0.137 ms at peak) and must move x and m, 377 MB
// (0.113 ms), and the weights, 260 KB. Two limits sit beside the tensor
// cores: the erf of the M H hidden values, ~25 instructions each (erff, as
// PyTorch's GELU calls it), ~0.17 ms of the SMs' issue slots that the
// products can only overlap; and the weights, which do not fit in shared
// memory beside the tokens and are read again from L2 for every 128 tokens.
// What the design does about them:
//
// * wgmma: fc1 is m64n64k16 with both operands in shared memory; its f32
//   accumulator, plus b1, through GELU and rounded to bf16, is the A
//   fragment of fc2 (m64n184k16, A from registers) as it lies, as
//   csrc/flash_attention.cu hands P to P V. C is zero-padded to 192 as fc1's
//   depth and to 184 as fc2's width, H to 384 (six slices of 64): zero
//   weights, laid out once by the wrapper, and zeros written into shared
//   memory; no activation in device memory is padded.
// * Warp-specialised and persistent: one block an SM, each walking units of
//   128 tokens. Two consumer warpgroups own 64 tokens each and keep m's
//   64 x 184 f32 accumulator in registers across the six slices. They issue
//   their products in turn, so that one runs its GELU while the tensor
//   cores run the other's products. The descriptors are made where they are
//   used: a table of them kept live took the accumulators' registers and
//   spilled.
// * The tokens: a row of 180 bf16 is 360 bytes, only 8-byte aligned, so no
//   2-D tensor map can describe x. Three producer warps copy each unit with
//   8-byte cp.async straight into the 128-byte-swizzled K-major layout wgmma
//   reads (neighbouring threads on neighbouring addresses: 256 contiguous
//   bytes a warp instruction), zero-filling the padding columns and the
//   rows past M, two units in flight. The biases sit in shared memory: the
//   copies stream through L1 and would push them out of it, and GELU would
//   wait on L2 for them.
// * The weights: the wrapper lays W1 and W2 out once, slice by slice,
//   already swizzled, so each slice's 24 KB of W1 and 23 KB of W2 is one 1-D
//   bulk copy from L2 into a ring of two stages each (W1 and W2 apart, so
//   that W1 of the next slice lands while fc2 of this one still reads W2):
//   1.2 GB of L2 reads a chunk, hidden behind the products (a launch
//   without the copies read 1 % faster).
// * m leaves through shared memory: a warpgroup's 64 rows are 23 KB of
//   contiguous m, written with bulk copies in whole lines. 4-byte stores
//   straight from the accumulator layout (8 rows a warp instruction) took
//   0.28 ms a launch alone.
//
// Measured on an H100 SXM at 700 W (PERF.md, section 6): 0.467 ms a
// launch at SwinIR-M's chunk, 29 % of its bound; the chain of F.linear,
// F.gelu and F.linear it replaces 1.40 ms. Without GELU's instructions the
// same launch takes 0.29 ms; an erfc of 1.2e-7 relative error (two MUFU
// operations, no branch) in place of erff took 0.437 ms.
//
// C interface (loaded with ctypes): irp_swin_mlp returns the cudaError_t of
// the launch; it launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnitRows = 128;  // tokens a unit
constexpr int kWgRows = 64;     // tokens a consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kLoaders = 96;     // producer warps 1-3 copy the tokens
constexpr int kMaxChannels = 184;
constexpr int kDepthBlocks = 3;  // fc1's depth, 192: three swizzle rows of 64 bf16
constexpr int kChunks = kDepthBlocks * 16;  // 8-byte pieces of a padded token row
constexpr int kSlice = 64;       // hidden columns a slice
constexpr int kSlices = 6;       // H padded to 384
constexpr int kHiddenPad = kSlice * kSlices;
constexpr int kOut = 184;        // fc2's width
constexpr int kOutRegs = kOut / 2;  // f32 registers of m a consumer thread holds
constexpr int kXBlockBytes = kUnitRows * 128;            // one depth block of a unit: 16 KB
constexpr int kXBytes = kDepthBlocks * kXBlockBytes;     // 48 KB
constexpr int kW1BlockBytes = kSlice * 128;              // 8 KB
constexpr int kW1Bytes = kDepthBlocks * kW1BlockBytes;   // 24 KB
constexpr int kW2Bytes = kOut * 128;                     // 23 KB
constexpr int kSliceBytes = kW1Bytes + kW2Bytes;
constexpr int kSmemAlign = 1024;  // the 128-byte swizzle pattern repeats every 8 rows
constexpr int kSmemBytes = kSmemAlign + 2 * (kXBytes + kW1Bytes + kW2Bytes);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
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

// ``bytes`` contiguous bytes from device memory into shared memory, counted
// on the barrier when they have landed.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// ``bytes`` contiguous bytes from shared memory to device memory, in the
// thread's bulk async-group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// 8 bytes (or, with src_bytes 0, zeros) into shared memory.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are one
// 128-byte swizzle row: 8-row groups lie 1024 bytes apart (the stride
// offset; the leading offset is not read at this width and is set alike).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>(1024 >> 4) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

// The same value through an opaque move, made where it is used: the
// compiler keeps no table of descriptors live in registers across the slices.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(d));
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Ties a register to a point in the instruction stream: the compiler may not
// move its uses across (wgmma reads and writes registers asynchronously).
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B in shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 184] (+)= A[64 x 16] B[184 x 16]^T, A from registers, B in shared
// memory, K-major.
__device__ __forceinline__ void wgmma_m64n184k16_rs(float (&d)[kOutRegs], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %97, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91}, "
      "{%92, %93, %94, %95}, %96, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// The erf form of GELU as PyTorch's kernel writes it, in f32.
__device__ __forceinline__ float gelu(float v) { return v * 0.5f * (1.f + erff(v * 0.70710678118654752f)); }

// Where a slice lies in a ring of two: slice j is in stage j % 2, its
// barriers in the phase of parity (j / 2) & 1.
struct RingSlot {
  int stage = 0;
  uint32_t parity = 0;
  __device__ __forceinline__ void advance() {
    stage ^= 1;
    parity ^= stage == 0;
  }
};

// Accumulator layout of wgmma m64nN (PTX ISA): warp w of the warpgroup owns
// rows 16w .. 16w+15; with g = lane / 4 and c = lane % 4, registers 4j, 4j+1
// hold (row g, columns 8j + 2c, +1) and 4j+2, 4j+3 (row g + 8, the same
// columns). The A fragment of a 16-deep step from registers is (row g | g+8,
// columns 2c, 2c+1 | +8), so two neighbouring 8-column chunks of fc1's
// accumulator are one 16-deep step of fc2.
//
// Shared memory, 1024-aligned: [x: 2 buffers x 3 depth blocks x 128 rows x
// 128 B][W1: 2 stages x 3 depth blocks x 64 rows x 128 B][W2: 2 stages x 184
// rows x 128 B], every row a 128-byte swizzle row (16-byte chunk j of row r
// at chunk j ^ (r % 8)). The packed weights (wpack) are the same bytes slice
// by slice: W1 of slice s (hidden units 64s.., their 192 input channels,
// depth-block-major), then W2 of slice s (184 output channels, their 64
// hidden inputs); bias holds b1 padded to 384 and then b2 padded to 184, f32.
__global__ void __launch_bounds__(kThreads, 1)
    swin_mlp_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wpack,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int rows, int channels) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_x_full[2], bar_x_empty[2], bar_w1_full[2], bar_w1_empty[2], bar_w2_full[2],
      bar_w2_empty[2];
  // the biases, read from shared memory: the tokens' copies stream through L1
  // and would push them out of it
  __shared__ __align__(16) float s_bias[kHiddenPad + kOut];
  const uint32_t base = (smem_u32(smem_raw) + kSmemAlign - 1) & ~static_cast<uint32_t>(kSmemAlign - 1);
  const uint32_t x_smem = base;
  const uint32_t w1_smem = x_smem + 2 * kXBytes;
  const uint32_t w2_smem = w1_smem + 2 * kW1Bytes;
  const int n_units = (rows + kUnitRows - 1) / kUnitRows;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(&bar_x_full[b]), kLoaders);
      mbar_init(smem_u32(&bar_x_empty[b]), kConsumers);  // one arrival per consumer warpgroup
      mbar_init(smem_u32(&bar_w1_full[b]), 1);
      mbar_init(smem_u32(&bar_w1_empty[b]), kConsumers * 4);
      mbar_init(smem_u32(&bar_w2_full[b]), 1);
      mbar_init(smem_u32(&bar_w2_empty[b]), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < kHiddenPad + kOut; i += kThreads) s_bias[i] = bias[i];
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0) {
      if (lane != 0) return;
      // the weights: the t-th slice this block uses goes into stage t % 2,
      // once both warpgroups are done with the slice two before it
      RingSlot slot;
      int t = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        for (int s = 0; s < kSlices; ++s, ++t, slot.advance()) {
          const uint8_t* src = wpack + static_cast<size_t>(s) * kSliceBytes;
          const uint32_t full1 = smem_u32(&bar_w1_full[slot.stage]), full2 = smem_u32(&bar_w2_full[slot.stage]);
          if (t >= 2) mbar_wait(smem_u32(&bar_w1_empty[slot.stage]), slot.parity ^ 1);
          mbar_expect_tx(full1, kW1Bytes);
          bulk_load(w1_smem + slot.stage * kW1Bytes, src, kW1Bytes, full1);
          if (t >= 2) mbar_wait(smem_u32(&bar_w2_empty[slot.stage]), slot.parity ^ 1);
          mbar_expect_tx(full2, kW2Bytes);
          bulk_load(w2_smem + slot.stage * kW2Bytes, src + kW1Bytes, kW2Bytes, full2);
        }
      }
      return;
    }
    // the tokens: 96 threads, 48 eight-byte pieces a padded row, so thread
    // i copies piece i % 48 of rows i / 48, + 2, + 4, ... of the unit
    const int i = threadIdx.x - kConsumers * 128 - 32;
    const int piece = i % kChunks;
    const bool in_row = 4 * piece < channels;
    const uint32_t piece_off = (piece >> 4) * kXBlockBytes + ((piece & 1) << 3);
    const uint32_t chunk = (piece >> 1) & 7;
    int n = 0;  // the n-th unit of this block, into buffer n % 2
    for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++n) {
      const int b = n & 1;
      if (n >= 2) mbar_wait(smem_u32(&bar_x_empty[b]), ((n >> 1) - 1) & 1);
      const uint32_t dst0 = x_smem + b * kXBytes + piece_off;
      const int row0 = u * kUnitRows;
#pragma unroll 8
      for (int r = i / kChunks; r < kUnitRows; r += kLoaders / kChunks) {
        const bool valid = in_row && row0 + r < rows;
        const __nv_bfloat16* src = valid ? x + static_cast<size_t>(row0 + r) * channels + 4 * piece : x;
        cp_async8(dst0 + r * 128 + ((chunk ^ (r & 7)) << 4), src, valid ? 8 : 0);
      }
      // the copies have landed; the generic proxy's writes are made visible
      // to wgmma's (async proxy) reads before the release
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(smem_u32(&bar_x_full[b]));
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = lane >> 2;
  const int c = lane & 3;
  auto release = [&](uint64_t* bar) {  // every warp of both consumer warpgroups arrives once
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(bar));
  };
  // The two warpgroups issue their products in turn (named barrier 1 + wg
  // is warpgroup wg's turn, passed on as soon as its products are issued),
  // so that the tensor cores run one's products while the other runs its
  // GELU. Every warpgroup takes seven turns a unit.
  auto turn_wait = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); };
  auto turn_pass = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory"); };
  if (wg == 1) turn_pass();

  float o[kOutRegs];
  float h[32];
  uint32_t p[4][4];
#pragma unroll
  for (int r = 0; r < kOutRegs; ++r) o[r] = 0.f;
  RingSlot slot, prev;  // of the slice in use and the one before it, counted across units
  int n = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++n) {
    const int b = n & 1;
    mbar_wait(smem_u32(&bar_x_full[b]), (n >> 1) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t x_rows = x_smem + b * kXBytes + wg * kWgRows * 128;  // this warpgroup's rows, depth block 0

    // Slice s: fc1 into h, wait (fc2 of slice s-1 completes with it), GELU
    // into p, fc2 issued, and fc1 of slice s+1 issued right behind it in the
    // same turn. fc2 of the last slice is waited for after the loop, so no
    // product is in flight across the unit loop's back edge.
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      const uint32_t w1 = w1_smem + slot.stage * kW1Bytes;
      mbar_wait(smem_u32(&bar_w1_full[slot.stage]), slot.parity);
#pragma unroll
      for (int r = 0; r < 32; ++r) reg_fence(h[r]);
      if (s == 0) turn_wait();
      wgmma_fence();
      const uint64_t desc_x = opaque(smem_desc(x_rows)), desc_w1 = opaque(smem_desc(w1));
#pragma unroll
      for (int kk = 0; kk < 4 * kDepthBlocks; ++kk) {
        // 16 channels a step: 32 bytes further along the swizzled rows of a
        // depth block (2 in the descriptor's 16-byte units)
        wgmma_m64n64k16_ss(h, desc_x + (((kk >> 2) * kXBlockBytes) >> 4) + 2 * (kk & 3),
                           desc_w1 + (((kk >> 2) * kW1BlockBytes) >> 4) + 2 * (kk & 3), kk > 0);
      }
      wgmma_commit();
      turn_pass();
      wgmma_wait_all();
#pragma unroll
      for (int r = 0; r < 32; ++r) reg_fence(h[r]);
#pragma unroll
      for (int r = 0; r < kOutRegs; ++r) reg_fence(o[r]);
      release(&bar_w1_empty[slot.stage]);
      if (s > 0) release(&bar_w2_empty[prev.stage]);

      const float* b1 = s_bias + s * kSlice + 2 * c;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float2 lo = *reinterpret_cast<const float2*>(b1 + 16 * kk);
        const float2 hi = *reinterpret_cast<const float2*>(b1 + 16 * kk + 8);
        p[kk][0] = pack_bf16x2(gelu(h[8 * kk] + lo.x), gelu(h[8 * kk + 1] + lo.y));
        p[kk][1] = pack_bf16x2(gelu(h[8 * kk + 2] + lo.x), gelu(h[8 * kk + 3] + lo.y));
        p[kk][2] = pack_bf16x2(gelu(h[8 * kk + 4] + hi.x), gelu(h[8 * kk + 5] + hi.y));
        p[kk][3] = pack_bf16x2(gelu(h[8 * kk + 6] + hi.x), gelu(h[8 * kk + 7] + hi.y));
      }

      const uint32_t w2 = w2_smem + slot.stage * kW2Bytes;
      mbar_wait(smem_u32(&bar_w2_full[slot.stage]), slot.parity);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) reg_fence(p[kk][r]);
      }
      turn_wait();
      wgmma_fence();
      const uint64_t desc_w2 = opaque(smem_desc(w2));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n184k16_rs(o, p[kk], desc_w2 + 2 * kk, s > 0 || kk > 0);
      }
      wgmma_commit();
      if (s == kSlices - 1) turn_pass();
      prev = slot;
      slot.advance();
    }
    wgmma_wait_all();
#pragma unroll
    for (int r = 0; r < kOutRegs; ++r) reg_fence(o[r]);
    release(&bar_w2_empty[prev.stage]);

    // m + b2, rounded to bf16 in token order. A warpgroup's 64 rows are
    // 128 C contiguous bytes of m: they are laid out in its own rows of the
    // unit's token buffer (its products have read them; the other warpgroup
    // never reads them), three pieces of 8 KB, and written with bulk copies,
    // whole lines of device memory. The buffer goes back to the loaders once
    // the copies have read it. Rows of a unit past M (the last unit's) are
    // stored one 4-byte pair at a time instead.
    const int wg_row0 = u * kUnitRows + wg * kWgRows;
    const int row = wg_row0 + warp * 16 + g;
    const float* b2 = s_bias + kHiddenPad + 2 * c;
    const bool whole = wg_row0 + kWgRows <= rows;
    const uint32_t line = static_cast<uint32_t>(channels) * 2;  // bytes of a token row
#pragma unroll
    for (int j = 0; j < kOut / 8; ++j) {
      if (8 * j + 2 * c < channels) {
        const float2 bb = *reinterpret_cast<const float2*>(b2 + 8 * j);
        const uint32_t lo = pack_bf16x2(o[4 * j] + bb.x, o[4 * j + 1] + bb.y);
        const uint32_t hi = pack_bf16x2(o[4 * j + 2] + bb.x, o[4 * j + 3] + bb.y);
        if (whole) {
          const uint32_t at_lo = (warp * 16 + g) * line + (8 * j + 2 * c) * 2, at_hi = at_lo + 8 * line;
          st_shared_u32(x_rows + (at_lo >> 13) * kXBlockBytes + (at_lo & 8191), lo);
          st_shared_u32(x_rows + (at_hi >> 13) * kXBlockBytes + (at_hi & 8191), hi);
        } else {
          __nv_bfloat16* out_lo = out + static_cast<size_t>(row) * channels + 8 * j + 2 * c;
          if (row < rows) *reinterpret_cast<uint32_t*>(out_lo) = lo;
          if (row + 8 < rows) *reinterpret_cast<uint32_t*>(out_lo + 8 * channels) = hi;
        }
      }
    }
    if (whole) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the copies read what was written
    asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
    if ((threadIdx.x & 127) == 0) {
      if (whole) {
        uint8_t* dst = reinterpret_cast<uint8_t*>(out) + static_cast<size_t>(wg_row0) * line;
        const uint32_t total = kWgRows * line;
        for (uint32_t at = 0; at < total; at += 8192) {
          bulk_store(dst + at, x_rows + (at >> 13) * kXBlockBytes, total - at < 8192 ? total - at : 8192);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      mbar_arrive(smem_u32(&bar_x_empty[b]));
    }
  }
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// x [rows, channels] bf16, 16-byte aligned, channels a multiple of 4 up to
// 184; wpack and bias the wrapper's packed weights (ops/cuda/swin_mlp.py:
// pack_weights); out [rows, channels] bf16. grid: the blocks that walk the
// 128-token units, at most one an SM and at most the units.
extern "C" int irp_swin_mlp(const void* x, const void* wpack, const void* bias, void* out, int rows, int channels,
                            int grid, void* stream) {
  const int n_units = (rows + kUnitRows - 1) / kUnitRows;
  if (rows < 1 || channels < 4 || channels > kMaxChannels || channels % 4 != 0 || grid < 1 || grid > n_units) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* kernel = swin_mlp_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wpack), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), rows, channels);
  return static_cast<int>(cudaGetLastError());
}

