// Hann-windowed overlap-add of tiles for Hopper (sm_90a): the fold of the
// tiled super-resolution path. tiles [n_ty * n_tx, T, T, C] f32, row-major over
// (tile row, tile column), land at origins (ys[r], xs[cx]) of an [H, W, C] f32
// canvas; every output element is sum(tile * window) / max(sum(window), 1e-8)
// over the tiles that cover it, and is written once.
//
// Replaces the TPU kernel image_restoration_platform_tpu/ops/pallas/blend.py
// (blend_tiles_pallas, launched through pl.pallas_call). That kernel owns one
// output strip per grid step in VMEM, keeps tiles channel-planar and places
// rows with a one-hot [strip_h, T] @ [T, C*T] matmul, because Mosaic can
// neither reshape nor scatter inside a kernel. None of that carries over: on
// the card the fold is a gather over the flattened [H, W*C] canvas.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. At the main shape (81
// tiles of 512 x 512 x 3 onto 4096 x 4096 x 3) it must read 255 MB of tiles
// and write 201 MB, 0.136 ms at the memory rate, against 2 flops per tile
// element. What the design does about it:
//
// * 16-byte loads and stores: a thread owns kVec = 4 consecutive floats of a
//   canvas row. The wrapper launches this variant when W*C, T*C and every
//   xs[cx]*C are multiples of 4 and the buffers are 16-byte aligned, so that a
//   thread's four floats lie inside or outside a tile together and both sides
//   of the copy are aligned; any other geometry takes kVec = 1, the same code
//   with 4-byte accesses.
// * a block owns kRows = 8 canvas rows by a span of 256 * kVec floats, so the
//   main shape is 6,144 blocks, and finds its contributors once: one warp lists
//   the tile columns that touch the span, and warp w lists the tile rows that
//   cover canvas row y0 + w, both in ascending order into shared memory (any
//   number of them: overlap > T/2 and clamped last tiles give more than two).
//   A thread then walks those short lists instead of every origin.
// * C is a template parameter for 1 and 3 (any other C takes the generic
//   instance), so the pixel of each float comes from a multiply, not a divide;
//   with C >= 2 four floats span at most two pixels, hence two window loads.
// * the window stays the host's [T, T] f32 table (the float64 outer product
//   cast once): a 1-D window multiplied in the kernel would round differently.
//
// The arithmetic is the plain fold's (ops/tile.py blend_tiles), bit for bit:
// tiles are added in row-major tile order with __fmul_rn / __fadd_rn, so nvcc
// cannot contract them into FMAs, and the divide is IEEE. Measured on an H100
// SXM at 700 W, main shape: 0.168 ms with 16-byte accesses, 81 % of the bound
// (0.284 ms with 4-byte accesses; one thread per float before: 0.637 ms).
//
// C interface (loaded with ctypes): irp_blend_tiles returns the cudaError_t of
// the launch; it launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // canvas rows per block, one warp lists the tile rows of each

template <int kVec>
struct Vec;
template <>
struct Vec<4> {
  using type = float4;
};
template <>
struct Vec<1> {
  using type = float;
};

__device__ __forceinline__ void unpack(const float4& a, float (&v)[4]) {
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void unpack(const float& a, float (&v)[1]) { v[0] = a; }
__device__ __forceinline__ float4 pack(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float pack(const float (&v)[1]) { return v[0]; }

// Appends, in ascending order, every i < n with pred(i) to list (and the
// matching value(i) to values); one warp calls it. Returns the count.
template <typename Pred, typename Value>
__device__ __forceinline__ int warp_compact(int n, int lane, int* list, int* values, Pred pred,
                                            Value value) {
  int count = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const bool keep = i < n && pred(i);
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int pos = count + __popc(mask & ((1u << lane) - 1u));
      list[pos] = i;
      values[pos] = value(i);
    }
    count += __popc(mask);
  }
  return count;
}

// kC = 0: the channel count is the runtime argument c.
template <int kVec, int kC>
__global__ void __launch_bounds__(kThreads)
blend_tiles_kernel(const float* __restrict__ tiles, const float* __restrict__ window,
                   const int* __restrict__ ys, const int* __restrict__ xs,
                   float* __restrict__ out, int n_ty, int n_tx, int t, int c_arg, int out_h,
                   int out_w, int spans_per_row) {
  using vec_t = typename Vec<kVec>::type;
  const int c = kC > 0 ? kC : c_arg;
  const int row_len = out_w * c;
  const int tile_len = t * c;  // floats in one tile row

  // [col_count, row_count[kRows]] [col_list n_tx] [col_off n_tx] [row_list kRows * n_ty] [row_ty ...]
  extern __shared__ int lists[];
  int* counts = lists;
  int* col_list = counts + 1 + kRows;
  int* col_off = col_list + n_tx;
  int* row_list = col_off + n_tx;
  int* row_ty = row_list + kRows * n_ty;

  const int span = blockIdx.x % spans_per_row;
  const int y0 = (blockIdx.x / spans_per_row) * kRows;
  const int j0 = span * (kThreads * kVec);  // first float of the span in its row
  const int j1 = min(j0 + kThreads * kVec, row_len);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  {
    // warp w: the tile rows that cover canvas row y0 + w, with the row inside the tile
    const int y = y0 + warp;
    const int n = warp_compact(
        y < out_h ? n_ty : 0, lane, row_list + warp * n_ty, row_ty + warp * n_ty,
        [&](int r) { return y >= ys[r] && y < ys[r] + t; }, [&](int r) { return y - ys[r]; });
    if (lane == 0) counts[1 + warp] = n;
  }
  if (warp == 0) {
    // the tile columns whose floats [xs * c, (xs + t) * c) touch the span, with that first float
    const int n = warp_compact(
        n_tx, lane, col_list, col_off,
        [&](int cx) { return xs[cx] * c < j1 && (xs[cx] + t) * c > j0; },
        [&](int cx) { return xs[cx] * c; });
    if (lane == 0) counts[0] = n;
  }
  __syncthreads();

  const int j = j0 + threadIdx.x * kVec;
  if (j >= row_len) return;
  // the pixel of each of this thread's floats (a multiply when kC is a constant)
  int px[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) px[i] = (j + i) / c;

  const int n_cols = counts[0];
  for (int rr = 0; rr < kRows; ++rr) {
    const int y = y0 + rr;
    if (y >= out_h) break;
    float acc[kVec], wsum[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = wsum[i] = 0.0f;
    const int n_rows = counts[1 + rr];
    for (int ri = 0; ri < n_rows; ++ri) {
      const int r = row_list[rr * n_ty + ri];
      const int ty = row_ty[rr * n_ty + ri];
      const float* wrow = window + static_cast<size_t>(ty) * t;
      for (int ci = 0; ci < n_cols; ++ci) {
        const int jt = j - col_off[ci];  // float inside the tile row
        if (jt < 0 || jt >= tile_len) continue;
        const int cx = col_list[ci];
        const size_t tile = static_cast<size_t>(r) * n_tx + cx;
        const float* src = tiles + (tile * t + ty) * tile_len + jt;
        const int x0 = xs[cx];
        float v[kVec], w[kVec];
        unpack(*reinterpret_cast<const vec_t*>(src), v);
        if (kVec == 1 || kC == 1 || kC == 0) {
#pragma unroll
          for (int i = 0; i < kVec; ++i) w[i] = wrow[px[i] - x0];
        } else {
          // four floats of C >= 2 channels span two pixels at most
          const float wa = wrow[px[0] - x0];
          const float wb = wrow[px[kVec - 1] - x0];
#pragma unroll
          for (int i = 0; i < kVec; ++i) w[i] = px[i] == px[0] ? wa : wb;
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], w[i]));
          wsum[i] = __fadd_rn(wsum[i], w[i]);
        }
      }
    }
    float res[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) res[i] = acc[i] / fmaxf(wsum[i], 1e-8f);
    *reinterpret_cast<vec_t*>(out + static_cast<size_t>(y) * row_len + j) = pack(res);
  }
}

template <int kVec>
cudaError_t launch(const float* tiles, const float* window, const int* ys, const int* xs,
                   float* out, int n_ty, int n_tx, int t, int c, int out_h, int out_w,
                   cudaStream_t stream) {
  const int64_t row_len = static_cast<int64_t>(out_w) * c;
  const int64_t spans = (row_len + kThreads * kVec - 1) / (kThreads * kVec);
  const int64_t blocks = spans * ((out_h + kRows - 1) / kRows);
  const int64_t shared = 4 * (1 + kRows + 2 * static_cast<int64_t>(n_tx) + 2 * kRows * static_cast<int64_t>(n_ty));
  if (row_len > INT32_MAX || blocks > INT32_MAX || shared > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const size_t smem = static_cast<size_t>(shared);
  const int spr = static_cast<int>(spans);
  if (c == 3) {
    blend_tiles_kernel<kVec, 3><<<grid, kThreads, smem, stream>>>(tiles, window, ys, xs, out, n_ty,
                                                                  n_tx, t, c, out_h, out_w, spr);
  } else if (c == 1) {
    blend_tiles_kernel<kVec, 1><<<grid, kThreads, smem, stream>>>(tiles, window, ys, xs, out, n_ty,
                                                                  n_tx, t, c, out_h, out_w, spr);
  } else {
    blend_tiles_kernel<kVec, 0><<<grid, kThreads, smem, stream>>>(tiles, window, ys, xs, out, n_ty,
                                                                  n_tx, t, c, out_h, out_w, spr);
  }
  return cudaGetLastError();
}

}  // namespace

// vec: 4 launches the 16-byte variant (the caller vouches for the alignment
// rules above; the pointers and sizes are checked again here), 1 the scalar one.
extern "C" int irp_blend_tiles(const void* tiles, const void* window, const void* ys,
                               const void* xs, void* out, int n_ty, int n_tx, int t, int c,
                               int out_h, int out_w, int vec, void* stream) {
  if (n_ty <= 0 || n_tx <= 0 || t <= 0 || c <= 0 || out_h <= 0 || out_w <= 0) {
    return cudaErrorInvalidValue;
  }
  const auto* tp = static_cast<const float*>(tiles);
  const auto* wp = static_cast<const float*>(window);
  const auto* yp = static_cast<const int*>(ys);
  const auto* xp = static_cast<const int*>(xs);
  auto* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    const bool aligned = reinterpret_cast<uintptr_t>(tiles) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                         (static_cast<int64_t>(out_w) * c) % 4 == 0 &&
                         (static_cast<int64_t>(t) * c) % 4 == 0;
    if (!aligned) return cudaErrorMisalignedAddress;
    return static_cast<int>(launch<4>(tp, wp, yp, xp, op, n_ty, n_tx, t, c, out_h, out_w, s));
  }
  if (vec == 1) {
    return static_cast<int>(launch<1>(tp, wp, yp, xp, op, n_ty, n_tx, t, c, out_h, out_w, s));
  }
  return cudaErrorInvalidValue;
}
