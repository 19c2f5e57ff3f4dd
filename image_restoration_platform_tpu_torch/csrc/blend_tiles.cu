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
// the card the fold is a gather. One thread owns one float of the flattened
// [H, W*C] canvas, so consecutive threads read consecutive floats of the
// interleaved NHWC tile row and write consecutive floats of the canvas. It
// walks every tile row r with ys[r] <= y < ys[r] + T and, inside it, every tile
// column likewise: any number of them, in row-major tile order, which is the
// order the plain fold (ops/tile.py blend_tiles) adds them in. The products
// and sums are written with __fmul_rn / __fadd_rn, so nvcc cannot contract
// them into FMAs and the kernel repeats the plain fold's f32 arithmetic.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. At the main shape (81
// tiles of 512 x 512 x 3 onto 4096 x 4096 x 3) it must read 255 MB of tiles
// and write 201 MB, 0.136 ms at the memory rate, against 2 flops per tile
// element. The design reads each tile element once with coalesced 4-byte
// loads and writes each output once; the window (1 MB at T = 512) and the
// origin arrays stay in cache. Vector loads, shared-memory staging of the
// window and TMA are later work.
//
// C interface (loaded with ctypes): irp_blend_tiles returns the cudaError_t of
// the launch; it launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
blend_tiles_kernel(const float* __restrict__ tiles, const float* __restrict__ window,
                   const int* __restrict__ ys, const int* __restrict__ xs,
                   float* __restrict__ out, int n_ty, int n_tx, int t, int c, int out_w,
                   int chunks_per_row) {
  const int y = blockIdx.x / chunks_per_row;
  const int chunk = blockIdx.x - y * chunks_per_row;
  const int j = chunk * kThreads + threadIdx.x;  // index into the row's W*C floats
  const int row_len = out_w * c;
  if (j >= row_len) return;
  const int x = j / c;
  const int ch = j - x * c;

  float acc = 0.0f;
  float wsum = 0.0f;
  for (int r = 0; r < n_ty; ++r) {
    const int ty = y - ys[r];
    if (ty < 0 || ty >= t) continue;
    for (int cx = 0; cx < n_tx; ++cx) {
      const int tx = x - xs[cx];
      if (tx < 0 || tx >= t) continue;
      const float w = window[ty * t + tx];
      const size_t tile = static_cast<size_t>(r) * n_tx + cx;
      const float v = tiles[((tile * t + ty) * t + tx) * c + ch];
      acc = __fadd_rn(acc, __fmul_rn(v, w));
      wsum = __fadd_rn(wsum, w);
    }
  }
  out[static_cast<size_t>(y) * row_len + j] = acc / fmaxf(wsum, 1e-8f);
}

}  // namespace

extern "C" int irp_blend_tiles(const void* tiles, const void* window, const void* ys,
                               const void* xs, void* out, int n_ty, int n_tx, int t, int c,
                               int out_h, int out_w, void* stream) {
  if (n_ty <= 0 || n_tx <= 0 || t <= 0 || c <= 0 || out_h <= 0 || out_w <= 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t row_len = static_cast<int64_t>(out_w) * c;
  const int64_t chunks = (row_len + kThreads - 1) / kThreads;
  const int64_t blocks = chunks * out_h;
  if (row_len > INT32_MAX || blocks > INT32_MAX) return cudaErrorInvalidValue;
  blend_tiles_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tiles), static_cast<const float*>(window),
      static_cast<const int*>(ys), static_cast<const int*>(xs), static_cast<float*>(out), n_ty,
      n_tx, t, c, out_w, static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}
