// The engine's fetch on the card: one device-to-host copy of a call's packed
// outputs into a page-locked host block, then the call's "fetched" event on
// the same stream, in one call that holds no Python interpreter lock.
//
// Into page-locked memory the copy is a DMA that runs at the link's speed,
// with no staging through CUDA's own bounce buffer; the call returns once the
// stream has been synchronised, as PyTorch's own blocking copy does. The
// event is recorded here, right behind the copy, so that it does not wait
// for the interpreter lock: the interval from the call's "packed" event to
// this one is the copy alone. The caller owns the block and keeps it from
// any other copy until the host is done with its bytes (ops/cuda/fetch.py).

#include <cuda_runtime.h>

#include <cstddef>

extern "C" int irp_fetch(void* dst, const void* src, size_t nbytes, void* stream, void* fetched) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemcpyAsync(dst, src, nbytes, cudaMemcpyDeviceToHost, s);
    if (err == cudaSuccess) err = cudaEventRecord(static_cast<cudaEvent_t>(fetched), s);
    if (err == cudaSuccess) err = cudaStreamSynchronize(s);
    return static_cast<int>(err);
}
