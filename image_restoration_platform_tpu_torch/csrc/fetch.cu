// The engine's fetch on the card: one device-to-host copy of a call's packed
// outputs into pageable host memory, then the call's "fetched" event on the
// same stream, in one call that holds no Python interpreter lock.
//
// A copy into pageable memory returns only once it has completed, so an
// event recorded from Python after it would wait for the interpreter lock
// first, and the card's idle time until then would read as the fetch's.
// Recorded here, the event follows the copy at once: the interval from the
// call's "packed" event to this one is the copy alone. The stream is
// synchronised before returning, as PyTorch's own blocking copy does.

#include <cuda_runtime.h>

#include <cstddef>

extern "C" int irp_fetch(void* dst, const void* src, size_t nbytes, void* stream, void* fetched) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemcpyAsync(dst, src, nbytes, cudaMemcpyDeviceToHost, s);
    if (err == cudaSuccess) err = cudaEventRecord(static_cast<cudaEvent_t>(fetched), s);
    if (err == cudaSuccess) err = cudaStreamSynchronize(s);
    return static_cast<int>(err);
}
