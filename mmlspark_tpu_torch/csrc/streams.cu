// A CUDA stream of the process's own, outside PyTorch's stream pool.
//
// torch.cuda.Stream() hands out one of a fixed pool of streams per device,
// round robin, so two callers can get the same stream. A CUDA graph
// captured on a pooled stream can then meet another thread's launches and
// event records on that stream mid-capture ("operation not permitted on an
// event last recorded in a capturing stream"). core/graphs.capture_stream()
// captures on a stream made here instead, one per capturing thread, which
// nothing else is handed.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int mmlspark_stream_create(uint64_t* out) {
    cudaStream_t s = nullptr;
    const cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    *out = (uint64_t)(uintptr_t)s;
    return (int)e;
}
