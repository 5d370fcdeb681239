// Sentinel gather K3 for Hopper (sm_90a), f32 and f64.
//
//   out[b, i] = idx[i] == L ? 0 : src[b, idx[i]],   i < n, b < B
//
// src is (B, L) with element strides (sb, sl), idx holds n int64 offsets
// in [0, L], out is (B, n) contiguous.  L is the sentinel: the slot that
// the generic V-cycle's plans point at for "no entry", which the plain
// version `torch.cat([src, zeros(1)])[idx]` materialises as an appended
// zero.  Here the sentinel is a compare, so src is read in place: one
// launch where the plain version takes three (a 1-element fill, a copy
// of the whole of src and PyTorch's general advanced-index kernel).
//
// Replaces no TPU kernel.  The JAX package's gathers are XLA ops on the
// same appended-zero arrays (hymls_tpu/core/preconditioner.py); this
// kernel was added because on the H100 the generic apply's ~15 gathers
// a level were ~40% of the device time of the solves that run it, each
// a chain of three small kernels rather than bandwidth.
//
// What bounds it on an H100: bytes, 8 B of index + one element read +
// one written an output, but at the apply's sizes (<= 131k outputs,
// <= 2.4 MB) that is under a microsecond at 3.35 TB/s, so the launch's
// latency floor bounds it.  The design is for that floor: one thread an
// output, a grid sized to n alone, coalesced index loads, read-only
// (`__ldg`) source loads, and each thread walks the batch axis so that
// an index is loaded once for all B vectors of a block apply.  Indices
// outside [0, L] read nothing and give 0; the plans hold none, which
// core/preconditioner.py:finish_level_plan checks when a plan is built.
//
// Each entry point returns cudaGetLastError() of the launch; the Python
// wrapper raises on a nonzero value.  The launch goes on the caller's
// stream and never synchronises, so a CUDA-graph capture records it.

#include <cuda_runtime.h>
#include <stdint.h>

#define HYMLS_GATHER_THREADS 256

template <typename T>
__global__ void sentinel_gather_kernel(const T* __restrict__ src,
                                       const long long* __restrict__ idx,
                                       T* __restrict__ out, long long n,
                                       long long L, long long B,
                                       long long sb, long long sl) {
    const long long i =
        (long long)blockIdx.x * HYMLS_GATHER_THREADS + threadIdx.x;
    if (i >= n) return;
    const long long j = __ldg(idx + i);
    const bool hit = (unsigned long long)j < (unsigned long long)L;
    const T* s = src + (hit ? j : 0) * sl;
    for (long long b = 0; b < B; ++b)
        out[b * n + i] = hit ? __ldg(s + b * sb) : T(0);
}

template <typename T>
static int launch(const void* src, const void* idx, void* out, long long n,
                  long long L, long long B, long long sb, long long sl,
                  void* stream) {
    if (n < 0 || L < 0 || B < 0) return (int)cudaErrorInvalidValue;
    if (n == 0 || B == 0) return (int)cudaSuccess;
    const long long blocks =
        (n + HYMLS_GATHER_THREADS - 1) / HYMLS_GATHER_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    sentinel_gather_kernel<T><<<(unsigned)blocks, HYMLS_GATHER_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(src), static_cast<const long long*>(idx),
        static_cast<T*>(out), n, L, B, sb, sl);
    return (int)cudaGetLastError();
}

extern "C" {

int hymls_sentinel_gather_f32(const void* src, const void* idx, void* out,
                              long long n, long long L, long long B,
                              long long sb, long long sl, void* stream) {
    return launch<float>(src, idx, out, n, L, B, sb, sl, stream);
}

int hymls_sentinel_gather_f64(const void* src, const void* idx, void* out,
                              long long n, long long L, long long B,
                              long long sb, long long sl, void* stream) {
    return launch<double>(src, idx, out, n, L, B, sb, sl, stream);
}

}  // extern "C"
