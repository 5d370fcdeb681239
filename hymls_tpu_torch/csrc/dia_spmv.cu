// Offset-diagonal (DIA) sparse matrix-vector product for Hopper (sm_90a).
//
//   y[i] = sum_k bands[k * ld + i] * x[i + off_k],   x == 0 outside [0, n)
//
// Replaces the Pallas TPU kernel hymls_tpu/ops/pallas_spmv.py:_kernel
// (PallasDiaMatvec), which held the zero-padded x whole in VMEM and
// streamed the bands in 2048-wide tiles, each offset an aligned window
// load plus a sub-128 lane roll.  None of that carries over: here one
// thread computes one output row in a grid-stride loop; the band rows
// bands[k * ld + i] are read coalesced across the warp; x[i + off] is
// read through the caches with a bounds test that gives 0 outside
// [0, n), so no padded copy of x is ever made.  The sum runs in T, in
// band order (the order of DiaOperator.matvec_prepared), starting from 0.
//
// What bounds it on an H100: at the cavity64 shape (19 bands, n = 12288)
// the whole operand is (19 + 2) * 12288 * 4 B ~ 1 MB, which sits in the
// 50 MB L2, so one call is bound by launch latency (a few microseconds),
// not by bandwidth.  The plain torch version issues about 2k elementwise
// launches per matvec (a multiply and an add per band), so the single
// launch is the whole of the gain at this size.  For the bandwidth-bound
// regime (n of 1e6 and more) x would be staged in shared-memory tiles
// with a halo of max|off| so that each x element is read from device
// memory once instead of up to k times; that is later work.
//
// The offsets are passed by value in a fixed struct (48 is the band cap
// of make_operator), so the kernel needs no device array of offsets.
// Entry points return cudaGetLastError() of the launch; the Python
// wrapper raises on a nonzero value.  Launches go on the caller's stream
// and never synchronise.

#include <cuda_runtime.h>

#define HYMLS_DIA_MAX_BANDS 48

struct DiaOffsets {
    int v[HYMLS_DIA_MAX_BANDS];
    int k;
};

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ bands, long long ld,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long n, DiaOffsets offs) {
    const long long stride = (long long)blockDim.x * gridDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        T acc = T(0);
        for (int k = 0; k < offs.k; ++k) {
            const long long j = i + offs.v[k];
            const T xv = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
            acc += __ldg(bands + (long long)k * ld + i) * xv;
        }
        y[i] = acc;
    }
}

template <typename T>
static int launch(const void* bands, long long ld, const void* x, void* y,
                  long long n, const void* offsets, int k, void* stream) {
    if (k < 1 || k > HYMLS_DIA_MAX_BANDS || n < 0 || ld < n)
        return (int)cudaErrorInvalidValue;
    DiaOffsets offs;
    const int* off = static_cast<const int*>(offsets);
    for (int j = 0; j < k; ++j) offs.v[j] = off[j];
    for (int j = k; j < HYMLS_DIA_MAX_BANDS; ++j) offs.v[j] = 0;
    offs.k = k;
    if (n == 0) return (int)cudaSuccess;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    // 132 SMs x 16 resident blocks of 256 threads: beyond that the
    // grid-stride loop covers the rest
    const long long max_blocks = 132LL * 16;
    if (blocks > max_blocks) blocks = max_blocks;
    dia_spmv_kernel<T><<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(bands), ld, static_cast<const T*>(x),
        static_cast<T*>(y), n, offs);
    return (int)cudaGetLastError();
}

extern "C" {

int hymls_dia_spmv_f32(const void* bands, long long ld, const void* x,
                       void* y, long long n, const void* offsets, int k,
                       void* stream) {
    return launch<float>(bands, ld, x, y, n, offsets, k, stream);
}

int hymls_dia_spmv_f64(const void* bands, long long ld, const void* x,
                       void* y, long long n, const void* offsets, int k,
                       void* stream) {
    return launch<double>(bands, ld, x, y, n, offsets, k, stream);
}

}  // extern "C"
