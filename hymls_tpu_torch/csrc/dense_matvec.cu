// Dense matrix-vector product y = M x in f32 for Hopper (sm_90a).
//
//   y[i] = sum_j M[i * n + j] * x[j],   M row-major (n, n), x and y (n,)
//
// Replaces the Pallas TPU kernel tools/loop_pathology_bench.py:_mv_kernel
// (pl_matvec), which cut M into 256-row blocks, held x whole in VMEM and
// ran one MXU dot per block with an f32 accumulator.  Here one warp owns
// one row: its 32 lanes stride along the row (16-byte float4 loads when
// n % 4 == 0 and both operands are 16-byte aligned, scalar loads
// otherwise), each lane keeps an f32 partial sum with fused multiply-adds,
// and a butterfly of warp shuffles adds the 32 partials.  Every row is
// bounds-checked, so any n >= 1 is correct (the Pallas grid n // 256
// left rows unwritten when n was not a multiple of 256).
//
// What bounds it on an H100: a GEMV reads each of the n^2 matrix elements
// once and does one multiply-add with it, 0.5 FLOP per byte, far below
// the card's balance point, so it is bound by memory bandwidth: device
// memory (3.35 TB/s) when M is larger than the 50 MB L2, the L2 itself
// when M (16 MB at the probe's n = 2048) stays resident across a loop.
// The design's answer is wide coalesced loads and enough warps in flight
// (8 rows per 256-thread block, n / 8 blocks); x (8 KB at n = 2048) is
// re-read by every warp from L1/L2.  No tensor cores: there is no reuse
// of M for them to exploit.  TMA-staged tiles and an L2 persistence
// window are later work.
//
// The entry point returns cudaGetLastError() of the launch; the Python
// wrapper raises on a nonzero value.  The launch goes on the caller's
// stream and never synchronises, so a CUDA-graph capture records it.

#include <cuda_runtime.h>
#include <stdint.h>

#define HYMLS_MV_WARPS 8

template <bool VEC>
__global__ void dense_matvec_kernel(const float* __restrict__ M,
                                    const float* __restrict__ x,
                                    float* __restrict__ y, long long n) {
    const int lane = threadIdx.x & 31;
    const long long row =
        (long long)blockIdx.x * HYMLS_MV_WARPS + (threadIdx.x >> 5);
    if (row >= n) return;          // whole warp: the shuffles stay full
    const float* m = M + row * n;
    float acc = 0.0f;
    if (VEC) {
        const float4* m4 = reinterpret_cast<const float4*>(m);
        const float4* x4 = reinterpret_cast<const float4*>(x);
        const long long n4 = n >> 2;
#pragma unroll 4
        for (long long j = lane; j < n4; j += 32) {
            const float4 a = __ldg(m4 + j);
            const float4 b = __ldg(x4 + j);
            acc = fmaf(a.x, b.x, acc);
            acc = fmaf(a.y, b.y, acc);
            acc = fmaf(a.z, b.z, acc);
            acc = fmaf(a.w, b.w, acc);
        }
    } else {
        for (long long j = lane; j < n; j += 32)
            acc = fmaf(__ldg(m + j), __ldg(x + j), acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) y[row] = acc;
}

extern "C" {

int hymls_dense_matvec_f32(const void* M, const void* x, void* y,
                           long long n, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    const bool vec = (n % 4 == 0) &&
        (((uintptr_t)M | (uintptr_t)x) % 16 == 0);
    const long long blocks = (n + HYMLS_MV_WARPS - 1) / HYMLS_MV_WARPS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* Mf = static_cast<const float*>(M);
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    if (vec)
        dense_matvec_kernel<true><<<(unsigned)blocks, 32 * HYMLS_MV_WARPS,
                                    0, s>>>(Mf, xf, yf, n);
    else
        dense_matvec_kernel<false><<<(unsigned)blocks, 32 * HYMLS_MV_WARPS,
                                     0, s>>>(Mf, xf, yf, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
