// Offset-diagonal (DIA) sparse matrix-vector product for Hopper (sm_90a).
//
//   y[i] = sum_k bands[k * ld + i] * x[i + off_k],   x == 0 outside [0, n)
//
// Replaces the Pallas TPU kernel hymls_tpu/ops/pallas_spmv.py:_kernel
// (PallasDiaMatvec), which held the zero-padded x whole in VMEM and
// streamed the bands in 2048-wide tiles, each offset an aligned window
// load plus a sub-128 lane roll.  Only the idea carries over: stream the
// bands once, read x from fast memory.
//
// What bounds it on an H100: every band element is used once, so the
// least traffic is (k + 2) * n * sizeof(T) bytes (bands, x and y once
// each) at 3.35 TB/s; 2k flops per row are far below any FLOP bound.
// Below about 50 MB the operand stays in L2 between calls, and a call is
// bound by launch and by the latency of its loads; above it, by HBM
// bandwidth.  What the design does about that:
//
//   * One thread per row, and every load of a thread in flight at once.
//     The band count is a template parameter, rounded up to a bucket (4,
//     8, ..., 24, 32, 40, 48; bands past k are predicated off), so the
//     band loop unrolls: a thread issues all its band and x loads, then
//     does its FMAs.  An L2-resident call then waits on about one L2
//     round trip, not one per band or two.
//   * The grid fills the card: at small n the launcher halves the block
//     (256 down to 32 threads) until there are two blocks per SM.  In f64
//     the one-round kernel holds about 2k live doubles a thread; where
//     its grid does not fit on the card at once (occupancy API), the
//     loads go in two rounds, which halves the registers.
//   * 32-bit index arithmetic (n < 2^30, k * n < 2^31): on an H100 it
//     keeps the sweep's 3-D shape (stokes3d32, f32) at 3.5-3.7 us per
//     launch, against 3.8-3.9 us with 64-bit band offsets; at the other
//     shapes the two differ by at most 3%, either way.
//   * x is read through L1 (__ldg): neighbouring offsets of a stencil
//     touch the same lines across a warp, and each line comes from L2
//     about once per block and cluster of offsets.
//
// Measured and left out (PERF.md, Findings): staging x in shared memory
// once per block and cluster of offsets (cp.async, then a barrier) was
// slower at every shape of chip_smoke.py's sweep, since the copy and the
// barrier add a dependent round trip and beyond L2 the bands' stream
// dominates; 16-byte band loads with 4 (f32) or 2 (f64) rows a thread
// were slower too, since the x loads then stride 16 bytes across a warp
// and the registers cut the resident warps.
//
// Sum order: per row, in band order (the order of the offsets as given,
// as DiaOperator.matvec_prepared), from 0, one fused multiply-add per
// band.  The plain version rounds each product first, so the two agree
// to a few units of the last place of the largest partial sum.
//
// The multi-column form (hymls_dia_spmm_*, dia_spmm_kernel):
//
//   Y[v, i] = sum_k bands[k * ld + i] * X[v, i + off_k],   X, Y (nvec, n)
//
// replaces PallasDiaMatvec under jax.vmap: the JAX package's batched
// deflation setup (hymls_tpu/solvers/deflation.py:102 and
// hymls_tpu/solvers/solver.py:518-519) maps DiaOperator.matvec_prepared
// over a block of vectors.  Its least traffic is (k * n + 2 * nvec * n)
// * sizeof(T) bytes at 3.35 TB/s: the bands move once for the whole
// block, where nvec launches of the single-vector kernel move them nvec
// times.  A simple design: one thread per row keeps the row's band
// values in registers and loops over the vectors, summing each exactly
// as dia_spmv_kernel does, so that each row of Y equals a single-vector
// launch on that row of X bit for bit.
//
// The offsets are passed by value in a fixed struct (48 is the band cap
// of make_operator), so the kernel needs no device array of offsets.
// Entry points return cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for arguments out of range); the Python wrapper
// raises on a nonzero value.  Launches go on the caller's stream, never
// synchronise and allocate nothing, so they can be captured in a CUDA
// graph.

#include <cuda_runtime.h>

#include <type_traits>

#define HYMLS_DIA_MAX_BANDS 48

namespace {

constexpr int kMaxThreads = 256;  // threads per block at large n
constexpr int kMinThreads = 32;

struct DiaOffsets {
    int v[HYMLS_DIA_MAX_BANDS];
    int k;
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
}

// One thread per row.  KB: the band bucket (bands b >= offs.k are
// skipped); ROUNDS: the bands' loads go out in this many rounds, each
// issued whole before its FMAs.  Indices are 32-bit (the launcher
// checks k * ld < 2^31).
template <typename T, int KB, int ROUNDS>
__global__ void __launch_bounds__(kMaxThreads)
dia_spmv_kernel(const T* __restrict__ bands, int ld,
                const T* __restrict__ x, T* __restrict__ y, int n,
                DiaOffsets offs) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    constexpr int G = (KB + ROUNDS - 1) / ROUNDS;
    T acc = T(0);
#pragma unroll
    for (int g0 = 0; g0 < KB; g0 += G) {
        T bv[G], xv[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int b = g0 + u;
            if (b < KB && b < offs.k) {
                bv[u] = __ldg(bands + (b * ld + i));
                const int c = i + offs.v[b];
                xv[u] = (c >= 0 && c < n) ? __ldg(x + c) : T(0);
            }
        }
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int b = g0 + u;
            if (b < KB && b < offs.k) acc = fma_t(bv[u], xv[u], acc);
        }
        // keep the next round's loads behind this round's FMAs
        if (ROUNDS > 1) asm volatile("" ::: "memory");
    }
    y[i] = acc;
}

// The multi-column form: Y[v * n + i] = sum_k bands[k * ld + i] *
// X[v * n + i + off_k] for the nvec rows of X (each a vector).  One
// thread per row: its band values are loaded once into registers, then
// each vector is summed as dia_spmv_kernel sums it (band order, from 0,
// one FMA per band, zero outside [0, n)), so that every row of Y equals
// a dia_spmv launch on that row of X bit for bit.  Indices are 32-bit
// (the launcher checks nvec * n < 2^31).
template <typename T, int KB>
__global__ void __launch_bounds__(kMaxThreads)
dia_spmm_kernel(const T* __restrict__ bands, int ld,
                const T* __restrict__ x, T* __restrict__ y, int n, int nvec,
                DiaOffsets offs) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    T bv[KB];
#pragma unroll
    for (int b = 0; b < KB; ++b)
        if (b < offs.k) bv[b] = __ldg(bands + (b * ld + i));
#pragma unroll 1
    for (int v = 0; v < nvec; ++v) {
        const T* xv = x + v * n;
        T acc = T(0);
#pragma unroll
        for (int b = 0; b < KB; ++b) {
            if (b < offs.k) {
                const int c = i + offs.v[b];
                const T xb = (c >= 0 && c < n) ? __ldg(xv + c) : T(0);
                acc = fma_t(bv[b], xb, acc);
            }
        }
        y[v * n + i] = acc;
    }
}

// SMs of the current device, queried once per device
int sm_count() {
    static int cache[64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) dev = 0;
    int& sms = cache[dev & 63];
    if (sms == 0 &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
        sms = 132;
    return sms;
}

// Threads per block: halved from 256 until the grid has two blocks per
// SM, down to one warp.
int block_threads(int n, int sms) {
    int threads = kMaxThreads;
    while (threads > kMinThreads && (n + threads - 1) / threads < 2 * sms)
        threads /= 2;
    return threads;
}

template <typename T, int KB, int ROUNDS>
int launch_kernel(const T* bands, int ld, const T* x, T* y, int n,
                  const DiaOffsets& offs, int threads, int blocks,
                  cudaStream_t stream) {
    dia_spmv_kernel<T, KB, ROUNDS><<<blocks, threads, 0, stream>>>(
        bands, ld, x, y, n, offs);
    return (int)cudaGetLastError();
}

// Blocks of dia_spmv_kernel<T, KB, 1> that fit on one SM at `threads`
// threads each (cached per block size; 0 if the query fails).
template <typename T, int KB>
int resident_blocks(int threads) {
    static int cache[4] = {-1, -1, -1, -1};   // 32, 64, 128, 256 threads
    int slot = threads == 32 ? 0 : threads == 64 ? 1 : threads == 128 ? 2 : 3;
    if (cache[slot] < 0) {
        int nb = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &nb, dia_spmv_kernel<T, KB, 1>, threads, 0) != cudaSuccess)
            nb = 0;
        cache[slot] = nb;
    }
    return cache[slot];
}

template <typename T, int KB>
int launch_bucket(const T* bands, int ld, const T* x, T* y, int n,
                  const DiaOffsets& offs, cudaStream_t stream) {
    const int sms = sm_count();
    const int threads = block_threads(n, sms);
    const int blocks = (n + threads - 1) / threads;
    // all loads in one round, except in f64 where the grid does not fit
    // on the card at once: there two rounds halve the registers and let
    // more of the grid be resident (in f32 one round measured as fast at
    // every size)
    if constexpr (sizeof(T) == 8) {
        if ((long long)blocks > (long long)resident_blocks<T, KB>(threads) * sms)
            return launch_kernel<T, KB, 2>(bands, ld, x, y, n, offs, threads,
                                           blocks, stream);
    }
    return launch_kernel<T, KB, 1>(bands, ld, x, y, n, offs, threads, blocks,
                                   stream);
}

template <typename T, int KB>
int launch_spmm_bucket(const T* bands, int ld, const T* x, T* y, int n,
                       int nvec, const DiaOffsets& offs, cudaStream_t stream) {
    const int threads = block_threads(n, sm_count());
    dia_spmm_kernel<T, KB><<<(n + threads - 1) / threads, threads, 0,
                             stream>>>(bands, ld, x, y, n, nvec, offs);
    return (int)cudaGetLastError();
}

// Calls f(std::integral_constant<int, KB>) for the band bucket KB of k.
template <typename F>
int by_bucket(int k, F&& f) {
    using std::integral_constant;
    if (k <= 4) return f(integral_constant<int, 4>{});
    if (k <= 8) return f(integral_constant<int, 8>{});
    if (k <= 12) return f(integral_constant<int, 12>{});
    if (k <= 16) return f(integral_constant<int, 16>{});
    if (k <= 20) return f(integral_constant<int, 20>{});
    if (k <= 24) return f(integral_constant<int, 24>{});
    if (k <= 32) return f(integral_constant<int, 32>{});
    if (k <= 40) return f(integral_constant<int, 40>{});
    return f(integral_constant<int, 48>{});
}

// The offsets as the kernels take them.  A band wholly outside [0, n)
// reads only zeros; clamping keeps i + off inside 32 bits.
DiaOffsets pack_offsets(const void* offsets, int k, long long n) {
    DiaOffsets offs;
    const int* off = static_cast<const int*>(offsets);
    for (int j = 0; j < k; ++j)
        offs.v[j] = off[j] < -n ? (int)-n : off[j] > n ? (int)n : off[j];
    for (int j = k; j < HYMLS_DIA_MAX_BANDS; ++j) offs.v[j] = 0;
    offs.k = k;
    return offs;
}

// 32-bit indices: n < 2^30 keeps i + off (|off| clamped to n) and
// k * ld < 2^31 every band element in range
bool args_ok(int k, long long ld, long long n) {
    return k >= 1 && k <= HYMLS_DIA_MAX_BANDS && n >= 0 && ld >= n &&
           n < (1LL << 30) && (long long)k * ld < (1LL << 31);
}

template <typename T>
int launch(const void* bands, long long ld, const void* x, void* y,
           long long n, const void* offsets, int k, void* stream) {
    if (!args_ok(k, ld, n)) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    const DiaOffsets offs = pack_offsets(offsets, k, n);
    return by_bucket(k, [&](auto kb) {
        return launch_bucket<T, decltype(kb)::value>(
            static_cast<const T*>(bands), (int)ld, static_cast<const T*>(x),
            static_cast<T*>(y), (int)n, offs,
            static_cast<cudaStream_t>(stream));
    });
}

// x and y are (nvec, n) row-major; nvec * n < 2^31 keeps every vector
// element's index inside 32 bits
template <typename T>
int launch_spmm(const void* bands, long long ld, const void* x, void* y,
                long long n, long long nvec, const void* offsets, int k,
                void* stream) {
    if (!args_ok(k, ld, n) || nvec < 0 || nvec * n >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (n == 0 || nvec == 0) return (int)cudaSuccess;
    const DiaOffsets offs = pack_offsets(offsets, k, n);
    return by_bucket(k, [&](auto kb) {
        return launch_spmm_bucket<T, decltype(kb)::value>(
            static_cast<const T*>(bands), (int)ld, static_cast<const T*>(x),
            static_cast<T*>(y), (int)n, (int)nvec, offs,
            static_cast<cudaStream_t>(stream));
    });
}

}  // namespace

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

int hymls_dia_spmm_f32(const void* bands, long long ld, const void* x,
                       void* y, long long n, long long nvec,
                       const void* offsets, int k, void* stream) {
    return launch_spmm<float>(bands, ld, x, y, n, nvec, offsets, k, stream);
}

int hymls_dia_spmm_f64(const void* bands, long long ld, const void* x,
                       void* y, long long n, long long nvec,
                       const void* offsets, int k, void* stream) {
    return launch_spmm<double>(bands, ld, x, y, n, nvec, offsets, k, stream);
}

}  // extern "C"
