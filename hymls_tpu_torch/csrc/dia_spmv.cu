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
// over a block of vectors.  What bounds it on an H100: the bands move
// once for the block, so the least traffic is (k * n + 2 * nvec * n) *
// sizeof(T) bytes at 3.35 TB/s.  The deflation setups' blocks (n = 1024
// to 16384, 5 bands, 5 to 16 vectors) fit in L2 many times over: there a
// call is bound by the launch and by how many dependent L2 round trips
// a thread waits.  What the design does about that:
//
//   * A grid of row tiles x vector groups: a thread takes one row of VB
//     vectors (VB = 1, 2, 4 or 8, a template parameter), so the warps in
//     flight grow by nvec / VB over one thread a row.  The 1-D grid runs
//     the group index fastest, so that the groups of one row tile run
//     together and, beyond L2, read the tile's bands from L2 after the
//     first group brought them from HBM.  A 1-D grid has no 65535 cap.
//   * A thread issues all its loads before its FMAs: the row's band
//     values and, for each band, the x values of its VB vectors.  A
//     group then waits about one L2 round trip, not one per vector.
//   * Registers bound VB: a thread holds about G (1 + VB) + VB values of
//     T for G bands a round.  spmm_vb_cap: VB up to 4 for up to 24
//     bands in f32 and 20 in f64, then 2, and 1 beyond 32 bands in f64,
//     whose buckets of 40 and 48 bands load in two rounds.  No instance
//     spills (ptxas: at most 223 registers, f64 with 20 bands and VB 4).
//     VB is the cap or the next power of two of nvec, if that is
//     smaller; a last group with fewer vectors is predicated, not padded.
//   * The block shrinks from 128 to 32 threads until the grid has two
//     blocks per SM, as for dia_spmv_kernel (from 256 there).
//
// Measured on an H100 (tools/dia_spmv_sweep.py, PERF.md Findings):
// VB 4 beat VB 8 at every timed shape and type (VB 8 halves the warps
// and nearly doubles the registers), and beat VB 2 at B = 12-14 but
// for one tie; VB 2 was up to 0.11 us faster at B = 6-8 in L2.  Blocks
// of 128 threads beat 256 beyond L2 (65.4 against 70.4 us, 5 bands,
// n = 2^20, B = 8, f64).
// Not tried: staging a tile's x windows in shared memory, which lost
// for dia_spmv_kernel at every shape.
//
// The launcher picks the instance (bucket, VB, rounds) and the block
// from the shapes alone (spmm_plan, exported as hymls_dia_spmm_plan so
// that a caller can list the instances it reaches).  The sum is
// dia_spmv_kernel's per (v, i): band order, from 0, one fused
// multiply-add per band, zero outside [0, n), so every row of Y equals a
// dia_spmv launch on that row of X bit for bit; the parallelism is only
// across rows and vectors.
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
// X[v * n + i + off_k] for the nvec rows of X (each a vector).  Block
// b takes row tile b / ngroups and vector group b % ngroups (the group
// fastest); a thread takes one row of the group's VB vectors.  Per round
// of G bands it issues the G band loads and the G * VB x loads, then the
// FMAs; each vector's sum is dia_spmv_kernel's (band order, from 0, one
// FMA per band, zero outside [0, n)), so every row of Y equals a
// dia_spmv launch on that row of X bit for bit.  Vectors past nvec in
// the last group are predicated off.  Indices are 32-bit (the launcher
// checks nvec * n < 2^31).
template <typename T, int KB, int VB, int ROUNDS>
__global__ void __launch_bounds__(kMaxThreads)
dia_spmm_kernel(const T* __restrict__ bands, int ld,
                const T* __restrict__ x, T* __restrict__ y, int n, int nvec,
                int ngroups, DiaOffsets offs) {
    const int tile = blockIdx.x / ngroups;
    const int v0 = (blockIdx.x - tile * ngroups) * VB;
    const int i = tile * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int nv = nvec - v0;            // vectors of this group: min(VB, nv)
    const T* xg = x + v0 * n;
    constexpr int G = (KB + ROUNDS - 1) / ROUNDS;
    T acc[VB];
#pragma unroll
    for (int v = 0; v < VB; ++v) acc[v] = T(0);
#pragma unroll
    for (int g0 = 0; g0 < KB; g0 += G) {
        T bv[G], xv[G][VB];
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int b = g0 + u;
            if (b < KB && b < offs.k) {
                bv[u] = __ldg(bands + (b * ld + i));
                const int c = i + offs.v[b];
                const bool in = c >= 0 && c < n;
#pragma unroll
                for (int v = 0; v < VB; ++v)
                    xv[u][v] = (in && v < nv) ? __ldg(xg + (v * n + c)) : T(0);
            }
        }
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int b = g0 + u;
            if (b < KB && b < offs.k) {
#pragma unroll
                for (int v = 0; v < VB; ++v)
                    acc[v] = fma_t(bv[u], xv[u][v], acc[v]);
            }
        }
        // keep the next round's loads behind this round's FMAs
        if (ROUNDS > 1) asm volatile("" ::: "memory");
    }
    T* yg = y + v0 * n + i;
#pragma unroll
    for (int v = 0; v < VB; ++v)
        if (v < nv) yg[v * n] = acc[v];
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

// The band bucket of k, as by_bucket picks it.
int bucket_of(int k) {
    return by_bucket(k, [](auto kb) { return decltype(kb)::value; });
}

// The multi-column kernel's largest VB for band bucket kb (see the
// note at the top).  HYMLS_SPMM_VB_CAP (a build flag) replaces it for
// every bucket, for side-by-side timing of the choices.
constexpr int spmm_vb_cap(int kb, bool f64) {
#ifdef HYMLS_SPMM_VB_CAP
    return (void)kb, (void)f64, HYMLS_SPMM_VB_CAP;
#else
    return f64 ? (kb <= 20 ? 4 : kb <= 32 ? 2 : 1) : (kb <= 24 ? 4 : 2);
#endif
}

// Rounds of the band loads: two for the f64 buckets of 40 and 48 bands,
// which one round would hold in about 200 registers (no timed shape has
// more than 19 bands).
constexpr int spmm_rounds(int kb, bool f64) {
    return f64 && kb > 32 ? 2 : 1;
}

// The multi-column kernel's largest block; a build flag may set it.
#ifndef HYMLS_SPMM_MAX_THREADS
#define HYMLS_SPMM_MAX_THREADS 128
#endif

// What the multi-column launcher runs for a shape: the instance (band
// bucket, VB, rounds) and the launch (threads a block, blocks).
struct SpmmPlan {
    int kb, vb, rounds, threads, blocks, ngroups;
};

SpmmPlan spmm_plan(int k, int n, int nvec, bool f64, int sms) {
    SpmmPlan p;
    p.kb = bucket_of(k);
    p.rounds = spmm_rounds(p.kb, f64);
    const int cap = spmm_vb_cap(p.kb, f64);
    p.vb = 1;
    while (p.vb < cap && p.vb < nvec) p.vb *= 2;
    p.ngroups = (nvec + p.vb - 1) / p.vb;
    // halved from the largest block until the grid has two blocks per SM
    p.threads = HYMLS_SPMM_MAX_THREADS;
    while (p.threads > kMinThreads &&
           (long long)((n + p.threads - 1) / p.threads) * p.ngroups < 2 * sms)
        p.threads /= 2;
    p.blocks = (n + p.threads - 1) / p.threads * p.ngroups;
    return p;
}

template <typename T, int KB, int VB>
int launch_spmm_vb(const T* bands, int ld, const T* x, T* y, int n,
                   int nvec, const DiaOffsets& offs, const SpmmPlan& p,
                   cudaStream_t stream) {
    constexpr int R = spmm_rounds(KB, sizeof(T) == 8);
    dia_spmm_kernel<T, KB, VB, R><<<p.blocks, p.threads, 0, stream>>>(
        bands, ld, x, y, n, nvec, p.ngroups, offs);
    return (int)cudaGetLastError();
}

// The instance of p.vb for bucket KB; only VB up to the bucket's cap is
// compiled.
template <typename T, int KB>
int launch_spmm_bucket(const T* bands, int ld, const T* x, T* y, int n,
                       int nvec, const DiaOffsets& offs, const SpmmPlan& p,
                       cudaStream_t stream) {
    constexpr int CAP = spmm_vb_cap(KB, sizeof(T) == 8);
    static_assert(CAP == 1 || CAP == 2 || CAP == 4 || CAP == 8,
                  "VB is 1, 2, 4 or 8");
    switch (p.vb) {
    case 8:
        if constexpr (CAP >= 8)
            return launch_spmm_vb<T, KB, 8>(bands, ld, x, y, n, nvec, offs,
                                            p, stream);
        break;
    case 4:
        if constexpr (CAP >= 4)
            return launch_spmm_vb<T, KB, 4>(bands, ld, x, y, n, nvec, offs,
                                            p, stream);
        break;
    case 2:
        if constexpr (CAP >= 2)
            return launch_spmm_vb<T, KB, 2>(bands, ld, x, y, n, nvec, offs,
                                            p, stream);
        break;
    case 1:
        return launch_spmm_vb<T, KB, 1>(bands, ld, x, y, n, nvec, offs, p,
                                        stream);
    }
    return (int)cudaErrorInvalidValue;
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
// element's index, and the block count, inside 32 bits
bool spmm_args_ok(int k, long long ld, long long n, long long nvec) {
    return args_ok(k, ld, n) && nvec >= 0 && nvec * n < (1LL << 31);
}

template <typename T>
int launch_spmm(const void* bands, long long ld, const void* x, void* y,
                long long n, long long nvec, const void* offsets, int k,
                void* stream) {
    if (!spmm_args_ok(k, ld, n, nvec)) return (int)cudaErrorInvalidValue;
    if (n == 0 || nvec == 0) return (int)cudaSuccess;
    const DiaOffsets offs = pack_offsets(offsets, k, n);
    const SpmmPlan p = spmm_plan(k, (int)n, (int)nvec, sizeof(T) == 8,
                                 sm_count());
    return by_bucket(k, [&](auto kb) {
        return launch_spmm_bucket<T, decltype(kb)::value>(
            static_cast<const T*>(bands), (int)ld, static_cast<const T*>(x),
            static_cast<T*>(y), (int)n, (int)nvec, offs, p,
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

// The multi-column launcher's choice for a shape, without a launch:
// out = {band bucket, VB, rounds, threads a block, blocks}.  dtype_bytes
// is 4 or 8; returns cudaErrorInvalidValue where a launch would.
int hymls_dia_spmm_plan(long long n, long long nvec, int k, int dtype_bytes,
                        int* out) {
    if (!spmm_args_ok(k, n, n, nvec) || (dtype_bytes != 4 && dtype_bytes != 8))
        return (int)cudaErrorInvalidValue;
    const SpmmPlan p = spmm_plan(k, (int)n, (int)(nvec > 0 ? nvec : 1),
                                 dtype_bytes == 8, sm_count());
    out[0] = p.kb;
    out[1] = p.vb;
    out[2] = p.rounds;
    out[3] = p.threads;
    out[4] = p.blocks;
    return (int)cudaSuccess;
}

}  // extern "C"
