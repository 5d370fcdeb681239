"""K1's multi-column form (`dia_matmat`) on the CPU: the sweep tool's
bound, the wrapper's limits and the plain version against the JAX
package.

The kernel itself runs only on a card (tests/test_torch_batched.py
`test_cuda_dia_matmat_kernel`, chip_smoke.py phase 3).  Here:

  * `dia_spmv_sweep.bound_mm`, the least time of one product, at stated
    shapes against the bytes counted by hand: the bands once, X and Y
    once, at 3.35 TB/s (2 k n B flops at the type's peak never bind at
    these shapes);
  * `dia_matmat_packed` raises on each limit of the kernel's 32-bit
    indices (n < 2^30, k n < 2^31, B n < 2^31), shown on tensors without
    storage (device "meta"), and passes a shape just inside them on to
    the device check.  The launcher's grid is 1-D (row tiles x vector
    groups), whose 2^31 - 1 blocks B n < 2^31 never reaches, so it adds
    no limit of its own;
  * the plain version, through the port's `DiaOperator.matvec_prepared`
    on a (B, n) block, against `jax.vmap` of the JAX package's
    `DiaOperator.matvec_prepared` at B = 1 and 17: 1e-13 relative in f64
    and 1e-5 in f32 (XLA may fuse a product into its sum), and each row
    equal to the single-vector plain version bit for bit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hymls_tpu.ops import spmv as jspmv
from hymls_tpu_torch.ops import spmv as tspmv
from hymls_tpu_torch.ops.dia_spmv import (DiaOffsets, dia_matmat_packed,
                                          dia_matvec_reference)
from hymls_tpu_torch.stencils import stokes3d
from hymls_tpu_torch.tools.dia_spmv_sweep import (HBM_BYTES_PER_S,
                                                  MATMAT_SWEEP, bound_mm,
                                                  matmat_matrix)

from _torch_parity import aniso_laplace, rel


@pytest.mark.parametrize("n, k, nvec, dt, us", [
    # aniso128 (phase 18's operator), B = 8, f64: 21 n doubles
    (16384, 5, 8, torch.float64, 21 * 16384 * 8 / 3.35e12 * 1e6),
    # aniso1024, beyond L2: 176 MB, about 52.6 us
    (1 << 20, 5, 8, torch.float64, 21 * (1 << 20) * 8 / 3.35e12 * 1e6),
    # stokes3d(16,16,16), 19 bands, B = 14, f32
    (16384, 19, 14, torch.float32, 47 * 16384 * 4 / 3.35e12 * 1e6),
], ids=["aniso128_B8_f64", "aniso1024_B8_f64", "stokes3d16_B14_f32"])
def test_matmat_bound(n, k, nvec, dt, us):
    ms, by = bound_mm(n, k, nvec, dt)
    assert by == "bytes"
    assert ms * 1e3 == pytest.approx(us, rel=1e-12)
    assert HBM_BYTES_PER_S == 3.35e12


def test_matmat_sweep_shapes():
    """The sweep's multi-column shapes: phase 18's and 19's operators,
    the 5-band one beyond the 50 MB L2 in f64 and the 19-band 3-D
    Stokes operator."""
    sizes = {}
    for name, blocks in MATMAT_SWEEP:
        if name == "aniso1024":
            sizes[name] = (1 << 20, 5)     # not built here: 1M rows
            continue
        K = matmat_matrix(name)
        sizes[name] = (K.shape[0], len(np.unique(
            K.tocoo().col - K.tocoo().row)))
        assert len(blocks) == 2 and blocks[0] < blocks[1]
    assert sizes == {"aniso128": (16384, 5), "neumann128": (16384, 5),
                     "aniso1024": (1 << 20, 5), "stokes3d16": (16384, 19)}
    n, k = sizes["aniso1024"]
    assert (k * n + 2 * 8 * n) * 8 > 50e6 * 3


def _meta(k, nvec, n):
    return (torch.empty((k, n), dtype=torch.float64, device="meta"),
            torch.empty((nvec, n), dtype=torch.float64, device="meta"))


@pytest.mark.parametrize("k, nvec, n", [
    (1, 1, 1 << 30),          # n < 2^30 rows
    (8, 1, 1 << 28),          # k n < 2^31 band elements
    (5, 1 << 11, 1 << 20),    # B n < 2^31 vector elements
    (3, 4, 1 << 29),          # B n, with k n inside its limit
], ids=["rows", "bands", "vectors", "vectors_at_large_n"])
def test_matmat_packed_limits(k, nvec, n):
    bands, X = _meta(k, nvec, n)
    with pytest.raises(ValueError, match="32-bit indices"):
        dia_matmat_packed(bands, X, DiaOffsets(range(k)))


def test_matmat_packed_inside_limits():
    """Just inside every limit the wrapper goes on to the device, which
    it refuses for a tensor that is not on the CPU or a card."""
    k, nvec, n = 5, (1 << 11) - 1, 1 << 20
    bands, X = _meta(k, nvec, n)
    with pytest.raises(ValueError, match="unsupported device meta"):
        dia_matmat_packed(bands, X, DiaOffsets(range(k)))


@pytest.mark.parametrize("nvec", [1, 17], ids=["B1", "B17"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("matrix", ["aniso13", "stokes3d4"])
def test_matmat_reference_matches_jax_vmap(matrix, dt, nvec):
    tdt, jdt, tol = {"f32": (torch.float32, jnp.float32, 1e-5),
                     "f64": (torch.float64, jnp.float64, 1e-13)}[dt]
    K = aniso_laplace(13) if matrix == "aniso13" else \
        stokes3d(4, 4, 4).tocsr()
    n = K.shape[0]
    X = np.random.default_rng(nvec).standard_normal((nvec, n))
    jop = jspmv.DiaOperator(K, dtype=jdt)
    pj = jop.prepare(jop.vals)
    Yj = np.asarray(jax.vmap(lambda x: jop.matvec_prepared(pj, x))(
        jnp.asarray(X, jdt)))
    top = tspmv.DiaOperator(K, dtype=tdt, device="cpu")
    bands = top.prepare(top.vals)
    Xt = torch.as_tensor(X, dtype=tdt)
    Y = top.matvec_prepared(bands, Xt)
    assert Y.shape == (nvec, n) and Y.dtype == tdt
    assert rel(Yj, Y.numpy()) <= tol
    for j in range(nvec):
        assert torch.equal(Y[j], dia_matvec_reference(bands, Xt[j],
                                                      top.offsets))


def test_ptxas_report_names_instances():
    """The build's ptxas report, per kernel instance: template instances
    by kernel name and arguments, registers and spill bytes."""
    from hymls_tpu_torch.ops import _build
    spmm = ("_ZN44_GLOBAL__N__3353134b_11_dia_spmv_cu_617379fa15dia_spmm_"
            "kernelIdLi8ELi4ELi1EEEvPKT_iS3_PS1_iii10DiaOffsets")
    spmv = "_ZN12_GLOBAL__N_115dia_spmv_kernelIfLi48ELi2EEEvPKT_iS3_PS1_i"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{spmm}' for 'sm_90a'",
        f"ptxas info    : Function properties for {spmm}",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 0 barriers, 620 bytes "
        "cmem[0]",
        f"ptxas info    : Compiling entry function '{spmv}' for 'sm_90a'",
        f"ptxas info    : Function properties for {spmv}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_Z6mv_kerPKf' for "
        "'sm_90a'",
        "ptxas info    : Used 30 registers"])
    _build.BUILD_LOG["_test_report"] = log
    try:
        assert _build.ptxas_report("_test_report") == {
            "dia_spmm_kernel<double,8,4,1>": (168, 8, 4),
            "dia_spmv_kernel<float,48,2>": (40, 0, 0),
            "_Z6mv_kerPKf": (30, 0, 0)}
        assert _build.ptxas_report("not built") == {}
    finally:
        del _build.BUILD_LOG["_test_report"]


# -- the CUDA source, emulated on the host ----------------------------------

_MOCK_CUDA = r"""
#pragma once
#include <cmath>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* nb, F, int, int) { *nb = 4; return cudaSuccess; }
struct Dim { int x; };
static Dim blockIdx, blockDim, threadIdx;
template <class T> inline T __ldg(const T* p) { return *p; }
// a launch: every block and thread in turn
template <class F> void emulate(int blocks, int threads, int, cudaStream_t,
                                F f) {
  blockDim.x = threads;
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = b; threadIdx.x = t; f(); }
}
"""

_DRIVER = r"""
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>
template <class T, class FV, class FM>
int check(FV spmv, FM spmm, std::mt19937& g) {
  std::normal_distribution<double> N;
  int bad = 0;
  for (int k : {1, 3, 5, 8, 13, 19, 24, 33, 48})
    for (long long n : {1LL, 37LL, 300LL})
      for (long long B : {1LL, 2LL, 3LL, 5LL, 8LL, 11LL, 17LL}) {
        std::vector<int> off(k);
        std::uniform_int_distribution<int> U(-(int)n - 3, (int)n + 3);
        for (auto& o : off) o = U(g);
        std::vector<T> bands(k * n), X(B * n), Y(B * n, T(7)), y(n);
        for (auto& v : bands) v = (T)N(g);
        for (auto& v : X) v = (T)N(g);
        if (spmm(bands.data(), n, X.data(), Y.data(), n, B, off.data(), k,
                 nullptr)) return -1;
        for (int v = 0; v < B; ++v) {
          spmv(bands.data(), n, X.data() + v * n, y.data(), n, off.data(),
               k, nullptr);
          bad += memcmp(y.data(), Y.data() + v * n, n * sizeof(T)) != 0;
        }
      }
  return bad;
}
int main() {
  std::mt19937 g(3);
  int bad32 = check<float>(hymls_dia_spmv_f32, hymls_dia_spmm_f32, g);
  int bad64 = check<double>(hymls_dia_spmv_f64, hymls_dia_spmm_f64, g);
  int out[5];
  int limit = hymls_dia_spmm_plan(1 << 20, 2048, 5, 8, out);
  int inside = hymls_dia_spmm_plan(1 << 20, 2047, 5, 8, out);
  printf("%d %d %d %d %d %d %d %d %d\n", bad32, bad64, limit, inside,
         out[0], out[1], out[2], out[3], out[4]);
}
"""


@pytest.mark.parametrize("flags, vb", [
    ([], 4),
    (["-DHYMLS_SPMM_VB_CAP=1"], 1),
    (["-DHYMLS_SPMM_VB_CAP=8", "-DHYMLS_SPMM_MAX_THREADS=256"], 8),
], ids=["default", "vb1", "vb8_t256"])
def test_kernel_source_emulated_on_the_host(tmp_path, flags, vb):
    """csrc/dia_spmv.cu compiled by g++ against a stand-in for the CUDA
    runtime, each launch run block by block and thread by thread: for 9
    band counts (random offsets within and beyond n), ragged n and 7
    block sizes, in f32 and f64, every row of the multi-column kernel
    equals the single-vector kernel on that row bit for bit (both sum
    with IEEE fma, here std::fma), under the default launcher and under
    the build flags the sweep compares; the plan refuses B n = 2^31 and
    takes 2^31 - 2^20.  This holds the kernels' index arithmetic and
    predication, not their speed or the device compiler."""
    import re
    import shutil
    import subprocess
    from hymls_tpu_torch.ops import _build
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = open(f"{_build.CSRC}/dia_spmv.cu").read()
    src, launches = re.subn(
        r"(dia_s\w+_kernel<[^>]*>)<<<([^>]*)>>>\(([^;]*)\);",
        lambda m: f"emulate({m.group(2)}, [&] {{ {m.group(1)}"
                  f"({m.group(3)}); }});", src, flags=re.S)
    assert launches == 2
    src = src.replace('asm volatile("" ::: "memory");', ";")
    (tmp_path / "cuda_runtime.h").write_text(_MOCK_CUDA)
    (tmp_path / "emulated.cpp").write_text(src + _DRIVER)
    exe = tmp_path / "emulated"
    subprocess.run(["g++", "-std=c++17", "-O1", "-I", str(tmp_path),
                    *flags, "-o", str(exe), str(tmp_path / "emulated.cpp")],
                   check=True, capture_output=True, timeout=240)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, timeout=240).stdout.split()
    bad32, bad64, limit, inside, *plan = map(int, out)
    assert (bad32, bad64) == (0, 0)
    assert limit == 1 and inside == 0          # cudaErrorInvalidValue, ok
    bucket, plan_vb, rounds, threads, blocks = plan
    assert (bucket, plan_vb, rounds) == (8, vb, 1)
    assert blocks == -(-(1 << 20) // threads) * -(-2047 // vb)
