"""The port's batched deflation setup against the JAX package's two
`jax.vmap` programs (f64, CPU).

The JAX package runs the subspace iteration's block apply as
`jax.vmap(apply_col)` (hymls_tpu/solvers/deflation.py:102) and the k
projected setup solves as `jax.vmap` of one GMRES solve
(hymls_tpu/solvers/solver.py:518-519); the DIA products inside them are
`jax.vmap` of `DiaOperator.matvec_prepared`.  The port writes the batch
axis out: `dia_matmat` (K1's multi-column form), the V-cycle on a
(B, n) block, and `krylov.gmres_batched`.  Tolerances:

  * `dia_matmat_reference` equals `dia_matvec_reference` row by row bit
    for bit (the same elementwise operations in the same order); against
    the JAX package's vmapped DIA product 1e-13 relative in f64 and, on
    K1's Pallas kernel under `jax.vmap` in interpret mode, 1e-5 in f32
    (another summation order);
  * the block V-cycle agrees with per-column applies to 1e-13 relative
    (batched GEMMs sum in another order than GEMVs, a few ulp), and with
    `jax.vmap` of the JAX package's apply to 1e-12 (XLA's and torch's
    products round differently; the factors agree to ~1e-14);
  * `gmres_batched` takes each column's iteration count of
    `jax.vmap(krylov.gmres)` exactly and gives x to 1e-10 relative (the
    solves run to 1e-10);
  * a counter on the wrappers shows that the setup makes (it + 1) block
    applies and one multi-column DIA product per batched iteration.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import hymls_tpu as H
import hymls_tpu_torch as T
from hymls_tpu.ops import spmv as jspmv
from hymls_tpu.ops.pallas_spmv import HAVE_PALLAS, PallasDiaMatvec
from hymls_tpu.solvers import krylov as jkrylov
from hymls_tpu_torch.core.preconditioner import Preconditioner
from hymls_tpu_torch.ops import spmv as tspmv
from hymls_tpu_torch.ops.operators import projected_operator
from hymls_tpu_torch.ops.dia_spmv import (DiaOffsets, dia_matmat,
                                          dia_matmat_packed,
                                          dia_matmat_reference,
                                          dia_matvec_reference)
from hymls_tpu_torch.solvers import krylov as tkrylov
from hymls_tpu_torch.stencils import (create_nullspace, create_testvector,
                                      laplace2d_neumann, stokes3d)

from _torch_parity import (aniso_laplace, laplace_cfg, pair, problem,
                           ref_apply, ref_generic, rel)
from test_torch_bgrid import _cfg as _bgrid_cfg

BLOCK_VS_COLUMNS = 1e-13   # batched GEMMs against GEMVs
BLOCK_VS_REFERENCE = 1e-12  # against jax.vmap of the JAX package's apply
X_TOL = 1e-10              # the projected solves run to 1e-10


def _rows(n, b, seed):
    return np.random.default_rng(seed).standard_normal((b, n))


# -- K1's multi-column form -------------------------------------------------

@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("offsets", [(-3, 0, 2), (-40, -5, -1, 0, 1, 3, 37, 50),
                                     (0,), (-37, 37)],
                         ids=["stencil", "beyond_n", "diagonal", "at_n"])
def test_dia_matmat_reference_equals_rows(offsets, dt):
    """Negative, zero and beyond-n offsets (n = 37): each row of the
    plain multi-column product equals the plain single-vector product of
    that row bit for bit, and the public call equals the packed one."""
    n, b = 37, 6
    rng = np.random.default_rng(4)
    bands = torch.as_tensor(rng.standard_normal((len(offsets), n)), dtype=dt)
    X = torch.as_tensor(rng.standard_normal((b, n)), dtype=dt)
    Y = dia_matmat_reference(bands, X, offsets)
    assert Y.shape == (b, n) and Y.dtype == dt
    for j in range(b):
        assert torch.equal(Y[j], dia_matvec_reference(bands, X[j], offsets))
    before = dia_matmat.launches
    assert torch.equal(dia_matmat(bands, X, offsets), Y)
    assert torch.equal(dia_matmat_packed(bands, X, DiaOffsets(offsets)), Y)
    assert dia_matmat.launches == before      # no launch on the CPU


def test_dia_matmat_checks():
    offs = DiaOffsets((-1, 0, 1))
    bands, X = torch.zeros((3, 8)), torch.zeros((2, 8))
    with pytest.raises(ValueError):
        dia_matmat_packed(bands, X[0], offs)             # not a block
    with pytest.raises(ValueError):
        dia_matmat_packed(bands[:2], X, offs)            # band count
    with pytest.raises(ValueError):
        dia_matmat_packed(bands, torch.zeros((8, 2)).T, offs)
    with pytest.raises(TypeError):
        dia_matmat_packed(bands, X.double(), offs)
    assert torch.equal(dia_matmat_packed(bands, torch.zeros((0, 8)), offs),
                       torch.zeros((0, 8)))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_dia_block_matches_vmapped_reference(dt):
    """The operators of the deflation setup on a block: the port's
    `DiaOperator` and `EllOperator` against `jax.vmap` of the JAX
    package's `matvec_prepared`; in f32 also against K1's Pallas kernel
    under `jax.vmap` in interpret mode."""
    tdt, jdt, tol = {"f32": (torch.float32, jnp.float32, 1e-5),
                     "f64": (torch.float64, jnp.float64, 1e-13)}[dt]
    K = aniso_laplace(16)
    X = _rows(K.shape[0], 5, 1)
    jop = jspmv.DiaOperator(K, dtype=jdt)
    pj = jop.prepare(jop.vals)
    Yj = np.asarray(jax.vmap(lambda x: jop.matvec_prepared(pj, x))(
        jnp.asarray(X, jdt)))
    for top in (tspmv.DiaOperator(K, dtype=tdt, device="cpu"),
                tspmv.EllOperator(K, dtype=tdt, device="cpu")):
        pt = top.prepare(top.vals)
        Y = top.matvec_prepared(pt, torch.as_tensor(X, dtype=tdt))
        assert Y.shape == X.shape and Y.dtype == tdt
        assert rel(Yj, Y.numpy()) <= tol
        for j in (0, 4):
            y = top.matvec_prepared(pt, torch.as_tensor(X[j], dtype=tdt))
            assert rel(y.numpy(), Y[j].numpy()) <= (
                0.0 if isinstance(top, tspmv.DiaOperator) else 1e-15)
    if dt == "f32" and HAVE_PALLAS:
        top = tspmv.DiaOperator(K, dtype=tdt, device="cpu")
        bands = top.prepare(top.vals)
        pk = PallasDiaMatvec(top.offsets, top.n, block=256, interpret=True)
        Yp = np.asarray(jax.vmap(lambda x: pk(jnp.asarray(bands.numpy()), x))(
            jnp.asarray(X, jnp.float32)))
        assert rel(Yp, top.matvec_prepared(
            bands, torch.as_tensor(X, dtype=tdt)).numpy()) <= tol


# -- the V-cycle on a block -------------------------------------------------

def _neumann(nx, levels):
    d = laplace_cfg(nx, levels, drv={"Null Space Type": "Constant"})
    K = laplace2d_neumann(nx, nx).tocsr()
    tv = create_testvector(T.Params(d), K)
    return d, K, tv, create_nullspace(T.Params(d), K.shape[0])


def _plain(d):
    K, tv = problem(d)
    return d, K, tv, None


def _structured(d, flag):
    d["Preconditioner"]["Structured Apply"] = flag
    return d


# name -> () -> (dict, K, test vector, border or None); the paths
# `setup_deflation` reaches
APPLY_CASES = {
    "generic": lambda: _plain(_structured(laplace_cfg(32), False)),
    "structured": lambda: _plain(_structured(laplace_cfg(32), "Auto")),
    "direct": lambda: _plain(laplace_cfg(16, levels=0)),
    "bgrid_3d": lambda: _plain(_bgrid_cfg(True)),
    "bordered": lambda: _neumann(32, 2),
    "direct_bordered": lambda: _neumann(16, 0),
}


@functools.lru_cache(maxsize=None)
def _apply_pair(name):
    d, K, tv, border = APPLY_CASES[name]()
    Pj, Pt = pair(d, K, tv, compute=False)
    if border is not None:
        Pj.set_border(border)
        Pt.set_border(border)
    Pj.compute()
    Pt.compute()
    return Pj, Pt, K.shape[0], 0 if border is None else border.shape[1]


@pytest.mark.parametrize("name", list(APPLY_CASES))
def test_block_apply(name):
    Pj, Pt, n, m = _apply_pair(name)
    b = 6
    X = _rows(n, b, 2)
    if name == "structured":
        assert Pt._structured_active
    if name == "generic":
        assert not Pt._structured_active
    if name == "bgrid_3d":
        assert Pt._bgrid is not None
    if not m:
        fac = Pt.factors
        Y = Pt.apply_fn(fac, torch.as_tensor(X))
        cols = torch.stack([Pt.apply_fn(fac, torch.as_tensor(X[j]))
                            for j in range(b)])
        Yj = jax.vmap(ref_apply(Pj))(jnp.asarray(X))
    else:
        Tm = _rows(m, b, 3)
        fac = Pt.factors
        Y = torch.cat(Pt.apply_bordered_fn(fac, torch.as_tensor(X),
                                           torch.as_tensor(Tm)), dim=1)
        cols = torch.stack([torch.cat(Pt.apply_bordered_fn(
            fac, torch.as_tensor(X[j]), torch.as_tensor(Tm[j])))
            for j in range(b)])
        jfac, jplans = ref_generic(Pj)
        Yj = jnp.concatenate(jax.vmap(
            lambda z, t: Pj._apply_bordered_pure(jfac, jplans, z, t))(
                jnp.asarray(X), jnp.asarray(Tm)), axis=1)
    assert Y.shape == (b, n + m) and Y.is_contiguous()
    assert rel(cols.numpy(), Y.numpy()) <= BLOCK_VS_COLUMNS
    assert rel(np.asarray(Yj), Y.numpy()) <= BLOCK_VS_REFERENCE


def test_structured_program_block_apply():
    """`StructuredProgram.apply` itself takes a block."""
    _Pj, Pt, n, _m = _apply_pair("structured")
    prog = Pt._structured
    X = torch.as_tensor(_rows(n, 3, 5))
    Y = prog.apply(Pt.factors.tree, X)
    for j in range(3):
        assert rel(prog.apply(Pt.factors.tree, X[j]).numpy(),
                   Y[j].numpy()) <= BLOCK_VS_COLUMNS


# -- the batched projected GMRES -------------------------------------------

def test_gmres_batched_matches_vmapped_gmres():
    """The projected Laplace 32^2 system of the deflation setup,
    preconditioned by the projected V-cycle (L = 2), k = 8 right-hand
    sides of different difficulty, against
    `jax.vmap(hymls_tpu.solvers.krylov.gmres)`, left and right."""
    Pj, Pt, n, _m = _apply_pair("generic")
    K = problem(laplace_cfg(32))[0]
    k = 8
    rng = np.random.default_rng(7)
    V = np.linalg.qr(rng.standard_normal((n, k)))[0]
    AV = K @ V
    Rhs = (AV - V @ (V.T @ AV)).T.copy()
    # columns that converge at different counts: smooth, rough, scaled
    Rhs[1] = rng.standard_normal(n)
    Rhs[2] = np.sin(np.arange(n) * 0.01)
    Rhs[5] *= 1e-6
    Rhs -= (Rhs @ V) @ V.T

    japply = ref_apply(Pj)
    Kj = jnp.asarray(K.toarray())
    Vj = jnp.asarray(V)
    tfac = Pt.factors
    Kop = tspmv.DiaOperator(K, device="cpu")
    bands = Kop.prepare(Kop.vals)
    Vt = torch.as_tensor(V)

    def jproj(x):
        return x - Vj @ (Vj.T @ x)

    for left in (True, False):
        def jsolve(b):
            return jkrylov.gmres(
                lambda x: jproj(Kj @ jproj(x)), b, jnp.zeros_like(b),
                lambda x: jproj(japply(jproj(x))),
                tol=1e-10, maxiter=100, left=left)
        rj = jax.vmap(jsolve)(jnp.asarray(Rhs))
        op = projected_operator(
            lambda X: Kop.matvec_prepared(bands, X), Vt)
        prec = projected_operator(
            lambda X: Pt.apply_fn(tfac, X), Vt)
        B = torch.as_tensor(Rhs)
        rt = tkrylov.gmres_batched(op, B, torch.zeros_like(B), prec,
                                   tol=1e-10, maxiter=100, left=left)
        assert rt.x.shape == (k, n)
        assert np.array_equal(rt.iters.numpy(), np.asarray(rj.iters))
        assert bool(rt.converged.all())
        for j in range(k):
            assert rel(np.asarray(rj.x[j]), rt.x[j].numpy()) <= X_TOL
        assert np.allclose(rt.relres.numpy(), np.asarray(rj.relres),
                           rtol=1e-6, atol=0)
        its = rt.iters.numpy()
        assert its.min() < its.max(), its
        # the column that converges first keeps its iterate while the
        # others go on: it equals that column solved alone
        j = int(np.argmin(its))
        alone = tkrylov.gmres_batched(op, B[j:j + 1].contiguous(),
                                      torch.zeros_like(B[j:j + 1]), prec,
                                      tol=1e-10, maxiter=100, left=left)
        assert int(alone.iters[0]) == its[j]
        assert rel(alone.x[0].numpy(), rt.x[j].numpy()) <= BLOCK_VS_COLUMNS


def test_gmres_batched_converged_start():
    """A zero right-hand side beside a live one: the zero column takes no
    iteration and returns its start vector, as the vmapped reference."""
    A = torch.diag(torch.arange(1.0, 9.0, dtype=torch.float64))
    B = torch.zeros((2, 8), dtype=torch.float64)
    B[1] = 1.0
    r = tkrylov.gmres_batched(lambda X: X @ A.T, B, torch.zeros_like(B),
                              tol=1e-12, maxiter=20)
    rj = jax.vmap(lambda b: jkrylov.gmres(
        lambda x: jnp.asarray(A.numpy()) @ x, b, jnp.zeros_like(b),
        tol=1e-12, maxiter=20))(jnp.asarray(B.numpy()))
    assert r.iters.tolist() == np.asarray(rj.iters).tolist()
    assert r.iters[0] == 0 and torch.equal(r.x[0], torch.zeros(8,
                                                                dtype=A.dtype))
    assert rel(np.asarray(rj.x), r.x.numpy()) <= X_TOL


# -- the setup's calls --------------------------------------------------------

def test_setup_makes_block_calls(monkeypatch):
    """tests/test_variants.py's deflated anisotropic Laplace (32^2,
    L = 2, k = 8): the subspace iteration makes (it + 1) block applies of
    kp = 14 columns and no single-column apply; the k projected solves
    make one multi-column DIA product per batched iteration (plus the
    start residual), each on the whole block of 8, and no single-vector
    DIA product."""
    calls = {"apply": [], "matmat": [], "matvec": 0, "gmres": []}
    apply_fn = Preconditioner.apply_fn
    matmat, matvec = tspmv.dia_matmat_packed, tspmv.dia_matvec_packed
    gmres_batched = tkrylov.gmres_batched

    def count_apply(self, fac, b):
        calls["apply"].append(tuple(b.shape))
        return apply_fn(self, fac, b)

    def count_matmat(bands, X, offs):
        calls["matmat"].append(X.shape[0])
        return matmat(bands, X, offs)

    def count_matvec(bands, x, offs):
        calls["matvec"] += 1
        return matvec(bands, x, offs)

    def count_gmres(*a, **kw):
        res = gmres_batched(*a, **kw)
        calls["gmres"].append(res.iters.clone())
        return res

    monkeypatch.setattr(Preconditioner, "apply_fn", count_apply)
    monkeypatch.setattr(tspmv, "dia_matmat_packed", count_matmat)
    monkeypatch.setattr(tspmv, "dia_matvec_packed", count_matvec)
    monkeypatch.setattr(tkrylov, "gmres_batched", count_gmres)

    K = aniso_laplace(32)
    d = laplace_cfg(32, solver={"Deflated Subspace Dimension": 8})
    P = T.Preconditioner(K, T.Params(d),
                         testvector=create_testvector(T.Params(d), K),
                         device="cpu").compute()
    S = T.Solver(K, P, T.Params(d), device="cpu").setup_deflation()
    n, kp = K.shape[0], 8 + 6
    applies = S._defl_info["applies"]
    assert applies % kp == 0
    blocks = [s for s in calls["apply"] if s == (kp, n)]
    assert len(blocks) == applies // kp        # (it + 1) block applies
    setup = [s for s in calls["apply"] if s != (kp, n)]
    assert calls["matvec"] == 0
    assert len(calls["gmres"]) == 1
    iters = calls["gmres"][0]
    assert iters.shape == (8,)
    # one V-cycle and one DIA product on the whole block per iteration
    assert setup == [(8, n)] * (int(iters.max()) + 1)
    assert calls["matmat"] == [8] * (int(iters.max()) + 1)
    assert S._last_res.iters == int(iters[-1])


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nvec", [1, 2, 3, 5, 8, 11, 17, 32],
                         ids=lambda b: f"B{b}")
@pytest.mark.parametrize("matrix", ["aniso32", "aniso37", "stokes3d8"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_cuda_dia_matmat_kernel(cuda_device, dt, matrix, nvec):
    """The multi-column kernel on the card: one launch, each row equal
    to K1 on that row bit for bit, and the plain version within 4 ulp of
    sum_k |bands x| per element (the kernel fuses each product, the
    plain version rounds it).  Block sizes from one vector to four
    groups of 8, some not a multiple of any group; the anisotropic
    Laplace at 32^2 and at a ragged 37^2 (n = 1369, a multiple of no
    row tile), and the 19-band 3-D Stokes operator at 8^3."""
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec_packed
    K = {"aniso32": lambda: aniso_laplace(32),
         "aniso37": lambda: aniso_laplace(37),
         "stokes3d8": lambda: stokes3d(8, 8, 8).tocsr()}[matrix]()
    op = tspmv.DiaOperator(K, dtype=dt, device=cuda_device)
    assert op.packed.k == (19 if matrix == "stokes3d8" else 5)
    bands = op.prepare(op.vals)
    X = torch.as_tensor(_rows(K.shape[0], nvec, 9), dtype=dt,
                        device=cuda_device)
    before = dia_matmat.launches
    Y = op.matvec_prepared(bands, X)
    torch.cuda.synchronize()
    assert dia_matmat.launches == before + 1
    for j in range(nvec):
        assert torch.equal(Y[j], dia_matvec_packed(bands, X[j], op.packed))
    ref = dia_matmat_reference(bands, X, op.offsets)
    scale = dia_matmat_reference(bands.abs(), X.abs(), op.offsets)
    scale = scale.clamp_min(torch.finfo(dt).tiny)
    assert float(((Y - ref).abs() / scale).max()) <= 4 * torch.finfo(dt).eps


@pytest.mark.cuda
@pytest.mark.parametrize("structured", ["Auto", False],
                         ids=["structured", "generic"])
def test_cuda_block_apply(cuda_device, structured):
    """The block V-cycle on the card against per-column applies."""
    d = _structured(laplace_cfg(32), structured)
    K, tv = problem(d)
    P = T.Preconditioner(K, T.Params(d), testvector=tv,
                         device=cuda_device).compute()
    fac = P.factors
    X = torch.as_tensor(_rows(K.shape[0], 6, 2), device=cuda_device)
    Y = P.apply_fn(fac, X)
    cols = torch.stack([P.apply_fn(fac, X[j]) for j in range(6)])
    assert rel(cols.cpu().numpy(), Y.cpu().numpy()) <= BLOCK_VS_COLUMNS
