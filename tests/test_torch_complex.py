"""Complex GMRES and `ComplexSolver` of the port against the JAX
package, in complex128 on the CPU.

The cases are those of tests/test_variants.py (the complex-shifted
Laplace; complex GMRES on a real system) and tests/test_combos.py (the
complex bordered solve): the same right-hand side through both
packages gives the same iteration count and the same x to 1e-10
relative.  The port's GMRES on dense complex systems is held against
the reference's with left and right preconditioning and with a
restart; the real path is untouched (tests/test_torch_slice.py and
tests/test_torch_restart.py hold it).
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp
import torch

import hymls_tpu as H
import hymls_tpu_torch as T
from hymls_tpu.solvers import krylov as jkrylov
from hymls_tpu.solvers.complex_solver import ComplexSolver as JComplexSolver
from hymls_tpu_torch.solvers import krylov
from hymls_tpu_torch.solvers.complex_solver import ComplexSolver, real_imag
from hymls_tpu_torch.stencils import laplace2d, create_testvector

from _torch_parity import laplace_cfg, neumann_setup, pair

X_TOL = 1e-10          # relative, port against reference


def _relerr(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _crandn(rng, n):
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


@pytest.fixture(scope="module")
def shifted_laplace():
    """tests/test_variants.py::test_complex_solver: (A + 0.5 i I) z = b
    at 32^2, one level, both packages' solvers and solutions."""
    nx = 32
    A = laplace2d(nx, nx).tocsr()
    B = sp.identity(A.shape[0], format="csr") * 0.5
    d = laplace_cfg(nx, levels=1)
    Pj, Pt = pair(d, A, create_testvector(T.Params(d), A))
    z_ex = _crandn(np.random.default_rng(11), A.shape[0])
    b = A @ z_ex + 1j * (B @ z_ex)
    zj, rj = JComplexSolver(A, Pj, H.Params(d), B=B).apply_inverse(b)
    zt, rt = ComplexSolver(A, Pt, T.Params(d), B=B,
                           device="cpu").apply_inverse(b)
    return dict(A=A, B=B, d=d, Pt=Pt, z_ex=z_ex, b=b, zj=np.asarray(zj),
                rj=rj, zt=zt, rt=rt)


def test_complex_solver_matches_reference(shifted_laplace):
    s = shifted_laplace
    assert s["zt"].dtype == torch.complex128
    assert s["rt"].converged and bool(s["rj"].converged)
    assert s["rt"].iters == int(s["rj"].iters)
    assert _relerr(s["zj"], s["zt"].numpy()) <= X_TOL
    # the reference test's own assertion
    assert _relerr(s["z_ex"], s["zt"].numpy()) < 1e-8


def test_complex_solver_takes_tensors(shifted_laplace):
    """A complex tensor right-hand side gives the same solve as the
    numpy one."""
    s = shifted_laplace
    CS = ComplexSolver(s["A"], s["Pt"], T.Params(s["d"]), B=s["B"],
                       device="cpu")
    z, res = CS.apply_inverse(torch.as_tensor(s["b"]))
    assert res.iters == s["rt"].iters
    assert torch.equal(z, s["zt"])


def test_gmres_complex_consistency():
    """tests/test_variants.py::test_gmres_complex_consistency: complex
    GMRES on a real system equals the real solve to 1e-9, and the
    reference's complex solve to 1e-10."""
    nx = 16
    K = laplace2d(nx, nx).tocsr()
    d = laplace_cfg(nx, levels=1)
    Pj, Pt = pair(d, K, None)
    b = K @ np.random.default_rng(2).standard_normal(K.shape[0])
    x_r, r_r = T.Solver(K, Pt, T.Params(d), device="cpu").apply_inverse(b)
    x_c, r_c = ComplexSolver(K, Pt, T.Params(d), device="cpu").apply_inverse(
        b.astype(np.complex128))
    assert _relerr(x_r.numpy(), x_c.numpy()) < 1e-9
    assert np.abs(x_c.numpy().imag).max() == 0.0
    x_j, r_j = JComplexSolver(K, Pj, H.Params(d)).apply_inverse(
        b.astype(np.complex128))
    assert r_c.iters == int(r_j.iters)
    assert _relerr(np.asarray(x_j), x_c.numpy()) <= X_TOL


def test_complex_bordered_matches_reference():
    """tests/test_combos.py::test_complex_bordered: the Neumann Laplace
    plus 0.3 i I, bordered with the constant null space."""
    d, K, tv, ns = neumann_setup(levels=1)
    B = sp.identity(K.shape[0], format="csr") * 0.3
    Pj, Pt = pair(d, K, tv, compute=False)
    CSj = JComplexSolver(K, Pj, H.Params(d), B=B)
    CSt = ComplexSolver(K, Pt, T.Params(d), B=B, device="cpu")
    CSj.set_border(ns)
    CSt.set_border(ns)
    Pj.compute()
    Pt.compute()
    assert all(a.dtype == torch.complex128 for a in CSt._border)
    z_ex = _crandn(np.random.default_rng(5), K.shape[0])
    z_ex -= ns @ (ns.T.conj() @ z_ex)
    b = K @ z_ex + 1j * (B @ z_ex)
    zj, rj = CSj.apply_inverse(b)
    zt, rt = CSt.apply_inverse(b)
    assert zt.shape == (K.shape[0],)
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters)
    assert _relerr(np.asarray(zj), zt.numpy()) <= X_TOL
    z = zt.numpy()
    assert np.linalg.norm(K @ z + 1j * (B @ z) - b) / np.linalg.norm(b) < 1e-8


def test_complex_border_keeps_its_conjugate():
    """A complex border: the constraint row is W^H x (reference
    complex_solver.py: `W.T.conj() @ x`), so the solution satisfies
    W^H z = 0, not W^T z = 0."""
    d, K, tv, ns = neumann_setup(nx=16, levels=1)
    B = sp.identity(K.shape[0], format="csr") * 0.3
    phase = np.exp(0.7j)
    _Pj, Pt = pair(d, K, tv, compute=False)
    CS = ComplexSolver(K, Pt, T.Params(d), B=B, device="cpu")
    CS.set_border(ns * phase)
    b = _crandn(np.random.default_rng(8), K.shape[0])
    z, res = CS.apply_inverse(b)
    assert res.converged
    assert abs(np.vdot(ns[:, 0] * phase, z.numpy())) < 1e-9


def _dense_system(seed, n=60):
    rng = np.random.default_rng(seed)
    A = (np.eye(n) * 4 + (rng.standard_normal((n, n)) +
                          1j * rng.standard_normal((n, n))) / np.sqrt(n))
    Minv = np.diag(1.0 / np.diag(A))
    return A, Minv, _crandn(rng, n)


@pytest.mark.parametrize("left", [False, True])
@pytest.mark.parametrize("restart", [None, 6])
def test_dense_complex_gmres_matches_reference(left, restart):
    """The port's GMRES on a dense complex128 system, Jacobi
    preconditioned on either side, full and restarted every 6: the
    reference's iteration count and x to 1e-10; true residual to 1e-9."""
    A, Minv, b = _dense_system(21)
    kw = dict(tol=1e-10, maxiter=60, left=left, restart=restart)
    Aj, Mj = jnp.asarray(A), jnp.asarray(Minv)
    rj = jkrylov.gmres(lambda x: Aj @ x, jnp.asarray(b),
                       jnp.zeros_like(jnp.asarray(b)),
                       lambda x: Mj @ x, **kw)
    At, Mt = torch.as_tensor(A), torch.as_tensor(Minv)
    bt = torch.as_tensor(b)
    rt = krylov.gmres(lambda x: At @ x, bt, torch.zeros_like(bt),
                      lambda x: Mt @ x, **kw)
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters)
    if restart:
        assert rt.iters > restart            # more than one cycle
    assert _relerr(np.asarray(rj.x), rt.x.numpy()) <= X_TOL
    ref_res = float(np.real(rj.relres))  # complex-typed after a restart
    assert abs(rt.relres - ref_res) <= 1e-6 * ref_res
    x = rt.x.numpy()
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-9


def test_complex_gmres_without_preconditioner_and_nonzero_start():
    A, _Minv, b = _dense_system(22, n=30)
    x0 = _crandn(np.random.default_rng(1), 30)
    Aj = jnp.asarray(A)
    rj = jkrylov.gmres(lambda x: Aj @ x, jnp.asarray(b), jnp.asarray(x0),
                       tol=1e-12, maxiter=30)
    At = torch.as_tensor(A)
    rt = krylov.gmres(lambda x: At @ x, torch.as_tensor(b),
                      torch.as_tensor(x0), tol=1e-12, maxiter=30)
    assert rt.iters == int(rj.iters)
    assert _relerr(np.asarray(rj.x), rt.x.numpy()) <= X_TOL


def test_complex64_solver_converges(shifted_laplace):
    """complex64 on an f32 preconditioner: the solve runs in single
    precision end to end and reaches a 1e-4 tolerance."""
    s = shifted_laplace
    d = laplace_cfg(32, levels=1, tol=1e-4)
    Pt = T.Preconditioner(s["A"], T.Params(d), dtype=torch.float32,
                          testvector=create_testvector(T.Params(d), s["A"]),
                          device="cpu").compute()
    CS = ComplexSolver(s["A"], Pt, T.Params(d), B=s["B"],
                       dtype=torch.complex64, device="cpu")
    assert CS.rdtype == torch.float32
    z, res = CS.apply_inverse(s["b"])
    assert z.dtype == torch.complex64 and res.converged
    assert _relerr(s["z_ex"], z.numpy()) < 1e-3


def test_tolerance_rounds_to_the_real_dtype():
    assert krylov._as_dtype(1e-10, torch.complex128) == 1e-10
    assert krylov._as_dtype(1e-4, torch.complex64) == \
        float(np.float32(1e-4))
    assert krylov._as_dtype(1e-4, torch.float32) == float(np.float32(1e-4))


def test_real_imag_are_contiguous():
    z = torch.as_tensor(_crandn(np.random.default_rng(0), 9))
    assert not z.real.is_contiguous()
    re, im = real_imag(z)
    assert re.is_contiguous() and im.is_contiguous()
    assert torch.equal(torch.complex(re, im), z)


def test_distributed_apply_warns_and_solves_replicated(shifted_laplace):
    """'Distributed Apply' without a mesh: the reference's warning, then
    the replicated solve (the same x as without the option)."""
    s = shifted_laplace
    d = laplace_cfg(32, levels=1, solver={"Distributed Apply": True})
    CS = ComplexSolver(s["A"], s["Pt"], T.Params(d), B=s["B"], device="cpu")
    with pytest.warns(UserWarning, match="no device mesh is active"):
        z, res = CS.apply_inverse(s["b"])
    assert CS.distributed is False
    assert res.iters == s["rt"].iters
    assert torch.equal(z, s["zt"])
    Pj = H.Preconditioner(s["A"], H.Params(d), testvector=create_testvector(
        T.Params(d), s["A"])).compute()
    with pytest.warns(UserWarning, match="no device mesh is active"):
        JComplexSolver(s["A"], Pj, H.Params(d), B=s["B"]).apply_inverse(
            s["b"])
