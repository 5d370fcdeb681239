"""Deflated solves of the port against the JAX package (f64, CPU), and
the `Solver` options that the port once refused.

Both packages draw the subspace iteration's start block from
`default_rng(12345)` on the host, so they iterate on the same block:
the deflation spaces agree as subspaces (projector V V' to 1e-6; QR
column signs differ between libraries), `applies` are equal, and the
deflated solve gives x to 1e-8 relative with the iteration count
within 1.  On the reference's own V (`setup_deflation(V=...)`,
`convert.deflation_from_numpy`) x agrees to 1e-10.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import torch

import hymls_tpu_torch as T
from hymls_tpu_torch.convert import deflation_from_numpy
from hymls_tpu_torch.ops.spmv import DiaOperator
from hymls_tpu_torch.solvers import deflation
from hymls_tpu_torch.stencils import create_testvector, laplace2d

from _torch_parity import (aniso_laplace, laplace_cfg, neumann_setup,
                           projector_gap, rel, relres, solver_pair)

V_TOL = 1e-6           # max |V V' - V_ref V_ref'|
X_TOL = 1e-8           # relative, own V against the reference's own V
X_TOL_SAME_V = 1e-10   # relative, on the same V


def _relerr(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module")
def aniso():
    """tests/test_variants.py::test_deflated_solver: anisotropic Laplace
    32^2, two levels, 8 deflated modes, both packages set up."""
    nx = 32
    K = aniso_laplace(nx)
    d = laplace_cfg(nx, solver={"Deflated Subspace Dimension": 8})
    tv = create_testvector(T.Params(d), K)
    Sj, St = solver_pair(d, K, tv)
    Sj.setup_deflation()
    St.setup_deflation()
    x_ex = np.random.default_rng(5).standard_normal(K.shape[0])
    return dict(K=K, d=d, tv=tv, Sj=Sj, St=St, x_ex=x_ex, b=K @ x_ex)


def test_deflation_space_matches_reference(aniso):
    Sj, St = aniso["Sj"], aniso["St"]
    Vj, Vt = Sj._deflation.V, St._deflation.V
    assert Vt.shape == Vj.shape == (aniso["K"].shape[0], 8)
    assert np.abs(Vt.T @ Vt - np.eye(8)).max() < 1e-12
    assert projector_gap(Vj, Vt) <= V_TOL
    assert St._defl_info["applies"] == Sj._defl_info["applies"]
    assert abs(St._defl_info["rel"] - Sj._defl_info["rel"]) <= \
        1e-6 * Sj._defl_info["rel"]
    # the reference test's gates: converged well before the cap
    assert St._defl_info["rel"] <= 1e-5
    assert St._defl_info["applies"] < 40 * (8 + 6)
    # the correction system, in a basis-free form: V D^{-1} V'
    Cj = Vj @ Sj._deflation.D_inv @ Vj.T
    Ct = Vt @ St._deflation.D_inv @ Vt.T
    assert rel(Cj, Ct) <= 1e-6


def test_deflated_solve_matches_reference(aniso):
    K, b, x_ex = aniso["K"], aniso["b"], aniso["x_ex"]
    xj, rj = aniso["Sj"].apply_inverse(b)
    xt, rt = aniso["St"].apply_inverse(b)
    assert xt.dtype == torch.float64 and xt.shape == (K.shape[0],)
    assert abs(rt.iters - int(rj.iters)) <= 1
    assert _relerr(np.asarray(xj), xt.numpy()) <= X_TOL
    # the reference test's own assertions
    assert relres(K, xt.numpy(), b) < 5e-9
    assert _relerr(x_ex, xt.numpy()) < 1e-7


def test_deflation_does_not_cost_iterations(aniso):
    """The projected solve takes no more iterations than the plain
    one, in both packages."""
    K, d, tv, b = aniso["K"], aniso["d"], aniso["tv"], aniso["b"]
    plain = laplace_cfg(32)
    Sj0, St0 = solver_pair(plain, K, tv)
    _x, r0 = St0.apply_inverse(b)
    _x, rj0 = Sj0.apply_inverse(b)
    _x, rt = aniso["St"].apply_inverse(b)
    assert r0.iters == int(rj0.iters)
    assert rt.iters <= r0.iters


def test_same_V_gives_the_same_solve(aniso):
    """The reference's V handed to the port: its own correction system
    (R, D recomputed from V) agrees with the reference's, and the
    deflated solve agrees to 1e-10; likewise on the reference's whole
    `Deflation` through convert.deflation_from_numpy."""
    K, d, tv, b = aniso["K"], aniso["d"], aniso["tv"], aniso["b"]
    Sj = aniso["Sj"]
    dj = Sj._deflation
    _Sj, St = solver_pair(d, K, tv)
    St.setup_deflation(V=dj.V)
    dt = St._deflation
    assert np.array_equal(dt.V, dj.V)
    assert rel(dj.AV, dt.AV) <= 1e-14 and rel(dj.ATV, dt.ATV) <= 1e-14
    assert rel(dj.R, dt.R) <= 1e-8          # k GMRES solves to 1e-10
    assert rel(dj.D, dt.D) <= 1e-8
    xj, rj = Sj.apply_inverse(b)
    xt, rt = St.apply_inverse(b)
    assert rt.iters == int(rj.iters)
    assert _relerr(np.asarray(xj), xt.numpy()) <= 1e-9

    St._deflation = deflation_from_numpy(dj.V, dj.AV, dj.ATV, dj.R, dj.D)
    assert St._deflation.k == 8
    assert rel(dj.D_inv, St._deflation.D_inv) <= 1e-14
    xt, rt = St.apply_inverse(b)
    assert rt.iters == int(rj.iters)
    assert _relerr(np.asarray(xj), xt.numpy()) <= X_TOL_SAME_V


def test_bordered_deflated_matches_reference():
    """tests/test_combos.py::test_bordered_deflated: Neumann Laplace
    32^2 with the constant null space as border, 6 deflated modes of
    the augmented system."""
    d, K, tv, ns = neumann_setup(
        solver={"Deflated Subspace Dimension": 6})
    Sj, St = solver_pair(d, K, tv, border=ns)
    Sj.setup_deflation()
    St.setup_deflation()
    n = K.shape[0]
    assert St._defl_aug and St._deflation.V.shape == (n + 1, 6)
    assert projector_gap(Sj._deflation.V, St._deflation.V) <= V_TOL
    assert St._defl_info["applies"] == Sj._defl_info["applies"]
    x_ex = np.random.default_rng(3).standard_normal(n)
    x_ex -= ns @ (ns.T @ x_ex)
    b = K @ x_ex
    xj, rj = Sj.apply_inverse(b)
    xt, rt = St.apply_inverse(b)
    assert xt.shape == (n,)
    assert abs(rt.iters - int(rj.iters)) <= 1
    assert _relerr(np.asarray(xj), xt.numpy()) <= X_TOL
    assert relres(K, xt.numpy(), b) < 5e-9
    assert _relerr(x_ex, xt.numpy()) < 5e-9


def test_mass_matrix_deflation_matches_reference():
    """`set_mass_matrix`: the deflated modes are those of P^{-1} M."""
    nx = 16
    K = aniso_laplace(nx)
    d = laplace_cfg(nx, solver={"Deflated Subspace Dimension": 4})
    tv = create_testvector(T.Params(d), K)
    M = sp.diags(1.0 + 0.5 * np.random.default_rng(4).random(
        K.shape[0])).tocsr()
    Sj, St = solver_pair(d, K, tv)
    assert St.set_mass_matrix(M) is St
    Sj.set_mass_matrix(M)
    Sj.setup_deflation()
    St.setup_deflation()
    assert projector_gap(Sj._deflation.V, St._deflation.V) <= V_TOL
    assert St._defl_info["applies"] == Sj._defl_info["applies"]
    # the mass matrix changes the space
    _Sj, S0 = solver_pair(d, K, tv)
    S0.setup_deflation()
    assert projector_gap(S0._deflation.V, St._deflation.V) > 1e-3
    b = K @ np.random.default_rng(6).standard_normal(K.shape[0])
    xj, rj = Sj.apply_inverse(b)
    xt, rt = St.apply_inverse(b)
    assert abs(rt.iters - int(rj.iters)) <= 1
    assert _relerr(np.asarray(xj), xt.numpy()) <= X_TOL
    St.set_mass_matrix(None)
    assert St._mass is None


def test_dimension_zero_is_a_no_op():
    K = laplace2d(16, 16).tocsr()
    d = laplace_cfg(16, levels=1)
    _Sj, St = solver_pair(d, K)
    assert St.setup_deflation() is St
    assert St._deflation is None and St._opT is None
    b = K @ np.random.default_rng(1).standard_normal(K.shape[0])
    _x, res = St.apply_inverse(b)
    assert res.converged


def test_constructor_takes_the_dimension_without_setting_up():
    """'Deflated Subspace Dimension' > 0 alone changes nothing: as in
    the reference, deflation starts with `setup_deflation()`."""
    K = laplace2d(16, 16).tocsr()
    b = K @ np.random.default_rng(1).standard_normal(K.shape[0])
    d = laplace_cfg(16, levels=1, solver={"Deflated Subspace Dimension": 3})
    Sj, St = solver_pair(d, K)
    assert St._deflation is None
    xt, rt = St.apply_inverse(b)
    xj, rj = Sj.apply_inverse(b)
    assert rt.iters == int(rj.iters)
    assert _relerr(np.asarray(xj), xt.numpy()) <= 1e-10


def test_set_matrix_keeps_the_transpose_in_step(aniso):
    """`set_matrix` keeps `_K` and, once deflation is set up, the
    transpose operator's values."""
    K, d, tv = aniso["K"], aniso["d"], aniso["tv"]
    _Sj, St = solver_pair(d, K, tv)
    K2 = (K * 2.0).tocsr()
    St.set_matrix(K2)
    assert St._opT is None and St._K is not K
    assert np.array_equal(St._K.data, K2.data)
    St.setup_deflation()
    assert isinstance(St._opT, DiaOperator)      # the kernel's operator
    x = np.random.default_rng(2).standard_normal(K.shape[0])
    xt = torch.as_tensor(x)
    assert rel(K2.T @ x, St._opT(xt).numpy()) <= 1e-14
    K3 = K.copy()
    K3.data = K3.data * (1.0 + 0.1 * np.random.default_rng(3).random(K.nnz))
    St.set_matrix(K3)
    assert rel(K3.T @ x, St._opT(xt).numpy()) <= 1e-14
    assert rel(K3 @ x, St.op(xt).numpy()) <= 1e-14


def test_host_arpack_deflation_space():
    """`compute_deflation_space` (ARPACK on the host around the port's
    apply): an orthonormal block, invariant under P^{-1} to the
    requested tolerance."""
    nx = 16
    K = aniso_laplace(nx)
    d = laplace_cfg(nx)
    _Sj, St = solver_pair(d, K, create_testvector(T.Params(d), K))
    P = St.precond
    n = K.shape[0]

    def apply_prec(x):
        return P.apply_inverse(x).numpy()

    V = deflation.compute_deflation_space(apply_prec, n, 4)
    assert V.shape == (n, 4)
    assert np.abs(V.T @ V - np.eye(4)).max() < 1e-12
    PV = np.column_stack([apply_prec(V[:, j]) for j in range(4)])
    resid = PV - V @ (V.T @ PV)
    assert np.linalg.norm(resid) / np.linalg.norm(PV) < 1e-6
    # with a mass operator the block changes
    Vm = deflation.compute_deflation_space(
        apply_prec, n, 4, apply_mass=lambda x: (1.0 + np.arange(n) / n) * x)
    assert projector_gap(V, Vm) > 1e-3


def test_setup_deflation_generic_fallbacks():
    """`deflation.setup_deflation` with column-only products and no
    multi-solve builds the same correction system as with blocks, and
    `deflated_apply` then solves a dense system exactly."""
    rng = np.random.default_rng(9)
    n, k = 30, 3
    A = np.eye(n) * 3 + rng.standard_normal((n, n)) / np.sqrt(n)
    V = np.linalg.qr(rng.standard_normal((n, k)))[0]
    Pm = np.eye(n) - V @ V.T

    def proj_solve(r):
        return Pm @ np.linalg.lstsq(Pm @ A @ Pm, Pm @ r, rcond=None)[0]

    def col_only(Mat):
        def mv(z):
            assert np.ndim(z) == 1
            return Mat @ z
        return mv

    d_cols = deflation.setup_deflation(V, col_only(A), col_only(A.T),
                                       proj_solve)
    d_blk = deflation.setup_deflation(
        V, lambda Z: A @ Z, lambda Z: A.T @ Z, proj_solve,
        multi_solve=lambda R: np.column_stack(
            [proj_solve(R[:, j]) for j in range(R.shape[1])]))
    for f in ("AV", "ATV", "R", "D"):
        assert rel(getattr(d_blk, f), getattr(d_cols, f)) <= 1e-12, f
    b = rng.standard_normal(n)
    x = deflation.deflated_apply(d_cols, b, proj_solve)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10


# -- the options that once raised ------------------------------------------

@pytest.mark.parametrize("method", ["BiCGStab", "Flexible GMRES"])
def test_other_krylov_method_runs_gmres(method):
    """Any 'Krylov Method' other than "CG" runs GMRES, as in the
    reference: the same iteration count as the reference with that
    name, and as the port's GMRES."""
    K = laplace2d(16, 16).tocsr()
    b = K @ np.random.default_rng(1).standard_normal(K.shape[0])
    d = laplace_cfg(16, levels=1, solver={"Krylov Method": method})
    Sj, St = solver_pair(d, K)
    xt, rt = St.apply_inverse(b)
    xj, rj = Sj.apply_inverse(b)
    assert rt.converged and rt.iters == int(rj.iters)
    assert _relerr(np.asarray(xj), xt.numpy()) <= 1e-10
    _Sj, Sg = solver_pair(laplace_cfg(16, levels=1), K)
    xg, rg = Sg.apply_inverse(b)
    assert rg.iters == rt.iters and torch.equal(xg, xt)


@pytest.mark.parametrize("border", [False, True])
def test_distributed_apply_warns_and_solves_replicated(border):
    """'Distributed Apply' without a mesh: the reference's warning, then
    the replicated solve, which gives the x of the solve without the
    option."""
    if border:
        d, K, tv, ns = neumann_setup(nx=16, levels=1)
    else:
        d, K, tv, ns = laplace_cfg(16, levels=1), \
            laplace2d(16, 16).tocsr(), None, None
    b = K @ np.random.default_rng(1).standard_normal(K.shape[0])
    _Sj, S0 = solver_pair(d, K, tv, border=ns)
    x0, r0 = S0.apply_inverse(b)
    dd = {**d, "Solver": {**d["Solver"], "Distributed Apply": True}}
    Sj, St = solver_pair(dd, K, tv, border=ns)
    assert St.distributed is True
    with pytest.warns(UserWarning, match="no device mesh is active"):
        xt, rt = St.apply_inverse(b)
    assert St.distributed is False
    assert rt.iters == r0.iters and torch.equal(xt, x0)
    with pytest.warns(UserWarning, match="no device mesh is active"):
        xj, rj = Sj.apply_inverse(b)
    assert rt.iters == int(rj.iters)


def test_distributed_apply_with_deflation_warns():
    K = aniso_laplace(16)
    d = laplace_cfg(16, solver={"Deflated Subspace Dimension": 3,
                                "Distributed Apply": True})
    _Sj, St = solver_pair(d, K, create_testvector(T.Params(d), K))
    with pytest.warns(UserWarning, match="no device mesh is active"):
        St.setup_deflation()
    b = K @ np.random.default_rng(1).standard_normal(K.shape[0])
    x, res = St.apply_inverse(b)
    assert res.converged and relres(K, x.numpy(), b) < 5e-9
