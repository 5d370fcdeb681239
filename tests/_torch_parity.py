"""Shared helpers of the tests that hold `hymls_tpu_torch` against the
JAX package on the CPU: both preconditioners from the same `Params`
dict, matrix and test vector, and the comparisons the ROADMAP defines
(identical plans; factors to 1e-10 relative in f64; equal M^{-1} b)."""
import numpy as np

import jax.numpy as jnp
import torch

import hymls_tpu as H
import hymls_tpu_torch as T
from hymls_tpu_torch.convert import plans_from_numpy
from hymls_tpu_torch.stencils import create_matrix, create_testvector

LEVEL_KEYS = ("A11inv", "G", "A21", "blkinv", "sc")


def rel(ref, got, floor=1e-300):
    """max|ref - got| over max(max|ref|, floor); 0 for empty arrays."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), floor))


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


def problem(d, make_K=None):
    """(K, test vector) of the parameter dict `d`."""
    K = (make_K() if make_K else create_matrix(T.Params(d))).tocsr()
    return K, create_testvector(T.Params(d), K)


def pair(d, K, tv, dtype=torch.float64, d_ref=None, compute=True):
    """(reference, port) preconditioners of the same problem; `d_ref`
    where the reference needs other parameters than the port."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    Pj = H.Preconditioner(K, H.Params(d_ref or d), testvector=tv, dtype=jdt)
    Pt = T.Preconditioner(K, T.Params(d), testvector=tv, dtype=dtype,
                          device="cpu")
    if compute:
        Pj.compute()
        Pt.compute()
    return Pj, Pt


def assert_plans_identical(Pj, Pt):
    """Every level's device plan (the split maps included, where both
    carry them), and the coarse plan where there is one."""
    levels, coarse = plans_from_numpy(
        np_tree(Pj._dplans),
        None if Pj.coarse_plan is None else np_tree(Pj._dcoarse),
        device="cpu")
    assert len(levels) == len(Pt._dplans)
    for a, b in zip(levels, Pt._dplans):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k].to(b[k].dtype), b[k]), k
    assert (coarse is None) == (Pt._dcoarse is None)
    for k in coarse or ():
        assert torch.equal(coarse[k], Pt._dcoarse[k]), k
    assert [p.apply_ot for p in Pj.plans] == [p.apply_ot for p in Pt.plans]


def assert_factors_agree(Pj, Pt, tol=1e-10, scale=None):
    """Per-level factors and the coarse factor, to `tol` relative to
    each tensor's own maximum, or to `scale` where that is larger
    (assembled values that are zero up to rounding)."""
    fj, ft = Pj._factors, Pt._factors
    assert len(fj["levels"]) == len(ft["levels"])
    for lev, (a, b) in enumerate(zip(fj["levels"], ft["levels"])):
        assert set(a) == set(b)
        for key in LEVEL_KEYS:
            if key in b:
                err = rel(a[key], b[key].numpy(), floor=scale or 1e-300)
                assert err <= tol, f"level {lev} {key}: {err:.2e}"
    assert set(fj["coarse"]) == set(ft["coarse"])
    for key in ("inv", "lu"):
        if key in ft["coarse"]:
            err = rel(fj["coarse"][key], ft["coarse"][key].numpy())
            assert err <= tol, f"coarse {key}: {err:.2e}"


def solve_both(d, K, Pj, Pt, b, d_ref=None):
    """f64 Krylov solves of K x = b through both packages' `Solver`;
    returns ((x, result) of the reference, (x, result) of the port)."""
    xj, rj = H.Solver(K, Pj, H.Params(d_ref or d)).apply_inverse(b)
    xt, rt = T.Solver(K, Pt, T.Params(d), device="cpu").apply_inverse(b)
    return (np.asarray(xj), rj), (xt.numpy(), rt)


def relres(K, x, b):
    return float(np.linalg.norm(K @ np.asarray(x) - b) / np.linalg.norm(b))
