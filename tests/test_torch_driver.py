"""The port's application driver against the JAX package's, on the CPU.

`run_case` of both packages on the same configs at their base size (no
refinement): equal iteration counts on every solve, relres and relerr
to 1e-8 relative plus 1e-13 absolute (`assert_same_solves` of
tests/_torch_parity.py; the rounding of an f64 residual:
laplace1's relres, 1.1e-10, differs by 5.5e-18 between the packages,
and stokes3's direct solve leaves 5.5e-14 in the reference, 1.9e-14 in
the port), every 'Targets' check passed.  Then the
'Warm Recompute' and 'Use Arnoldi' branches by override, `main` (its
report, `--params-doc`, the unknown-parameter warning, the refusal to
run on a card that is not there) and the Store Matrix / Solution /
Level Matrices and HDF5 dumps against the reference's files.
"""
import os

import numpy as np
import pytest
import scipy.io as sio

import torch

import hymls_tpu.driver as HD
import hymls_tpu.solvers.eigen as HE
from hymls_tpu.config import load_xml as ref_load

import hymls_tpu_torch.driver as TD
import hymls_tpu_torch.solvers.eigen as TE
from hymls_tpu_torch.config import Params, load_xml, save_xml
from hymls_tpu_torch.tools.driver_cases import (CONFIGS_DIR, driver_params,
                                                eigen_results)
from hymls_tpu_torch.utils.io import read_hdf5

from _torch_parity import assert_same_solves, rel

PARITY = ["laplace1", "stokes3", "bordering1", "laplace1_deflation",
          "laplace1_eigs", "stokes_L2"]

WARM = (("Driver", "Warm Recompute"), True)
ARNOLDI = (("Driver", "Eigenvalues", "Use Arnoldi"), True)


def _drive(driver, eigen, params, **kw):
    """run_case, and the EigenResult of its eigenvalue branch (the
    driver keeps none in its report) or None."""
    with eigen_results(eigen) as got:
        report = driver.run_case(params, **kw)
    return report, (got[0] if got else None)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's run_case per (config, override), each run once
    per module."""
    cache = {}

    def get(name, override=None):
        key = (name, repr(override))
        if key not in cache:
            cache[key] = _drive(HD, HE,
                                driver_params(ref_load, name, override))
        return cache[key]
    return get


def _port(name, override=None):
    return _drive(TD, TE, driver_params(load_xml, name, override),
                  device="cpu")


@pytest.mark.parametrize("name", PARITY)
def test_run_case_matches_reference(name, reference):
    rj, ej = reference(name)
    rt, et = _port(name)
    assert_same_solves(rj, rt)
    assert (ej is None) == (et is None)
    if et is not None:          # laplace1_eigs: JDQR
        assert et.converged == ej.converged == 10
        assert abs(et.iterations - ej.iterations) <= 5
        assert np.abs(np.sort_complex(et.values) -
                      np.sort_complex(ej.values)).max() <= 1e-8
    # the analytic counts of utils/flops.py, read from identical plans
    assert set(rt.cost_model) == set(rj.cost_model)
    for k in ("compute_gflop", "apply_mflop", "apply_mb"):
        assert rt.cost_model[k] == rj.cost_model[k], k


def test_warm_recompute_matches_reference(reference):
    rj, _ = reference("laplace1", WARM)
    rt, _ = _port("laplace1", WARM)
    assert_same_solves(rj, rt)


def test_arnoldi_branch_matches_reference(reference):
    """'Use Arnoldi': shift_invert_eigs around the port's Solver, then
    the driver's sort and truncation of the result."""
    rj, ej = reference("laplace1_eigs", ARNOLDI)
    rt, et = _port("laplace1_eigs", ARNOLDI)
    assert_same_solves(rj, rt)
    assert et.iterations == ej.iterations == -1
    assert et.converged == ej.converged == 10
    assert et.values.shape == ej.values.shape == (10,)
    assert et.vectors.shape == ej.vectors.shape
    assert np.abs(et.values - ej.values).max() <= 1e-10


def _write_override(path, driver):
    save_xml(Params({"Driver": driver}), str(path))
    return str(path)


def test_main_reports_and_warns(tmp_path, capsys):
    """main on laplace1 without refinement, with an unknown parameter:
    the reference's warning, the report lines, exit 0."""
    over = _write_override(tmp_path / "over.xml",
                           {"Number of refinements": 0, "Bogus Knob": 1})
    cfg = os.path.join(CONFIGS_DIR, "laplace1.xml")
    from hymls_tpu.params_doc import validate as ref_validate
    p = ref_load(cfg)
    p.update_from(ref_load(over))
    warnings = [f"WARNING: {w}" for w in ref_validate(p)]
    assert any("Bogus Knob" in w for w in warnings)

    assert TD.main([cfg, over, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    for w in warnings:
        assert w in out
    report = [ln for ln in out if ln.startswith("refinement 0: iters=")]
    assert len(report) == 4 and all("iters=20 " in ln for ln in report)
    assert any(ln.startswith("refinement 0: cost model:") for ln in out)
    assert "driver: solve" in "\n".join(out)
    assert "  no CUDA device in use by this process" in out
    assert out[-1] == "ALL TESTS PASSED"


def test_params_doc_matches_reference(capsys):
    """What the reference's `main(["--params-doc"])` prints (its main
    is not called: it resets JAX's compilation-cache settings)."""
    from hymls_tpu.params_doc import documentation
    assert TD.main(["--params-doc"]) == 0
    assert capsys.readouterr().out == documentation() + "\n"


def test_main_refuses_a_missing_card(monkeypatch, capsys):
    """Without a card and without --device cpu, main exits non-zero and
    names the device; it does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TD.main([os.path.join(CONFIGS_DIR, "laplace1.xml")]) != 0
    err = capsys.readouterr().err
    assert "'cuda'" in err and "--device cpu" in err


def _dump_params(load, fmt):
    p = load(os.path.join(CONFIGS_DIR, "laplace1.xml"))
    p.sublist("Problem")["nx"] = p.sublist("Problem")["ny"] = 16
    p.sublist("Preconditioner")["Number of Levels"] = 2
    drv = p.sublist("Driver")
    for k, v in {"Number of factorizations": 1, "Number of solves": 1,
                 "Store Format": fmt, "Store Matrix": True,
                 "Store Solution": True,
                 "Store Level Matrices": True}.items():
        drv[k] = v
    return p


def _port_dumps(where, monkeypatch, fmt):
    os.makedirs(where)
    monkeypatch.chdir(where)
    rep = TD.run_case(_dump_params(load_xml, fmt), device="cpu")
    assert rep.passed, rep.failures
    return where


def _reference_dumps(where, monkeypatch, fmt):
    """The files the reference's run_case means to write, written with
    the reference's own writers from its own matrix, solution and
    preconditioner.  Its run_case cannot write them itself: an import
    of `hio` inside its solve loop (hymls_tpu/driver.py:254) makes the
    name local to the function, so every dump raises UnboundLocalError
    unless a solve failed first."""
    from hymls_tpu.utils import io as hio
    seen = {}

    class Recording(HD.Solver):
        def apply_inverse(self, b, *a, **k):
            out = super().apply_inverse(b, *a, **k)
            seen["x"], seen["P"] = np.asarray(out[0]), self.precond
            return out
    monkeypatch.setattr(HD, "Solver", Recording)
    params = _dump_params(ref_load, fmt)
    for k in ("Store Matrix", "Store Solution", "Store Level Matrices"):
        params.sublist("Driver")[k] = False
    rep = HD.run_case(params)
    assert rep.passed, rep.failures
    K = HD.get_linear_system(params)[0]
    os.makedirs(where)
    monkeypatch.chdir(where)
    if fmt == "HDF5":
        hio.write_hdf5("dump.h5", matrix=K, solution=seen["x"])
    else:
        hio.write_matrix("matrix_dump.mtx", K)
        seen["P"].dump_levels("level_dump")
        hio.write_vector("solution_dump.mtx", seen["x"])
    return where


def test_matrix_market_dumps_match_reference(tmp_path, monkeypatch):
    """matrix_dump.mtx, solution_dump.mtx and level_dump{0,1,2}.mtx (the
    level-0 matrix and each next-level Schur matrix, in f64)."""
    dj = _reference_dumps(tmp_path / "ref", monkeypatch, "MatrixMarket")
    dt = _port_dumps(tmp_path / "port", monkeypatch, "MatrixMarket")
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt)) == [
        "level_dump0.mtx", "level_dump1.mtx", "level_dump2.mtx",
        "matrix_dump.mtx", "solution_dump.mtx"]
    for f in names:
        a = sio.mmread(str(dj / f))
        b = sio.mmread(str(dt / f))
        if f == "solution_dump.mtx":
            assert rel(a, b) <= 1e-10, f
        else:
            assert rel(a.toarray(), b.toarray()) <= 1e-12, f


def test_level_dump_matches_reference_to_1e12(tmp_path, monkeypatch):
    """Preconditioner.dump_levels on stokes2's skew Stokes hierarchy at
    32^2 with two levels (the Householder transform on)."""
    import hymls_tpu as H
    import hymls_tpu_torch as T
    from hymls_tpu_torch.stencils import create_matrix, create_testvector
    d = {"Problem": {"Equations": "Stokes-C", "Dimension": 2,
                     "nx": 32, "ny": 32},
         "Preconditioner": {"Partitioner": "Skew Cartesian",
                            "Separator Length": 4, "Number of Levels": 2}}
    K = create_matrix(T.Params(d)).tocsr()
    tv = create_testvector(T.Params(d), K)
    monkeypatch.chdir(tmp_path)
    pj = H.Preconditioner(K, H.Params(d), testvector=tv).dump_levels("r")
    pt = T.Preconditioner(K, T.Params(d), testvector=tv,
                          device="cpu").dump_levels("t")
    assert len(pj) == len(pt) == 3
    for a, b in zip(pj, pt):
        A, B = sio.mmread(a).tocsr(), sio.mmread(b).tocsr()
        assert A.shape == B.shape
        assert rel(A.toarray(), B.toarray()) <= 1e-12, (a, b)


def test_hdf5_dump_matches_reference(tmp_path, monkeypatch):
    dj = _reference_dumps(tmp_path / "ref", monkeypatch, "HDF5")
    dt = _port_dumps(tmp_path / "port", monkeypatch, "HDF5")
    assert os.listdir(dj) == os.listdir(dt) == ["dump.h5"]
    a, b = read_hdf5(str(dj / "dump.h5")), read_hdf5(str(dt / "dump.h5"))
    assert set(a) == set(b) == {"matrix", "solution"}
    assert (a["matrix"] != b["matrix"]).nnz == 0
    assert rel(a["solution"], b["solution"]) <= 1e-10
