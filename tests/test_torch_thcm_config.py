"""The benchmark's THCM ocean configuration (portbench/configs/
thcm64x64x8.json, upstream's stokes_THCM.xml: Stokes-L with Coriolis on
the Stokes-T grid, full-depth column subdomains) on the CPU, and the
counters that its cell and PERF.md read.

- The frozen generator (portbench/matrices/stokes_t_3d.py) is the
  port's `stokes3d(..., grid_type="T")` and `create_testvector`, byte
  for byte.
- The configuration is its frozen XML but for what it lists under
  `assumed`.
- At 8x8x8 on the source's two levels, on the generic and on the
  structured apply, the port's solution agrees with SciPy's SuperLU and
  with a dense float64 solve off K's two null vectors.
- At 16x16x8 on three levels (the coarsest-level ratio of the cell's
  64x64x8 on five), the port's plans equal the JAX package's, its
  factors agree to 1e-10 and one apply to 1e-12; and a run of the cell
  through the benchmark's harness is judged correct at the source's
  1e-10.
- The Krylov, refinement, coarse, warm-recompute and plan counters count
  what happened; the new readers read nothing from a program without
  them."""
import json
import os
import shutil
import subprocess
import sys
import types
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from hymls_tpu_torch import Params
from hymls_tpu_torch.solvers import krylov
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
from hymls_tpu_torch.stencils import create_matrix, create_testvector
from hymls_tpu_torch.utils import timings

from portbench.harness import reader
from portbench.kernels import dia_bands
from portbench.matrices import stokes_t_3d
from portbench.tests.helpers import ROOT

from _torch_parity import (assert_factors_agree, assert_plans_identical,
                           pair, rel)

NAME = "thcm64x64x8"
CONFIGS = os.path.join(ROOT, "portbench", "configs")


def config():
    with open(os.path.join(CONFIGS, NAME + ".json")) as f:
        return json.load(f)


def params(nx, nz=8, levels=None, structured=None, tol=None, inner=None):
    """The configuration's parameters at nx x nx x nz."""
    p = config()["params"]
    p["Problem"].update(nx=nx, ny=nx, nz=nz)
    pre = p["Preconditioner"]
    if levels is not None:
        pre["Number of Levels"] = levels
    if structured is not None:
        pre["Structured Apply"] = structured
    it = p["Solver"]["Iterative Solver"]
    if tol is not None:
        it["Convergence Tolerance"] = tol
    if inner is not None:
        it["Inner Maximum Iterations"] = inner
    return Params(p)


def matrix(nx, nz=8):
    fam = stokes_t_3d.family({"nx": nx, "ny": nx, "nz": nz})
    return sp.csr_matrix((fam["v0"], fam["indices"], fam["indptr"]),
                         shape=(fam["n"], fam["n"])), fam["testvector"]


def null_vectors(nx, nz=8):
    """K's two null vectors, normalized: the constant pressure and the
    horizontal checkerboard pressure (-1)^(i + j)."""
    n = nx * nx * nz * 4
    gid = np.arange(n)
    node, p = gid // 4, gid % 4 == 3
    i, j = node % nx, (node // nx) % nx
    const = np.where(p, 1.0, 0.0)
    check = np.where(p, (-1.0) ** (i + j), 0.0)
    return [v / np.linalg.norm(v) for v in (const, check)]


@pytest.mark.parametrize("nx", [8, 16])
def test_frozen_generator_is_the_ports(nx):
    p = params(nx)
    K = create_matrix(p)
    fam = stokes_t_3d.family({"nx": nx, "ny": nx, "nz": 8})
    assert np.array_equal(fam["indptr"], K.indptr)
    assert np.array_equal(fam["indices"], K.indices)
    assert np.array_equal(fam["v0"], K.data)
    assert not fam["v1"].any() and fam["theta"] == 0.0
    assert np.array_equal(fam["testvector"], create_testvector(p, K))
    # the THCM block holds 27 DIA bands, against 19 on the C-grid
    assert dia_bands(K.indptr, K.indices) == 27
    for v in null_vectors(nx):
        assert np.abs(K @ v).max() == 0.0 and np.abs(K.T @ v).max() == 0.0


def test_config_is_its_xml_but_for_what_it_assumes():
    conv = {"int": int, "double": float, "bool": lambda v: v == "true",
            "string": str}

    def read(el):
        return {ch.get("name"): read(ch) if ch.tag == "ParameterList"
                else conv[ch.get("type")](ch.get("value")) for ch in el}
    cfg = config()
    src = read(ET.parse(os.path.join(CONFIGS, cfg["upstream_xml"]))
               .getroot())
    assumed = set(cfg["assumed"])

    def walk(a, b):
        for k in set(a) | set(b):
            if k in assumed:
                continue
            assert k in a and k in b, k
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                assert a[k] == b[k], k
    walk({k: src[k] for k in cfg["params"]}, cfg["params"])
    with open(os.path.join(ROOT, "configs", "stokes_THCM.xml")) as f, \
            open(os.path.join(CONFIGS, cfg["upstream_xml"])) as g:
        assert f.read() == g.read()
    assert cfg["reduced"] == [] and "Structured Apply" not in \
        cfg["params"]["Preconditioner"]
    grid = [cfg["params"]["Problem"][k] for k in ("nx", "ny", "nz")]
    assert grid == [cfg["matrix"][k] for k in ("nx", "ny", "nz")] == \
        [64, 64, 8]
    assert cfg["params"]["Preconditioner"]["Number of Levels"] == 5
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert {"name": NAME, "file": f"portbench/configs/{NAME}.json"}.items() \
        <= {c["name"]: c for c in bench["configs"]}[NAME].items()


@pytest.fixture
def one_thread():
    """One torch thread for the test, the number it had after: some
    LAPACK builds hang inverting THCM's (4, 510, 510) blocks on more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def references8():
    """K, b and the two float64 references at 8x8x8: SciPy's SuperLU and
    a dense LU (plain torch, TF32 off, which binds only on a card)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        K, tv = matrix(8)
        b = K @ np.random.default_rng(7).standard_normal(K.shape[0])
        superlu = spla.splu(K.tocsc()).solve(b)
        dense = torch.linalg.solve(torch.as_tensor(K.toarray()),
                                   torch.as_tensor(b)).numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return K, tv, b, (superlu, dense)


# The smallest nonzero singular value of K at 8x8x8 (numpy.linalg.svd:
# 6.456e-6; the two below it, 2.9e-12 and 2.1e-13, are the null vectors',
# the largest is 6447).  Off the null space the error of any x is at most
# its residual over it, so two solutions differ there by at most the sum
# of their residuals over 6.4e-6.  The solve runs to 1e-12 so that the
# bound is below 1e-3 of the solution (2.5e-4 at this b).
SIGMA_MIN = 6.4e-6


@pytest.mark.parametrize("structured", ["Auto", False])
def test_two_level_solve_agrees_with_superlu_and_a_dense_lu(structured,
                                                            references8,
                                                            one_thread):
    K, tv, b, refs = references8
    S = IterativeRefinementSolver(
        K, params(8, levels=2, structured=structured, tol=1e-12),
        testvector=tv, device="cpu")
    assert (S.precond._structured is None) == (structured is False)
    S.compute(K)
    x = S.solve(b).numpy()
    assert np.linalg.norm(b - K @ x) <= 1e-12 * np.linalg.norm(b)
    nulls = null_vectors(8)

    def off_null(v):
        return v - sum(n * (n @ v) for n in nulls)
    for ref in refs:
        bound = (np.linalg.norm(b - K @ x) +
                 np.linalg.norm(b - K @ ref)) / SIGMA_MIN
        assert bound <= 1e-3 * np.linalg.norm(off_null(ref))
        assert np.linalg.norm(off_null(x - ref)) <= bound


def test_three_levels_match_the_reference(one_thread):
    """The five-level hierarchy's shape at 16x16x8: full-depth columns,
    z boxes clipped at nz from level 2 on, held to the JAX package.
    Level 1's assembled Schur values are zero up to rounding, as in
    test_torch_suite.py's stokes_THCM cases: measured against the
    matrix's scale."""
    d = params(16, levels=3).to_dict()
    K, tv = matrix(16)
    Pj, Pt = pair(d, K, tv)
    assert len(Pt.plans) == 3
    assert_plans_identical(Pj, Pt)
    assert_factors_agree(Pj, Pt, scale=float(np.abs(K.data).max()))
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    assert rel(Pj.apply_inverse(b), Pt.apply_inverse(b).numpy()) <= 1e-12


# One run of the cell at 16x16x8 on three levels through the harness, in
# a fresh process: the harness refuses to run where JAX is loaded, as it
# is in the test process.  A wrapper records every solve's inner
# iterations.
HARNESS_RUN = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from portbench import harness

iters = []

class Recorded:
    def __init__(self, S):
        self.S = S

    def __getattr__(self, name):
        return getattr(self.S, name)

    def solve(self, b):
        x = self.S.solve(b)
        iters.append(int(self.S.num_iter))
        return x

out = harness.run(sys.argv[2], "thcm64x64x8.resolve", 2 ** 31 + 13, 0.2,
                  True, device="cpu", wrap=Recorded)
out["iters"] = iters
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def run16(tmp_path_factory):
    """The cell's result object at 16x16x8 on three levels, traced over
    one call."""
    root = str(tmp_path_factory.mktemp("bench16"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__",
                                                  ".plan_cache"))
    path = os.path.join(root, "portbench", "configs", NAME + ".json")
    cfg = config()
    for k in ("nx", "ny"):
        cfg["matrix"][k] = cfg["params"]["Problem"][k] = 16
    cfg["params"]["Preconditioner"]["Number of Levels"] = 3
    with open(path, "w") as f:
        json.dump(cfg, f)
    mix = os.path.join(root, "portbench", "mixes", "resolve.json")
    with open(mix) as f:
        m = json.load(f)
    m["trace_calls"] = 1
    with open(mix, "w") as f:
        json.dump(m, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(HYMLS_PLAN_CACHE="", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", HARNESS_RUN, ROOT, root],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cell_on_three_levels_is_correct(run16):
    assert run16["correct"] and run16["failed"] == 0
    assert run16["compared"]["relres_max"]["limit"] == 1e-10
    assert run16["compared"]["relres_max"]["value"] <= 1e-10
    m = run16["metrics"]
    assert run16["iters"] and m["inner_iters.resolve"]["value"] > 0
    # every solve within 12 of the 16 refinement passes
    assert 1 <= m["refine_passes.resolve"]["value"] <= 12
    assert 0.0 <= m["gmres_capped_share.resolve"]["value"] <= 1.0
    assert m["coarse_unknowns.resolve"]["value"] >= 1
    assert m["plan_device_mb.resolve"]["value"] > 0


def delta(after, before, name):
    return after.get(name, 0) - before.get(name, 0)


def test_counters_count_where_they_should(one_thread):
    """A construction counts its levels; a coarse factorization its
    order; an inner GMRES held to 10 iterations stops at its cap in every
    pass, and a refinement held to 2 passes stops above the tolerance;
    with the cap lifted, neither counts, though the Krylov counter
    exists."""
    K, tv = matrix(8)
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    before = timings.counter_snapshot()
    S = IterativeRefinementSolver(K, params(8, levels=2, inner=10), tv,
                                  max_passes=2, device="cpu")
    built = timings.counter_snapshot()
    assert delta(built, before, "hymls.plan.levels") == 2
    S.compute(K)
    factored = timings.counter_snapshot()
    assert delta(factored, built, "hymls.coarse.unknowns") == \
        S.precond.coarse_plan.n
    assert delta(factored, built, "hymls.coarse.inverse") == 1
    S.solve(b)
    after = timings.counter_snapshot()
    assert delta(after, factored, "hymls.refine.passes") == 2
    assert delta(after, factored, "hymls.gmres.capped") == 2
    assert delta(after, factored, "hymls.refine.capped") == 1
    assert S._last_result.relres > 1e-10

    S = IterativeRefinementSolver(K, params(8, levels=2), tv, device="cpu")
    S.compute(K)
    before = timings.counter_snapshot()
    S.solve(b)
    after = timings.counter_snapshot()
    assert delta(after, before, "hymls.refine.passes") >= 1
    assert "hymls.gmres.capped" in after
    assert delta(after, before, "hymls.gmres.capped") == 0
    assert delta(after, before, "hymls.refine.capped") == 0


def test_cg_counts_a_capped_solve():
    A = torch.diag(torch.arange(1.0, 33.0, dtype=torch.float64))
    b = torch.ones(32, dtype=torch.float64)
    before = timings.counter_snapshot()
    res = krylov.cg(lambda v: A @ v, b, torch.zeros_like(b), tol=1e-12,
                    maxiter=3)
    assert not res.converged and res.iters == 3
    assert delta(timings.counter_snapshot(), before,
                 "hymls.gmres.capped") == 1


@pytest.mark.parametrize("name,counts,value", [
    ("gmres_capped_share.resolve",
     {"hymls.gmres.capped": 3, "hymls.refine.passes": 12}, 0.25),
    ("coarse_unknowns.resolve",
     {"hymls.coarse.unknowns": 600, "hymls.coarse.inverse": 2,
      "hymls.coarse.lu": 1}, 200.0),
    ("warm_polish_share.newton",
     {"hymls.warm.polish": 1, "hymls.warm.fresh": 3}, 0.25)])
def test_new_readers_read_nothing_without_the_counters(name, counts, value,
                                                       monkeypatch):
    read = reader(os.path.join(ROOT, "portbench"), name)
    key = "hymls_tpu_torch.utils.timings"
    without = {k: v for k, v in counts.items()
               if k not in ("hymls.gmres.capped", "hymls.coarse.unknowns",
                            "hymls.warm.polish", "hymls.warm.fresh")}
    monkeypatch.setitem(sys.modules, key, types.SimpleNamespace(
        counter_snapshot=lambda: dict(without)))
    assert read(None) is None
    monkeypatch.delitem(sys.modules, key)
    assert read(None) is None
    monkeypatch.setitem(sys.modules, key, types.SimpleNamespace(
        counter_snapshot=lambda: dict(counts)))
    assert read(None) == value


def test_no_capped_solve_reads_zero(monkeypatch):
    """A program that counts capped solves but capped none: the Krylov
    counter is 0, the refinement's absent, and the share reads 0."""
    read = reader(os.path.join(ROOT, "portbench"),
                  "gmres_capped_share.resolve")
    monkeypatch.setitem(sys.modules, "hymls_tpu_torch.utils.timings",
                        types.SimpleNamespace(counter_snapshot=lambda: {
                            "hymls.gmres.capped": 0,
                            "hymls.refine.passes": 8}))
    assert read(None) == 0.0
