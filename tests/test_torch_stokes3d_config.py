"""The benchmark's 3-D Stokes-C configuration (portbench/configs/
stokes3d_32_L2.json, upstream's stokes2_3D.xml) on the CPU, and the
program's plan-layer spans and apply counters that its cell reads.

- The frozen generator (portbench/matrices/stokes_c_3d.py) is the
  port's `stokes3d` and `create_testvector`, byte for byte.
- At the source's own 16^3, a run of the cell through the benchmark's
  harness is judged correct at the source's tolerance, on the generic
  gather apply, within the source's iteration target.
- At 8^3 on the generic apply the port's solution agrees with SciPy's
  SuperLU and with a dense LU, both in float64.
- The plan spans nest in `hymls.plan`, and the plan and apply counters
  count what happened; the two new readers read nothing from a program
  without these counters."""
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
from torch.profiler import ProfilerActivity, profile

import hymls_tpu_torch.core.preconditioner as TP
from hymls_tpu_torch import Params
from hymls_tpu_torch.core.preconditioner import Preconditioner
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
from hymls_tpu_torch.stencils import create_matrix, create_testvector
from hymls_tpu_torch.utils import timings

from portbench import inputs
from portbench.harness import reader
from portbench.matrices import stokes_c_2d, stokes_c_3d
from portbench.tests.helpers import ROOT

NAME = "stokes3d_32_L2"
CONFIGS = os.path.join(ROOT, "portbench", "configs")


def config():
    with open(os.path.join(CONFIGS, NAME + ".json")) as f:
        return json.load(f)


def params(nx, structured=None, tol=None):
    """The configuration's parameters at nx^3."""
    p = config()["params"]
    for k in ("nx", "ny", "nz"):
        p["Problem"][k] = nx
    if structured is not None:
        p["Preconditioner"]["Structured Apply"] = structured
    if tol is not None:
        p["Solver"]["Iterative Solver"]["Convergence Tolerance"] = tol
    return Params(p)


def matrix(nx):
    fam = stokes_c_3d.family({"nx": nx, "ny": nx, "nz": nx})
    return sp.csr_matrix((fam["v0"], fam["indices"], fam["indptr"]),
                         shape=(fam["n"], fam["n"])), fam["testvector"]


@pytest.mark.parametrize("nx", [8, 16])
def test_frozen_generator_is_the_ports(nx):
    p = params(nx)
    K = create_matrix(p)
    fam = stokes_c_3d.family({"nx": nx, "ny": nx, "nz": nx})
    assert np.array_equal(fam["indptr"], K.indptr)
    assert np.array_equal(fam["indices"], K.indices)
    assert np.array_equal(fam["v0"], K.data)
    assert not fam["v1"].any() and fam["theta"] == 0.0
    assert np.array_equal(fam["testvector"], create_testvector(p, K))


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
    assert cfg["reduced"] == [] and "Structured Apply" not in \
        cfg["params"]["Preconditioner"]
    grid = [cfg["params"]["Problem"][k] for k in ("nx", "ny", "nz")]
    assert grid == [cfg["matrix"][k] for k in ("nx", "ny", "nz")] == \
        [32] * 3
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert {"name": NAME, "file": f"portbench/configs/{NAME}.json"}.items() \
        <= {c["name"]: c for c in bench["configs"]}[NAME].items()


# One run of the cell at 16^3 through the harness, in a fresh process:
# the harness refuses to run where JAX is loaded, as it is in the test
# process.  A wrapper records every solve's inner iterations.
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

out = harness.run(sys.argv[2], "stokes3d_32_L2.resolve", 2 ** 31 + 11, 0.5,
                  True, device="cpu", wrap=Recorded)
out["iters"] = iters
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def run16(tmp_path_factory):
    """The cell's result object at the source's 16^3, traced."""
    root = str(tmp_path_factory.mktemp("bench16"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__",
                                                  ".plan_cache"))
    path = os.path.join(root, "portbench", "configs", NAME + ".json")
    cfg = config()
    for k in ("nx", "ny", "nz"):
        cfg["matrix"][k] = cfg["params"]["Problem"][k] = 16
    with open(path, "w") as f:
        json.dump(cfg, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(HYMLS_PLAN_CACHE="", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", HARNESS_RUN, ROOT, root],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cell_at_the_source_size_is_correct_on_the_generic_apply(run16):
    assert run16["correct"] and run16["failed"] == 0
    assert run16["compared"]["relres_max"]["limit"] == 1e-8
    assert run16["compared"]["relres_max"]["value"] <= 1e-8
    m = run16["metrics"]
    assert m["apply_generic_share.resolve"]["value"] == 1.0
    assert m["apply_graph_share.resolve"]["value"] == 0.0   # the CPU
    # the source's target (Targets: Number of Iterations) is 145
    assert run16["iters"] and max(run16["iters"]) <= 145
    assert m["inner_iters.resolve"]["value"] <= 145
    assert 1 <= m["refine_passes.resolve"]["value"] <= 16
    assert m["plan_device_mb.resolve"]["value"] > 0


def test_generic_solve_agrees_with_superlu_and_a_dense_lu():
    """K is singular: the pressure is fixed up to a constant (a closed
    box), so each solution is held to the other with that constant taken
    out.  On the rest, ||x - x_ref|| / ||x_ref|| <= kappa * relres, with
    kappa = 2.5e5 the ratio of K's largest to its smallest nonzero
    singular value at 8^3 (numpy.linalg.svd) and relres the port's own
    at 1e-12; the f64 references sit near kappa * 1e-16.  The bound
    below is kappa * 1e-12, with the port's relres checked under it."""
    torch.set_num_threads(1)
    K, tv = matrix(8)
    p = params(8, structured=False, tol=1e-12)
    S = IterativeRefinementSolver(K, p, testvector=tv, device="cpu")
    assert S.precond._structured is None
    b = K @ np.random.default_rng(7).standard_normal(K.shape[0])
    S.compute(K)
    x = S.solve(b).numpy()
    assert np.linalg.norm(b - K @ x) <= 1e-12 * np.linalg.norm(b)
    null = np.zeros(K.shape[0])
    null[3::4] = 1.0 / np.sqrt(K.shape[0] // 4)
    assert np.linalg.norm(K @ null) < 1e-12

    def off_null(v):
        return v - (v @ null) * null
    superlu = spla.splu(K.tocsc()).solve(b)
    dense = torch.linalg.solve(torch.as_tensor(K.toarray()),
                               torch.as_tensor(b)).numpy()
    for ref in (superlu, dense):
        assert np.linalg.norm(off_null(x - ref)) <= \
            2.5e5 * 1e-12 * np.linalg.norm(off_null(ref))


@pytest.mark.parametrize("structured", ["Auto", False])
def test_plan_and_apply_counters_and_spans(structured, tmp_path,
                                           monkeypatch):
    """One construction builds and stores, a second loads; every apply
    counts once under the program its tree runs; the plan spans nest
    inside `hymls.plan`."""
    monkeypatch.setenv("HYMLS_PLAN_CACHE", str(tmp_path))
    monkeypatch.setattr(TP, "PLAN_CACHE_MIN_BUILD_S", 0.0)
    K, tv = matrix(8)
    p = params(8, structured=structured)
    before = timings.counter_snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        P = Preconditioner(K, p, testvector=tv, dtype=torch.float32,
                           device="cpu")
    built = timings.counter_snapshot()
    P2 = Preconditioner(K, p, testvector=tv, dtype=torch.float32,
                        device="cpu")
    loaded = timings.counter_snapshot()

    def delta(a, b, name):
        return a.get(name, 0) - b.get(name, 0)
    assert delta(built, before, "hymls.plan.builds") == 1
    assert delta(built, before, "hymls.plan.cache_loads") == 0
    assert delta(loaded, built, "hymls.plan.builds") == 0
    assert delta(loaded, built, "hymls.plan.cache_loads") == 1
    assert not P.plan_from_cache and P2.plan_from_cache
    ts = {id(t): t for t in TP._tensors(
        (P.factor_plans, P.generic_plans, P.extra_plan), [])}
    nbytes = sum(t.numel() * t.element_size() for t in ts.values())
    assert delta(built, before, "hymls.plan.device_bytes") == nbytes > 0
    assert delta(loaded, built, "hymls.plan.device_bytes") == nbytes

    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("hymls.plan"):
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert set(ranges) == {"hymls.plan", "hymls.plan.cache_load",
                           "hymls.plan.build", "hymls.plan.cache_store",
                           "hymls.plan.device"}
    (lo, hi), = ranges["hymls.plan"]
    assert all(lo <= s and t <= hi for name, rs in ranges.items()
               for s, t in rs)

    P.compute(K)
    mine = "generic" if structured is False else "structured"
    other = "structured" if structured is False else "generic"
    assert (P._structured is None) == (structured is False)
    before = timings.counter_snapshot()
    b = torch.ones(3, K.shape[0])
    for v in (b[0], b):
        P.apply_fn(P.factors, v)
    after = timings.counter_snapshot()
    assert delta(after, before, "hymls.apply." + mine) == 2
    assert delta(after, before, "hymls.apply." + other) == 0


def test_newton2x2_alternates_the_two_scales():
    with open(os.path.join(ROOT, "portbench", "mixes",
                           "newton2x2.json")) as f:
        mix = json.load(f)
    assert (mix["factor"], mix["solves"], mix["call"]) == \
        ("compute", 2, "step")
    mix["set_size"] = 4
    pool = inputs.Pool(stokes_c_2d.family({"nx": 8, "ny": 8,
                                           "reynolds": 0.0}), mix, 2 ** 33)
    K = pool.mat(0) / pool.scales[0]
    for k in range(8):
        s = mix["scales"][k % 2]
        assert abs((pool.mat(k) - s * K)).max() == 0.0
        b0, b1 = pool.rhs(k, 0), pool.rhs(k, 1)
        assert not np.array_equal(b0, b1)
    assert mix["scales"][1] == 1.0 / 11.0


@pytest.mark.parametrize("name", ["apply_generic_share.resolve",
                                  "plan_device_mb.resolve"])
def test_readers_read_nothing_without_the_counters(name, monkeypatch):
    read = reader(os.path.join(ROOT, "portbench"), name)
    key = "hymls_tpu_torch.utils.timings"
    monkeypatch.setitem(sys.modules, key, types.SimpleNamespace(
        counter_snapshot=lambda: {"hymls.apply.eager": 3}))
    assert read(None) is None
    monkeypatch.delitem(sys.modules, key)
    assert read(None) is None
    monkeypatch.setitem(sys.modules, key, types.SimpleNamespace(
        counter_snapshot=lambda: {
            "hymls.apply.generic": 3, "hymls.apply.structured": 1,
            "hymls.plan.builds": 1, "hymls.plan.cache_loads": 1,
            "hymls.plan.device_bytes": 4_000_000}))
    assert read(None) == {"apply_generic_share.resolve": 0.75,
                          "plan_device_mb.resolve": 2.0}[name]
