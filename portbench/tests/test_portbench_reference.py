"""The reference's judgement accepts the port's solve and the reference
solve in float64, and rejects the lower-precision control (the reference
solve in float32), at 16 x 16 and 32 x 32."""
import numpy as np
import pytest
import torch

from hymls_tpu_torch import Params
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
from portbench import control
from portbench.matrices import stokes_c_2d
from portbench.reference import solve as ref
from portbench.tests.helpers import tiny_copy

LIMIT = 1e-12


def params(nx):
    return Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2, "nx": nx,
                    "ny": nx},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Iterative Solver": {"Maximum Iterations": 250,
                                        "Convergence Tolerance": LIMIT}},
        "Preconditioner": {"Partitioner": "Cartesian",
                           "Separator Length": 4, "Number of Levels": 1}})


@pytest.mark.parametrize("nx", [16, 32])
def test_judge_accepts_the_port_and_rejects_the_control(nx):
    torch.set_num_threads(1)
    K = stokes_c_2d.cavity_jacobian(nx, nx, 1000.0)
    b = K @ np.random.default_rng(nx).standard_normal(K.shape[0])
    S = IterativeRefinementSolver(K, params(nx),
                                  testvector=stokes_c_2d.testvector(K),
                                  device="cpu")
    S.compute()
    port = ref.relres(K, S.solve(b).numpy(), b)
    f64 = ref.relres(K, ref.solve(K, b, np.float64), b)
    f32 = ref.relres(K, ref.solve(K, b, np.float32), b)
    assert port <= LIMIT and f64 <= LIMIT
    assert f32 > 1e3 * LIMIT
    x = S.solve(b).numpy()
    x[0] += 1e-9 * np.abs(x).max()
    assert ref.relres(K, x, b) > LIMIT
    assert ref.relres(K, np.full_like(x, np.nan), b) == float("inf")


def test_control_readings_fail_and_the_reference_passes(tmp_path):
    root = tiny_copy(tmp_path)
    for w in ("cavity128_Re1000.newton", "stokes2_128_L3.resolve"):
        lo = control.readings(root, w, "float32")
        hi = control.readings(root, w, "float64")
        assert lo["answers"] == hi["answers"] == 64
        assert lo["matrices"] == (64 if w.endswith("newton") else 1)
        assert lo["fails_limit"] == 64 and lo["relres_min"] > 1e3 * LIMIT
        assert hi["fails_limit"] == 0
