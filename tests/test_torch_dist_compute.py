"""The port's distributed factorization (hymls_tpu_torch.parallel.
dist_compute) on 2 and 4 gloo ranks: per-rank block extraction,
ppermute Schur assembly and owner-local dropping give the replicated
factors stacked into the halo layout (1e-10 relative in f64, as the
JAX package's tests/test_dist_compute.py holds its own), with one
all_gather (the coarse system) and nothing operator-sized gathered; the
halo apply on them equals the replicated apply."""
import pytest

import _torch_parity as TP  # noqa: F401  (one thread; native planners)
import _torch_dist as D

from hymls_tpu_torch.parallel import launch
from hymls_tpu_torch.stencils import create_matrix
from hymls_tpu_torch import Params

# (precond_params args, 'Factor Precision' of an f32 preconditioner, or
# None for f64)
CASES = [(("Laplace", 32, 1), None), (("Laplace", 64, 2), None),
         (("Stokes-C", 32, 2), None),
         (("Stokes-C", 32, 2, "Skew Cartesian", 2, 3), None),
         (("Stokes-C", 32, 2), "Same"), (("Stokes-C", 32, 2), "f64")]
# f64 factors to 1e-10; f32 factors (the all-f32 chain, and f64
# assembly stored in f32) to f32 rounding
TOL = {None: 1e-10, "Same": 1e-5, "f64": 1e-6}
IDS = ["-".join(map(str, c)) + f"-{f}" for c, f in CASES]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    ndev = request.param
    return ndev, launch.run(D.dist_compute, ndev, backend="gloo",
                            device="cpu", args=(CASES,), timeout_s=300)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_dist_factors_match_replicated(ranks, case):
    ndev, out = ranks
    fprec = CASES[case][1]
    for o in out:
        diffs = o[case]["diffs"]
        for k, v in diffs.items():
            if k.endswith(":dtype"):
                assert v == ("torch.float64" if fprec is None
                             else "torch.float32"), k
            else:
                assert v < TOL[fprec], f"{k}: {v:.2e}"


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_dist_factors_compose_with_the_halo_apply(ranks, case):
    ndev, out = ranks
    for o in out:
        assert o[case]["apply"] < 10 * TOL[CASES[case][1]]


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_dist_compute_collectives(ranks, case):
    """One all_gather per factorization (the coarse values), far below
    the operator's size."""
    ndev, out = ranks
    K = create_matrix(Params(D.precond_params(*CASES[case][0])))
    for o in out:
        g = o[case]["gathers"]
        assert g["calls"] == 1
        assert g["bytes"] < 8 * K.nnz // 4
