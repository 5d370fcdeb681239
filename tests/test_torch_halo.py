"""The halo-exchange DIA SpMV (hymls_tpu_torch.parallel.halo) and the
all-gather V-cycle (parallel.vcycle) on 2 and 4 gloo ranks, against
K @ x and the replicated generic apply, and the port's `topo_order`
against the reference's (tests/test_multichip.py's snake walk)."""
import itertools
import random

import numpy as np
import pytest

import _torch_parity as TP  # noqa: F401  (one thread; native planners)
import _torch_dist as D

from hymls_tpu_torch.parallel import launch
from hymls_tpu_torch.stencils import create_matrix
from hymls_tpu_torch import Params

# (eq, nx, dim): Stokes-C 32^2 (n = 3072, 19 bands) and Laplace 12^3
# (n = 1728, halo 144), both divisible by 2 and 4
DIA_CASES = [("Stokes-C", 32, 2), ("Laplace", 12, 3)]
# the JAX package's all-gather V-cycle test: Laplace 64^2, L = 2
VCYCLE_CASES = [("Laplace", 64, 2), ("Stokes-C", 32, 2)]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    ndev = request.param
    return ndev, launch.run(D.halo_and_gather_vcycle, ndev, backend="gloo",
                            device="cpu", args=(DIA_CASES, VCYCLE_CASES),
                            timeout_s=240)




@pytest.mark.parametrize("case", range(len(DIA_CASES)))
def test_halo_dia_matches_spmv(ranks, case):
    ndev, out = ranks
    eq, nx, dim = DIA_CASES[case]
    K = create_matrix(Params(D.precond_params(eq, nx, 1, dim=dim)))
    halo = int(np.abs(K.tocoo().col - K.tocoo().row).max())
    for r, (dia, _) in enumerate(out):
        rec = dia[case]
        y_ref = K @ rec["x"]
        assert np.abs(rec["y"] - y_ref).max() / np.abs(y_ref).max() < 1e-13
        # halo values to each existing neighbour; the CPU takes the
        # plain version, so no kernel launch is counted
        assert rec["words"] == {"dia_halo": halo * ((r > 0) +
                                                    (r < ndev - 1))}
        assert rec["launches"] == 0


@pytest.mark.parametrize("case", range(len(VCYCLE_CASES)))
def test_gather_vcycle_matches_serial(ranks, case):
    """The all-gather V-cycle equals the replicated generic apply to
    1e-12 relative (the JAX package's test: 1e-12 on Laplace; a rank
    batch of one subdomain rounds otherwise on the CPU), with one
    all_gather per level and direction on the levels the mesh
    divides."""
    ndev, out = ranks
    for _, vc in out:
        assert vc[case]["diff"] < 1e-12
        assert 2 <= vc[case]["all_gather"] <= 4


def test_topo_order_matches_reference():
    from hymls_tpu.parallel.mesh import topo_order as ref_order
    from hymls_tpu_torch.parallel.mesh import topo_order

    class FakeDev:
        def __init__(self, coords):
            self.coords = coords
            self.core_on_chip = 0

    for shape in [(2, 4), (4, 4, 2), (2, 2, 1), (8,)]:
        devs = [FakeDev(c) for c in itertools.product(
            *[range(s) for s in shape])]
        random.Random(0).shuffle(devs)
        walk = [tuple(d.coords) for d in topo_order(devs)]
        assert walk == [tuple(d.coords) for d in ref_order(devs)]
        for a, b in zip(walk, walk[1:]):
            assert sum(abs(x - y) for x, y in zip(a, b)) == 1, (a, b)

    class Plain:
        pass
    plain = [Plain() for _ in range(4)]
    assert topo_order(plain) == plain == ref_order(plain)
