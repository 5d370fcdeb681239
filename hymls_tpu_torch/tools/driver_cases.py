"""The driver's configurations as chip_smoke.py and the tests run them.

`driver_params` loads configs/<name>.xml with either package's
`load_xml`; `refined_matrices` builds every matrix a config's refinement
loop solves with; `eigen_results` records the eigenvalue results that
the driver's report drops.  The modules of the package under test are
passed in, so this module imports neither package's driver.
"""
from __future__ import annotations

import contextlib
import os

#: the repository's configs directory
CONFIGS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")

#: the configs chip_smoke.py phase 22 runs at their own sizes and depths
DRIVER_CONFIGS = ("laplace1", "stokes2", "bordering1", "deflation1",
                  "laplace1_eigs", "stokes2_3D")


def driver_params(load, name, override=None):
    """configs/<name>.xml as `load` reads it; stokes2_3D builds its
    matrix, since its dataset is not in the repository.  `override` is
    ((sublist, ..., key), value)."""
    p = load(os.path.join(CONFIGS_DIR, f"{name}.xml"))
    if name == "stokes2_3D":
        p.sublist("Driver")["Read Linear System"] = False
    if override is not None:
        path, value = override
        q = p
        for k in path[:-1]:
            q = q.sublist(k)
        q[path[-1]] = value
    return p


def refined_matrices(driver, params):
    """(Params, K) of every refinement of `params`, as `driver` (the
    port's driver module) builds them."""
    return [(p, driver.get_linear_system(p)[0])
            for p in driver.refinements(params)]


@contextlib.contextmanager
def eigen_results(eigen):
    """Records, in the list it yields, the result of every `JDQR.solve`
    and `shift_invert_eigs` call of the module `eigen` (either package's
    solvers.eigen) made while the context is open."""
    got = []
    jd_solve, si = eigen.JDQR.solve, eigen.shift_invert_eigs

    def solve(self, *a, **k):
        got.append(jd_solve(self, *a, **k))
        return got[-1]

    def shift_invert(*a, **k):
        got.append(si(*a, **k))
        return got[-1]
    eigen.JDQR.solve, eigen.shift_invert_eigs = solve, shift_invert
    try:
        yield got
    finally:
        eigen.JDQR.solve, eigen.shift_invert_eigs = jd_solve, si
