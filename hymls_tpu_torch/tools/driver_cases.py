"""The driver's configurations as chip_smoke.py and the tests run them.

`driver_params` loads configs/<name>.xml with either package's
`load_xml`; `refined_matrices` builds every matrix a config's refinement
loop solves with; `eigen_results` records the eigenvalue results that
the driver's report drops, and `constructed` the preconditioners and
solvers it builds.  The modules of the package under test are
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

#: the rest of the reference's config suite that builds its own matrix
#: (tests/test_suite_parity.py): the configs it runs in tier-1, ...
SUITE_TIER1 = ("stokes4", "stokes4_3D", "stokes5", "stokes_L",
               "stokes_THCM", "deflation1_bordering",
               "laplace1_eigs_deflation", "laplace_eigs", "neumann")
#: ... and those it marks slow
SUITE_SLOW = ("stokes6", "stokes_L3", "stokes_L4", "stokes_THCM3",
              "stokes_THCM4", "laplace2_eigs", "darcy", "convdiff")
#: the configs chip_smoke.py phase 27, tests/test_torch_suite.py and
#: `tests/_torch_anchors.py 27` run
SUITE_CONFIGS = SUITE_TIER1 + SUITE_SLOW


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


@contextlib.contextmanager
def constructed(driver):
    """Records, in the dict it yields, every `Preconditioner` ("P") and
    `Solver` ("S") that the module `driver` (either package's driver)
    constructs while the context is open, in order."""
    got = {"P": [], "S": []}
    classes = {"P": driver.Preconditioner, "S": driver.Solver}

    def recorder(key):
        def make(*a, **k):
            got[key].append(classes[key](*a, **k))
            return got[key][-1]
        return make
    driver.Preconditioner, driver.Solver = recorder("P"), recorder("S")
    try:
        yield got
    finally:
        driver.Preconditioner, driver.Solver = classes["P"], classes["S"]
