"""A cell's inputs: the matrices K and right-hand sides b = K x that the
mix's calls take, NumPy only, all made in set-up.

A mix is a data file (`mixes/<name>.json`) that this one generator reads:

- `factor`: how a call factors.  `"setup"`: once, in set-up, on
  K(theta) of the configuration, and never in the window; `"compute"`:
  a cold factorization of the call's matrix first in every call;
  `"recompute"`: the warm one (the preconditioner's recompute);
- `solves`: solves per call, each on its own b (default 1);
- `scales`: call k's matrix is scales[k mod len(scales)] K(theta_j), as
  the upstream driver scales its f-th factorization by 1 / (10 f + 1)
  (default [1]; with `"setup"`, only the first counts);
- `theta_range`, `set_size`, `set_seed`: the set.  Entry j is theta_j =
  theta * U(lo, hi) (around the configuration's continuation parameter,
  the Reynolds number) and `solves` vectors x_ji ~ N(0, 1);
- `call`: the name of the end-to-end metrics (`<call>_s`, ...);
- `trace_calls`: calls under the profiler in a traced run.

Every seed gets the same set, drawn from `set_seed`; the run's seed only
orders it: call k takes the k-th entry of a stream of permutations of
the set, one permutation a pass.  So the work of a window is the same
from seed to seed (how hard a solve is depends on b), and no input
repeats within a pass of the set.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import scipy.sparse as sp


def load_module(path: str, name: str):
    """The module in the file `path`, loaded under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(bench_dir: str, cfg: dict) -> dict:
    """The configuration's matrix family from the generator its file
    names (`matrices/<generator>.py`)."""
    m = cfg["matrix"]
    gen = load_module(os.path.join(bench_dir, "matrices",
                                   m["generator"] + ".py"),
                      "portbench_matrix_" + m["generator"])
    return gen.family(m)


FACTOR = ("setup", "compute", "recompute")


class Pool:
    """The inputs of one run: the mix's set, in the seed's order, with
    every matrix and right-hand side a call takes built in set-up."""

    def __init__(self, fam: dict, mix: dict, seed: int):
        self.fam = fam
        self.n = n = fam["n"]
        self.factor = mix["factor"]
        if self.factor not in FACTOR:
            raise ValueError(f"factor {self.factor!r} is not one of {FACTOR}")
        self.solves = int(mix.get("solves", 1))
        scales = [float(s) for s in mix.get("scales", [1.0])]
        self.scales = scales[:1] if self.factor == "setup" else scales
        m = int(mix["set_size"])
        lo, hi = mix["theta_range"]
        rng = np.random.default_rng(int(mix["set_seed"]))
        thetas = fam["theta"] * rng.uniform(lo, hi, m)
        X = rng.standard_normal((m, self.solves, n))
        if self.factor == "setup":
            thetas[:] = fam["theta"]
        self.set_thetas = thetas
        # K(theta_j) s for each entry and scale, on the shared pattern,
        # and its b = K x for each of the entry's vectors
        self._mats, self._rhs = {}, {}
        for j, th in enumerate(thetas):
            for si, s in enumerate(self.scales):
                K = self._mats[0, 0] if self.factor == "setup" and j \
                    else self.matrix(th, s)
                self._mats[j, si] = K
                self._rhs[j, si] = np.ascontiguousarray((K @ X[j].T).T)
        self._order_rng = np.random.default_rng(seed % 2 ** 64)
        self._order = np.zeros(0, dtype=np.int64)

    def index(self, k: int) -> int:
        """The set entry that call k takes."""
        m = self.set_thetas.size
        while self._order.size <= k:
            self._order = np.concatenate([self._order,
                                          self._order_rng.permutation(m)])
        return int(self._order[k])

    def key(self, k: int):
        return self.index(k), k % len(self.scales)

    def setup_matrix(self) -> sp.csr_matrix:
        """The matrix set-up factors."""
        return self._mats[0, 0]

    def mat(self, k: int) -> sp.csr_matrix:
        """Call k's matrix."""
        return self._mats[self.key(k)]

    def rhs(self, k: int, i: int = 0) -> np.ndarray:
        """Call k's i-th right-hand side."""
        return self._rhs[self.key(k)][i]

    def every_input(self):
        """Each distinct matrix of the set once, with every right-hand
        side that calls take on it: [(K, [b, ...])]."""
        out = {}
        for key, K in self._mats.items():
            out.setdefault(id(K), (K, []))[1].extend(self._rhs[key])
        return list(out.values())

    def matrix(self, theta: float, scale: float = 1.0) -> sp.csr_matrix:
        """scale K(theta) as CSR, float64, on the fixed pattern (one axpy
        of its two value arrays)."""
        v = self.fam["v0"] + theta * self.fam["v1"]
        if scale != 1.0:
            v *= scale
        return sp.csr_matrix((v, self.fam["indices"], self.fam["indptr"]),
                             shape=(self.n, self.n))
