"""A run's check says `correct` false when the timed path is broken
underneath it, and true when it is sound: the harness driven on the CPU
at 16 x 16, past its look for a card, with the program wrapped.  The
faults a cell of one caller on one card can have: an answer altered where
it is produced; a step that returns its state unchanged (a refactor that
keeps the old matrix, a solve that returns the last answer); and the
lower-precision control (the reference solve in float32) in the
program's place."""
import numpy as np
import pytest
import torch

from portbench.reference import solve as ref
from portbench.tests.helpers import run_cpu, tiny_copy

NEWTON, RESOLVE = "cavity128_Re1000.newton", "stokes2_128_L3.resolve"


class Broken:
    """S with one fault planted."""

    def __init__(self, S, fault):
        self.S, self.fault = S, fault
        self.precond = S.precond
        self.last = None
        self.K = None

    @property
    def num_iter(self):
        return self.S.num_iter

    def compute(self, K=None):
        self.K = K
        if self.fault != "keep_matrix" or self.last is None:
            self.S.compute(K)
        return self

    def solve(self, b):
        if self.fault == "control_f32":
            return torch.as_tensor(ref.solve(self.K, b, np.float32))
        x = self.S.solve(b)
        if self.fault == "altered":
            x = x.clone()
            x[x.shape[0] // 2] += 1e-9 * float(x.abs().max())
        elif self.fault == "stale" and self.last is not None:
            x = self.last
        self.last = x
        return x


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("workload", [NEWTON, RESOLVE])
def test_sound_run_is_correct(root, workload):
    out = run_cpu(root, workload)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["compared"]["relres_max"]["value"] <= 1e-12
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("workload,fault", [
    (NEWTON, "altered"), (RESOLVE, "altered"),
    (NEWTON, "keep_matrix"), (RESOLVE, "stale"),
    (NEWTON, "control_f32"), (RESOLVE, "control_f32")])
def test_broken_path_is_not_correct(root, workload, fault):
    out = run_cpu(root, workload, wrap=lambda S: Broken(S, fault))
    assert not out["correct"]
    assert out["failed"] >= out["attempted"] - 1 > 0
    assert out["compared"]["relres_max"]["value"] > 1e-12
