"""The warm cell (`cavity128_Re1000.warm`, mix `warm`): newton's set
through the preconditioner's recompute.  On the CPU at 16 x 16 every
call refactors through `recompute`, never `compute`; from the second
call on the factorization starts from the previous factors, and every
answer is correct at the configuration's 1e-12."""
import json
import os

from portbench.tests.helpers import ROOT, run_cpu, tiny_copy


def test_mix_is_newton_through_the_recompute():
    d = os.path.join(ROOT, "portbench", "mixes")
    with open(os.path.join(d, "newton.json")) as f:
        newton = json.load(f)
    with open(os.path.join(d, "warm.json")) as f:
        warm = json.load(f)
    assert warm["factor"] == "recompute" and warm["set_seed"] == 20260104
    same = ("call", "solves", "scales", "theta_range", "set_size",
            "trace_calls")
    assert {k: warm[k] for k in same} == {k: newton[k] for k in same}


def test_every_call_refactors_warm(tmp_path):
    root = tiny_copy(tmp_path)
    made = []

    def record(S):
        P = S.precond
        compute, factorize = P.compute, P.factorize

        def no_compute(*a, **kw):
            made.append("compute")
            return compute(*a, **kw)

        def spied(vals, prev=None, *a, **kw):
            made.append("cold" if prev is None else "warm")
            return factorize(vals, prev, *a, **kw)
        P.compute, P.factorize = no_compute, spied
        return S

    out = run_cpu(root, "cavity128_Re1000.warm", trace=True, wrap=record)
    assert out["correct"] and out["failed"] == 0
    assert out["compared"]["relres_max"]["limit"] == 1e-12
    assert out["compared"]["relres_max"]["value"] <= 1e-12
    # one factorization per call, set-up's two warm calls included: the
    # first cold (no factors yet), the others warm from the previous ones
    assert "compute" not in made
    assert made[0] == "cold" and len(made) == out["attempted"] + 2 >= 5
    assert set(made[1:]) == {"warm"}
    assert {"factor_ms.newton", "inner_iters.newton",
            "refine_passes.newton"} <= set(out["metrics"])
    # the warm inverses' gates were read, and counted by branch
    assert 0.0 <= out["metrics"]["warm_polish_share.newton"]["value"] <= 1.0
