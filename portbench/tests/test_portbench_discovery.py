"""A configuration, a mix, an end-to-end percentile and a per-layer
metric added as new files and new BENCHMARK.json entries are found by
name, with no edit to any file the benchmark has; mixes of new shapes
(the upstream driver's factorizations x solves with K / (10 f + 1), the
warm recompute) are data files too."""
import filecmp
import json
import os

import pytest

from portbench.tests.helpers import ROOT, run_cpu, tiny_copy

MIXES = {
    # a cold factorization a call, as newton, over a wider Re range
    "newton_wide": {"factor": "compute"},
    # the upstream driver: each factorization of K / (10 f + 1), f = 0, 1,
    # then two solves on it
    "driver2x2": {"factor": "compute", "solves": 2,
                  "scales": [1.0, 1.0 / 11.0]},
    # the warm path: the preconditioner's recompute from the last factors
    "warm": {"factor": "recompute"},
}


def add(root, mix):
    b = os.path.join(root, "portbench")
    with open(os.path.join(b, "configs", "cavity128_Re1000.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "cavity16_Re100"
    cfg["matrix"]["reynolds"] = 100.0
    with open(os.path.join(b, "configs", "cavity16_Re100.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "mixes", mix + ".json"), "w") as f:
        json.dump({"call": "step", "theta_range": [0.5, 1.5],
                   "set_size": 8, "set_seed": 1, "trace_calls": 2,
                   **MIXES[mix]}, f)
    with open(os.path.join(b, "metrics", "iters_max.py"), "w") as f:
        f.write("def read(rec):\n"
                "    return max(c['iters'] for c in rec.calls)\n")
    p = os.path.join(root, "BENCHMARK.json")
    with open(p) as f:
        bench = json.load(f)
    w = "cavity16_Re100." + mix
    bench["configs"].append({"name": "cavity16_Re100", "source": "x",
                             "file": "portbench/configs/cavity16_Re100.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": w, "config": "cavity16_Re100",
                               "traffic": mix, "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "step_p50_s", "unit": "s",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock", "workloads": [w]})
    for m in bench["end_to_end"]:
        if m["name"] == "step_s":
            m["workloads"].append(w)
    bench["per_layer"].append({"name": "iters_max." + mix,
                               "unit": "iters", "better": "lower",
                               "source": "program_counter", "layer": "Krylov",
                               "moves": "step_s", "workloads": [w]})
    bench["per_layer"][0]["workloads"].append(w)  # factor_ms.newton
    with open(p, "w") as f:
        json.dump(bench, f)
    return w


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_new_files_are_found_by_name(tmp_path, mix):
    root = tiny_copy(tmp_path)
    w = add(root, mix)
    solves = MIXES[mix].get("solves", 1)
    out = run_cpu(root, w)
    assert out["correct"] and out["attempted"] % solves == 0
    assert set(out["metrics"]) == {"step_s", "step_p50_s", "setup_s"}
    out = run_cpu(root, w, trace=True)
    assert out["correct"]
    assert set(out["metrics"]) == {"iters_max." + mix, "factor_ms.newton"}
    assert out["metrics"]["iters_max." + mix]["value"] > 0
    # every file the benchmark had is as it was (configs aside, which
    # the copy cuts to 16 x 16)
    cmp = filecmp.dircmp(os.path.join(ROOT, "portbench"),
                         os.path.join(root, "portbench"),
                         ignore=["__pycache__", ".plan_cache", "out",
                                 "configs", "tests"])
    assert not cmp.diff_files and not cmp.left_only
    for sub in ("metrics", "mixes", "matrices", "reference"):
        assert not cmp.subdirs[sub].diff_files
