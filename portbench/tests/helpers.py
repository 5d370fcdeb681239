"""What the benchmark's tests share: a copy of the benchmark cut to a
size the CPU runs in seconds, and a run of it on the CPU."""
from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NX = 16


def tiny_copy(tmp_path, nx: int = NX) -> str:
    """BENCHMARK.json and portbench/ copied under tmp_path, every
    configuration at nx x nx (stokes2 at two levels, as 16 x 16 holds);
    returns the copy's root."""
    root = os.path.join(str(tmp_path), "bench")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".plan_cache",
                                                  "out"))
    cdir = os.path.join(root, "portbench", "configs")
    for f in os.listdir(cdir):
        if not f.endswith(".json"):
            continue
        p = os.path.join(cdir, f)
        with open(p) as fh:
            c = json.load(fh)
        c["matrix"]["nx"] = c["matrix"]["ny"] = nx
        c["params"]["Problem"]["nx"] = c["params"]["Problem"]["ny"] = nx
        pre = c["params"]["Preconditioner"]
        pre["Number of Levels"] = min(pre["Number of Levels"], 2)
        with open(p, "w") as fh:
            json.dump(c, fh)
    return root


def run_cpu(root: str, workload: str, trace: bool = False,
            seconds: float = 0.5, seed: int = 2 ** 31 + 17, wrap=None):
    """One run of `workload` of the copy at `root` on the CPU."""
    import torch
    from portbench import harness
    torch.set_num_threads(1)
    return harness.run(root, workload, seed, seconds, trace, device="cpu",
                       wrap=wrap)
