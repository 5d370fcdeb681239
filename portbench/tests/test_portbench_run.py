"""The command: without a card, or without the program beside it, it
exits non-zero and prints no result; on a card (the `cuda` test) it runs
a short cell and prints a correct result line."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests.helpers import ROOT

CMD = ["portbench/run.py", "--workload", "stokes2_128_L3.resolve",
       "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace"]


def run(cwd, trace=0, timeout=600):
    return subprocess.run([sys.executable, *CMD, str(trace)], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")


def test_exits_without_a_card(no_card):
    out = run(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA card" in out.stderr


def test_exits_without_the_program(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__",
                                                  ".plan_cache"))
    out = run(root)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_cell_on_the_card(card, trace):
    out = run(ROOT, trace)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    if trace:
        assert res["device"]["busy_s"] > 0 and "breakdown" in res
        assert res["metrics"]["k1_gbps.resolve"]["value"] > 0
    assert out.stderr.strip().splitlines()[-1].startswith("compared")
