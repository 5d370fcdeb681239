"""No module of JAX or of the JAX package is loaded by the benchmark, in a
fresh process, by a whole run included; the reference and the input
generator load nothing of the program."""
import json
import os
import subprocess
import sys

from portbench.tests.helpers import ROOT, tiny_copy

BANNED = {"jax", "jaxlib", "flax", "hymls_tpu"}


def loaded_after(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r)\n%s\n"
         "import json; print(json.dumps(sorted({m.split('.')[0] for m in "
         "sys.modules})))" % (ROOT, code)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_and_inputs_load_nothing_of_the_program():
    mods = loaded_after(
        "import portbench.reference.solve, portbench.inputs, "
        "portbench.control, portbench.matrices.stokes_c_2d")
    assert not mods & (BANNED | {"hymls_tpu_torch", "torch"})


def test_a_whole_run_loads_no_jax(tmp_path):
    root = tiny_copy(tmp_path)
    mods = loaded_after(
        "import os; os.environ['HYMLS_PLAN_CACHE'] = ''\n"
        "from portbench.tests.helpers import run_cpu\n"
        f"out = run_cpu({root!r}, 'cavity128_Re1000.newton', trace=True)\n"
        "assert out['correct'], out")
    assert "hymls_tpu_torch" in mods
    assert not mods & BANNED
