"""hymls_tpu_torch imports without JAX, pins true-f32 products, and
carries byte-identical copies of the JAX package's host modules."""
import os
import subprocess
import sys

import pytest
import torch

import hymls_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOST_COPIES = ("config.py", "grid.py",
               "stencils/__init__.py", "stencils/generators.py",
               "stencils/navier_stokes.py",
               "partition/__init__.py", "partition/cartesian.py",
               "partition/skew.py", "partition/hierarchical.py",
               "core/plan.py",
               "native/__init__.py", "native/mmio.cpp",
               "native/planner.cpp")


def test_imports_without_jax():
    """With `jax` blocked in sys.modules every port module imports."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import hymls_tpu_torch, hymls_tpu_torch.solvers.mixed\n"
        "import hymls_tpu_torch.convert, hymls_tpu_torch.ops.dia_spmv\n"
        "import hymls_tpu_torch.core.structured\n"
        "import hymls_tpu_torch.tools.loop_pathology_bench\n"
        "import hymls_tpu_torch.nonlinear\n"
        "import hymls_tpu_torch.ops.operators\n"
        "import hymls_tpu_torch.solvers.deflation\n"
        "import hymls_tpu_torch.solvers.complex_solver\n"
        "import hymls_tpu_torch.solvers.eigen\n"
        "assert not any(m == 'hymls_tpu' or m.startswith('hymls_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_true_f32_pin():
    assert hymls_tpu_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copy_is_byte_identical(rel):
    with open(os.path.join(ROOT, "hymls_tpu", rel), "rb") as f:
        ref = f.read()
    with open(os.path.join(ROOT, "hymls_tpu_torch", rel), "rb") as f:
        assert f.read() == ref
