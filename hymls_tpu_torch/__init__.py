"""hymls_tpu_torch — the PyTorch/CUDA port of the hymls_tpu solver.

The same hybrid multilevel method (hybrid direct/iterative multilevel
solver for F-matrices of incompressible Navier-Stokes / Stokes / Darcy /
Laplace problems on structured staggered grids) as the JAX package
`hymls_tpu`, which stays beside it as the reference:

  * The host-side symbolic setup (config, grid, stencils, partition,
    core/plan, native) is a byte-identical copy of the JAX package's
    numpy modules, so both packages build identical plans.
  * The numerics (factorization, V-cycle apply, Krylov loops, the
    mixed-precision refinement) are plain torch functions on tensors
    held by the operator / preconditioner / solver classes.
  * The one TPU kernel on the main path, the DIA SpMV, is a
    hand-written CUDA kernel (csrc/dia_spmv.cu, ops/dia_spmv.py).

Every public constructor takes `device=`; nothing here picks a device.
The entry points (`python -m hymls_tpu_torch.driver`, `python -m
hymls_tpu_torch.matlab_bridge`) run on the card unless `--device cpu`
asks otherwise.
"""
from .utils import malloc as _malloc

_malloc.maybe_enable_from_env()

import torch as _torch  # noqa: E402

# TRUE-f32 products everywhere, the twin of hymls_tpu/__init__.py's
# 'highest' matmul precision: on Hopper an f32 matmul may otherwise run
# in TF32 (10-bit mantissa), the GPU analogue of the TPU's one-pass
# bf16 lowering that took stokes128 L=2 from 150 to 558 inner
# iterations in the reference.  For a linear solver that is a
# correctness bug, not a speed knob.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import Params, load_xml  # noqa: E402
from .solvers.solver import Solver  # noqa: E402
from .core.preconditioner import Preconditioner  # noqa: E402

__all__ = ["Params", "load_xml", "Solver", "Preconditioner"]
__version__ = "0.1.0"
