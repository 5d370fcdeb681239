"""The port's dense matvec (K2) and loop-pathology probe against the
JAX package's tools/loop_pathology_bench.py.

On the CPU `dense_matvec` runs its plain torch version and counts no
launch; the reference's Pallas kernel `pl_matvec` runs unmodified in
Pallas's TPU interpret mode.  The CUDA kernel itself is held against
the plain version by the `cuda`-marked test below (skipped without a
card) and by chip_smoke.py on the card.  Tolerance: 1e-5 relative to
max|y| in f32 (another summation order than the reference's dot).
"""
import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import torch

from hymls_tpu_torch.ops.dense_matvec import (dense_matvec,
                                              dense_matvec_reference)
from hymls_tpu_torch.tools import loop_pathology_bench as tlp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture
def ref_tool():
    """tools/loop_pathology_bench.py loaded as a module.  Its import
    sets the JAX compilation-cache options; they are restored after the
    test."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    prev = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "_ref_loop_pathology_bench",
        os.path.join(ROOT, "tools", "loop_pathology_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
        yield mod
    finally:
        for k, v in prev.items():
            jax.config.update(k, v)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(ref - np.asarray(got, np.float64)).max()
                 / max(np.abs(ref).max(), 1e-300))


def _operands(n, seed):
    rng = np.random.default_rng(seed)
    M = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    x = rng.standard_normal((n, 1)).astype(np.float32)
    return M, x


@pytest.mark.parametrize("n", [512, 2048])
def test_plain_version_matches_pallas_interpret(ref_tool, n):
    M, x = _operands(n, seed=n)
    with pltpu.force_tpu_interpret_mode():
        y_ref = np.asarray(ref_tool.pl_matvec(jnp.asarray(M),
                                              jnp.asarray(x)))
    before = dense_matvec.launches
    y = dense_matvec(torch.as_tensor(M), torch.as_tensor(x))
    assert dense_matvec.launches == before
    assert y.shape == (n, 1) and y.dtype == torch.float32
    assert _rel(y_ref, y) <= TOL
    assert torch.equal(y, dense_matvec_reference(torch.as_tensor(M),
                                                 torch.as_tensor(x)))


def test_operands_match_reference(ref_tool):
    """The probe's M1, M2, x are the reference's, bit for bit."""
    ref = [np.asarray(a) for a in ref_tool._mats()]
    ours = tlp.make_operands(ref_tool.N, device="cpu")
    for a, b in zip(ref, ours):
        assert a.shape == tuple(b.shape)
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("variant", list(tlp.BODIES))
def test_probe_body_matches_reference(ref_tool, variant):
    """One iteration of each probe variant on the CPU against one
    iteration of the reference's loop with the matching body (xla1/
    xla2, pallas1/pallas2 in interpret mode, the redispatched step)."""
    n = 256
    M1, x = _operands(n, seed=1)
    M2, _ = _operands(n, seed=2)
    pl_mv = ref_tool.pl_matvec
    ref_body = {
        "torch1": lambda a, b, v: a @ v,
        "torch2": lambda a, b, v: b @ (a @ v),
        "kernel1": lambda a, b, v: pl_mv(a, v),
        "kernel2": lambda a, b, v: pl_mv(b, pl_mv(a, v)),
        "redispatch": lambda a, b, v: b @ (a @ v),
    }[variant]
    with pltpu.force_tpu_interpret_mode():
        y_ref = np.asarray(ref_tool._loop(ref_body)(
            jnp.asarray(M1), jnp.asarray(M2), jnp.asarray(x), 1))
    y = tlp.step(variant, torch.as_tensor(M1), torch.as_tensor(M2),
                 torch.as_tensor(x))
    assert _rel(y_ref, y) <= TOL


def test_iterate_tolerance_separates_rounding_from_a_wrong_row():
    """The probe's final-iterate check (ITERATE_TOL): over 10 + ITERS
    two-matvec iterations at n = 2048, a body summed in another order
    (f64, rounded to f32 per matvec) stays within the tolerance of the
    f32 torch body, and a body that scales one row by 1 + 2e-3 does
    not."""
    M1, M2, x = tlp.make_operands(device="cpu")

    def exact(a, b, v):
        y = (a.double() @ v.double()).float()
        return (b.double() @ y.double()).float()

    def wrong_row(a, b, v):
        y = b @ (a @ v)
        y[0] *= 1 + 2e-3
        return y

    outs = {}
    for name, body in (("torch2", tlp.BODIES["torch2"]), ("kernel2", exact),
                       ("kernel1", wrong_row)):
        v = x
        for _ in range(tlp.WARM_ITERS + tlp.ITERS):
            y = body(M1, M2, v)
            v = y / torch.linalg.norm(y)
        outs[name] = v
    outs["torch1"] = outs["torch2"]
    gaps = tlp.iterate_gaps(outs)
    assert gaps["kernel2"] <= tlp.ITERATE_TOL
    assert gaps["kernel1"] > tlp.ITERATE_TOL


@pytest.mark.parametrize("bad", ["square", "shape", "dtype", "layout"])
def test_wrapper_rejects_bad_input(bad):
    n = 8
    M = torch.zeros((n, n))
    x = torch.zeros(n)
    if bad == "square":
        M = torch.zeros((n, n + 1))
    elif bad == "shape":
        x = torch.zeros(n + 1)
    elif bad == "dtype":
        M, x = M.double(), x.double()
    else:
        M = torch.zeros((n, n)).T
    with pytest.raises((ValueError, TypeError)):
        dense_matvec(M, x)


def test_probe_needs_a_card(monkeypatch):
    """The probe measures the GPU only: without CUDA it stops."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tlp.main([])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 2047, 300, 1])
def test_cuda_kernel_matches_plain_version(cuda_device, n):
    """The hand-written kernel on the card against the plain version,
    on the probe's shape and on ragged ones (float4 and scalar paths)."""
    M, x = _operands(n, seed=3)
    Mt = torch.as_tensor(M, device=cuda_device)
    xt = torch.as_tensor(x[:, 0], device=cuda_device)
    before = dense_matvec.launches
    y = dense_matvec(Mt, xt)
    torch.cuda.synchronize()
    assert dense_matvec.launches == before + 1
    assert y.shape == (n,)
    assert _rel(dense_matvec_reference(Mt, xt).cpu(), y.cpu()) <= TOL
