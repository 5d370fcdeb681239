"""Run a function on several ranks, one process each, and collect the
results: what the tests and chip_smoke.py use to drive the distributed
paths.

    results = run(fn, 4, backend="gloo", device="cpu", args=(...,))

`fn(mesh, *args)` runs in every rank with that rank's `Mesh` active
(parallel.mesh.get_mesh) and returns something picklable; `run` returns
the list of the ranks' results.  The processes are spawned (fresh
interpreters: `fn` must be importable by module and name), meet through
a FileStore in a fresh temporary directory (no TCP port, so concurrent
runs never collide), and use one intra-op thread each.

No hang outlives its deadline: the process group carries `timeout_s`,
and at `timeout_s` after the start the parent kills every child and
raises TimeoutError.  A child's exception is raised in the parent with
the child's traceback, and the other children are ended.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Any, Callable, List, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import make_mesh, set_mesh


def _device_of(device, rank):
    if isinstance(device, (list, tuple)):
        return torch.device(device[rank])
    return torch.device(device)


def _child(rank, fn, nprocs, backend, device, args, tmp, timeout_s):
    torch.set_num_threads(1)
    dev = _device_of(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=nprocs,
                            timeout=timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh(backend=backend, device=dev)
        set_mesh(mesh)
        try:
            out = fn(mesh, *args)
        finally:
            set_mesh(None)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run(fn: Callable, nprocs: int, *, backend: str,
        device: Union[str, torch.device, Sequence], args: tuple = (),
        timeout_s: float = 300.0) -> List[Any]:
    """fn(mesh, *args) on `nprocs` ranks over `backend`; `device` is
    every rank's device, or one per rank.  Returns the ranks' results
    in rank order."""
    from .. import native
    # the native plan builder compiles itself at first use, in place: a
    # child that loaded it half-written would take the Python planner
    native.planner()
    tmp = tempfile.mkdtemp(prefix="hymls_launch_")
    ctx = None
    try:
        ctx = mp.start_processes(
            _child, args=(fn, nprocs, backend, device, args, tmp, timeout_s),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=0.2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{getattr(fn, '__name__', fn)} on "
                                   f"{nprocs} ranks did not end within "
                                   f"{timeout_s:g} s; children killed")
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
