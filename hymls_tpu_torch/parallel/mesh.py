"""The process mesh: one rank per process over a torch.distributed group.

Torch counterpart of hymls_tpu/parallel/mesh.py.  The reference is
single-controller SPMD: a `jax.sharding.Mesh` of devices, shard_map
bodies and GSPMD constraints.  Here every rank is a process of its own
(the reference HYMLS's MPI model, src/HYMLS_BasePartitioner.cpp:361-586):
it holds only its own shard, and every cross-rank transfer is an
explicit call of parallel/collectives.py on the mesh's process group.

A `Mesh` names its group, this process's rank, the group size, the
device its tensors live on and the transport (`backend`): "nccl" sends
device tensors, "gloo" host tensors (a CUDA tensor is staged through
host memory, see collectives.py).  Both are named by the caller, never
picked from what is present.  One H100 takes one NCCL rank, so several
ranks on one card exchange over gloo.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_ACTIVE_MESH: Optional["Mesh"] = None

BACKENDS = ("gloo", "nccl")
PRIMITIVES = ("ppermute", "psum", "all_gather")


class Mesh:
    """One rank's view of a 1-D mesh (axis `axis`, default "sd": the
    subdomain batch axis of the reference).  `counters` holds, per
    primitive, the calls and the bytes this rank sent (parallel/
    collectives.py), and under "ppermute_words" the words sent per tag."""

    def __init__(self, group=None, *, backend: str, device,
                 axis: str = "sd"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        got = dist.get_backend(group)
        if got != backend:
            raise ValueError(f"the process group's backend is {got!r}, "
                             f"the mesh was asked for {backend!r}")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = backend
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an nccl mesh needs a CUDA device, got "
                             f"{self.device}")
        self.axis = axis
        self.reset_counters()

    @property
    def staged(self) -> bool:
        """Whether buffers cross through host memory (gloo on a card)."""
        return self.backend == "gloo" and self.device.type != "cpu"

    def reset_counters(self):
        self.counters = {p: {"calls": 0, "bytes": 0} for p in PRIMITIVES}
        self.counters["ppermute_words"] = {}


def topo_order(devs):
    """Topology-aware device ordering (the reference HyperCube role,
    src/HYMLS_HyperCube.hpp:11-36 node-aware rank renumbering): walk
    the physical ICI torus coordinates boustrophedon (snake) so
    consecutive devices in the 1D 'sd' ring are physical neighbors —
    every ppermute hop of the halo V-cycle then traverses a single ICI
    link instead of a random multi-hop route.  Devices without torus
    coordinates (CPU/virtual) keep their given order."""
    try:
        coords = [tuple(d.coords) for d in devs]
    except AttributeError:
        return list(devs)
    ndim = len(coords[0])
    sizes = [max(c[i] for c in coords) + 1 for i in range(ndim)]

    def snake(d):
        idx = 0
        for i, ci in enumerate(tuple(d.coords)):
            if idx & 1:
                ci = sizes[i] - 1 - ci
            idx = idx * sizes[i] + ci
        return (idx, getattr(d, "core_on_chip", 0))

    return sorted(devs, key=snake)


def make_mesh(n_devices: Optional[int] = None, axis: str = "sd", *,
              backend: str, device) -> Mesh:
    """The mesh over the initialized default process group.  A mesh
    spans the whole group: `n_devices`, where given, must be its
    size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(init_mesh, or parallel.launch.run)")
    if n_devices is not None and n_devices != dist.get_world_size():
        raise ValueError(f"a mesh spans the whole process group: "
                         f"{n_devices} != {dist.get_world_size()}")
    mesh = Mesh(None, backend=backend, device=device, axis=axis)
    if backend == "nccl":
        # NCCL needs every rank in the group's first collective, and a
        # batch of sends and receives may involve only some ranks
        dist.barrier(device_ids=[mesh.device.index])
    return mesh


def init_mesh(*, backend: str, device, axis: str = "sd",
              timeout_s: float = 600.0) -> Mesh:
    """Join the process group that `torchrun` describes (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT in the environment), build the
    mesh over it and make it the active one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)      # NCCL's sends need it
    if not dist.is_initialized():
        from datetime import timedelta
        dist.init_process_group(
            backend, init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=timedelta(seconds=timeout_s))
    mesh = make_mesh(backend=backend, device=device, axis=axis)
    set_mesh(mesh)
    return mesh


def set_mesh(mesh: Optional[Mesh]):
    """Activate (or deactivate with None) the mesh that solvers with
    'Distributed Apply' run over."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def shard_batch(x):
    """The reference constrains a batched array to be sharded over its
    mesh (a GSPMD annotation); a process holds only its own shard here,
    so there is nothing to annotate and `x` comes back unchanged."""
    return x
