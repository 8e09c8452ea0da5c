"""Device meshes on ``torch.distributed`` (port of
gnn_motion_planning_tpu/parallel/mesh.py).

One data-parallel axis ``dp``: evaluation shards the lanes of a problem group
(``api/batched.py::explore_batch(mesh=)``) and training shards the problem
batch (``training/explorer.py::make_train_step``), with parameters replicated
and gradients averaged. A mesh is the cards of this process (one process per
card is torch's rule, so usually one) times the processes of the
``torch.distributed`` group; collectives are NCCL's on cards and gloo's on
the CPU. A CPU mesh of several entries (one process, the same CPU each
time) exists only so that the tests can shard without cards, and is asked
for explicitly.
"""

from __future__ import annotations

import copy
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """A 1-axis mesh: ``devices`` are this process's shards, in order; the
    process's shards are ``process_index * len(devices)`` on."""

    devices: tuple
    process_count: int = 1
    process_index: int = 0
    axis: str = "dp"

    @property
    def size(self) -> int:
        """Shards over every process."""

        return len(self.devices) * self.process_count

    @property
    def first_shard(self) -> int:
        return self.process_index * len(self.devices)


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, local_device_ids=None):
    """Join the process group of a multi-process run: ``coordinator_address``
    ("host:port"), ``num_processes`` and ``process_id``, each defaulting to
    torchrun's ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
    NCCL when this host has cards (the process takes card
    ``local_device_ids`` or its rank modulo the card count), gloo otherwise.
    A no-op when neither the arguments nor the environment ask for more than
    one process. Returns (process_index, process_count)."""

    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if not coordinator_address or not num_processes or num_processes <= 1:
        return 0, 1
    cuda = torch.cuda.is_available()
    if cuda:
        card = process_id % torch.cuda.device_count() if local_device_ids is None \
            else int(np.ravel([local_device_ids])[0])
        torch.cuda.set_device(card)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def _group() -> tuple:
    """(index, count) of this process in the process group, (0, 1) without one."""

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(axis: str = "dp") -> Mesh:
    """The mesh of every process's cards: this process's card (every card
    of the host when it runs alone), or the CPU on a host without cards."""

    index, count = _group()
    if not torch.cuda.is_available():
        devices = (torch.device("cpu"),)
    elif count > 1:
        devices = (torch.device("cuda", torch.cuda.current_device()),)
    else:
        devices = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return Mesh(devices, count, index, axis)


def make_mesh(n_devices: int | None = None, axis: str = "dp", device=None) -> Mesh:
    """A 1-axis mesh over exactly ``n_devices`` cards of this process (all
    of them when None). Raises when fewer exist: a mesh cut short would let
    a sharding test pass on one card, proving nothing. ``device="cpu"``
    builds a mesh of ``n_devices`` CPU entries, for the tests."""

    if device is not None and torch.device(device).type == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1), axis=axis)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else n_devices
    if n < 1 or count < n:
        raise ValueError(
            f"make_mesh({n_devices}) but only {count} CUDA devices exist; a CPU mesh for "
            "the tests is make_mesh(n, device='cpu')")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis=axis)


def same_device(a, b) -> bool:
    """Whether two device names mean one device ("cuda" is the current card)."""

    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index or None in (a.index, b.index)
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == (
        b.index if b.index is not None else current)


def _map(fn, x):
    """``fn`` over the tensors and arrays of ``x`` (a NamedTuple of them)."""

    if hasattr(x, "_fields"):
        return type(x)(*(_map(fn, v) for v in x))
    return fn(x)


def data_sharding(mesh: Mesh, axis: str = "dp"):
    """Shard the leading (problem-batch or lane) axis: returns ``shard(x)``
    -> [(device, rows of x on it)] for this process's shards, the axis cut
    into ``mesh.size`` equal contiguous parts (it must divide)."""

    def shard(x):
        first = x[0] if hasattr(x, "_fields") else x
        n = len(first)
        if n % mesh.size:
            raise ValueError(f"a leading axis of {n} does not split over {mesh.size} shards")
        per = n // mesh.size
        out = []
        for i, dev in enumerate(mesh.devices):
            lo = (mesh.first_shard + i) * per
            out.append((dev, _map(lambda a: torch.as_tensor(a[lo : lo + per], device=dev), x)))
        return out

    return shard


def replicated(mesh: Mesh):
    """Replicate a module on every card of this process: returns
    ``rep(module)`` -> [the module on each device: itself where it already
    lies there, else a copy]."""

    def rep(module: torch.nn.Module):
        home = next(iter(module.state_dict().values())).device
        return [module if same_device(dev, home) else copy.deepcopy(module).to(dev)
                for dev in mesh.devices]

    return rep


def all_reduce_sum(tensors, mesh: Mesh) -> None:
    """Sum each tensor in place over the mesh's processes (one collective)."""

    if mesh.process_count == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off : off + t.numel()].reshape(t.shape))
        off += t.numel()
