"""Data parallelism: one process per card, each global batch split over them.

Port of ``hocon/train/sharding.py``. ``hocon`` runs its step under a 1-D
``data`` mesh: the batch is sharded over the devices, the parameters are
replicated, and under ``jax.jit`` every loss is a mean over the GLOBAL
batch. The port runs one process per card, launched with
``torchrun --nproc_per_node N -m hocon_torch.cli.<cli>``; a ``Mesh`` names
this process's rank, the world size, its device and the process group.

A rank's step equals one process's step on the global batch because:

- the loaders yield this rank's shard of every global batch
  (``BatchLoader(shard_index=rank, shard_count=world)``; ``shard_batch``
  puts it on the rank's device);
- each loss term a rank computes is its share of the global term, and the
  shares sum to it: a masked mean divides the rank's masked sum by the
  global mask sum (``global_sum``), a batch mean over equal shards divides
  by the world size (``batch_mean``). Per-rank means would be wrong: under
  sparse supervision a rank often holds no annotated frame;
- the rank gradients are summed (``reduce_gradients``) before the global
  norm and the clip, and every rank applies the same update, so the
  parameters stay equal bit for bit;
- trainable batch norm averages its statistics over the global batch
  (``global_mean``, differentiable), and updates its running statistics
  from them;
- the logged terms are the sums of the shares (``reduce_terms``), eval
  predictions are gathered in shard order (``gather_rows``).

With one process (no ``RANK`` / ``WORLD_SIZE`` in the environment and none
given) ``make_mesh`` starts no group and every helper returns its input:
the step is the single-process one, bit for bit. Under ``torchrun`` with
one process the collectives run over a single rank and give the same bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from hocon_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel run. ``group`` is None
    when there is one process and no process group."""

    rank: int
    world: int
    device: torch.device
    group: Any = None

    @property
    def is_main(self) -> bool:
        """Rank 0 writes checkpoints, metrics, images, outputs and logs."""
        return self.rank == 0


def _collective(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.group is not None


def make_mesh(
    device: str | torch.device | None = None,
    backend: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    local_rank: int | None = None,
    init_method: str | None = None,
    timeout_s: float = 600.0,
) -> Mesh:
    """This process's mesh, its process group started.

    ``rank`` / ``world_size`` / ``local_rank`` default to ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK`` (what ``torchrun`` sets); without them
    the run is one process: world 1, no group. The device is
    ``cuda:LOCAL_RANK`` unless ``device`` names another (``"cpu"`` in the
    tests; ``hocon_torch.device`` rules, no fallback). ``backend`` defaults
    by the device: ``nccl`` on CUDA, ``gloo`` on the CPU. ``init_method``
    defaults to ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``). A rank that
    waits longer than ``timeout_s`` in a collective raises.
    """
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and world_size is None:
        return Mesh(0, 1, resolve_device(device))
    if rank is None or world_size is None or not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} of world size {world_size}")
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return Mesh(rank, world_size, dev, dist.group.WORLD)


def teardown(mesh: Mesh | None) -> None:
    """Destroy the mesh's process group (run it in a ``finally``)."""
    if _collective(mesh) and dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's local batch (its loader's shard) on its device."""
    from hocon_torch.train.steps import batch_to_device

    return batch_to_device(batch, mesh.device)


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: Mesh | None) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers, and run the model's batch
    norms over the mesh's global batch. Returns ``model``."""
    from hocon_torch.models.backbone import BatchNorm2d

    if not _collective(mesh):
        return model
    for t in (*model.parameters(), *model.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.group)
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.mesh = mesh
    return model


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward sums the ranks' cotangents,
    so the ranks' gradients add up to the gradient of the global sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable."""
    if not _collective(mesh):
        return x
    return _AllReduceSum.apply(x, mesh.group)


def global_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean over the ranks of a per-rank mean over equal shards: the
    global batch's mean, differentiable."""
    if not _collective(mesh):
        return x
    return global_sum(x, mesh) / mesh.world


def batch_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch, the
    shards being equal: ``mean(x) / world``."""
    if not _collective(mesh):
        return torch.mean(x)
    return torch.mean(x) / mesh.world


@torch.no_grad()
def reduce_gradients(grads: list[torch.Tensor], mesh: Mesh | None) -> None:
    """Sum the ranks' gradients in place, in one collective."""
    if not _collective(mesh) or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def reduce_terms(terms: dict, mesh: Mesh | None) -> dict:
    """Scalar term shares summed over the ranks: the global terms."""
    if not _collective(mesh) or not terms:
        return terms
    keys = list(terms)
    flat = torch.stack([terms[k].reshape(()).float() for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    return dict(zip(keys, flat.unbind()))


def gather_rows(tree: dict, mesh: Mesh | None) -> dict:
    """A dict of host arrays with this rank's rows, concatenated in rank
    order over the mesh: the global batch's rows, on every rank."""
    if not _collective(mesh):
        return tree
    parts = [None] * mesh.world
    dist.all_gather_object(parts, tree, group=mesh.group)
    return {k: np.concatenate([p[k] for p in parts]) for k in tree}


@contextlib.contextmanager
def process_mesh(device: str | torch.device | None = None, mesh: Mesh | None = None):
    """A CLI run's mesh: ``mesh`` when the caller gives one (and tears it
    down), else ``make_mesh(device)``, torn down when the block ends or
    raises. Only rank 0 prints inside the block."""
    owned = mesh is None
    if owned:
        mesh = make_mesh(device)
    try:
        with contextlib.ExitStack() as stack:
            if not mesh.is_main:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            if _collective(mesh):
                print(f"[hocon] data parallel over {dist.get_backend(mesh.group)}: world size "
                      f"{mesh.world}, rank 0 on {mesh.device}")
            yield mesh
    finally:
        if owned:
            teardown(mesh)
