"""The data-parallel layout and its collectives.

The data-parallel half of the reference's
`audio_transformers_tpu/parallel/mesh.py`. JAX lays a mesh over the
devices and lets XLA insert the collectives its shardings need; the port
runs one process per device and calls them itself:

  - `build_mesh`: a ("data", d) x ("model", t) grid of the processes,
    rank = data_index * t + model_index (the model axis minor, as the
    reference's `build_mesh` reshapes its devices). `Mesh.size/rank/group`
    are the data axis (the replicas that split the batch); the model axis
    (`model_size/model_rank/model_group`) is tensor parallelism, whose
    layout and collectives are `parallel/tensor.py`;
  - `replicated`: parameters and state broadcast from the data group's
    first rank, so every replica starts equal;
  - `average_gradients`: one all-reduce of every gradient in a flat
    bucket, divided by the world size, before the optimizer clips and
    steps, so every replica takes the same update;
  - `all_reduce_sum`: the sums of an evaluation or of a step's metrics.

A process that joined no group (`parallel.distributed`) gets a mesh of
one process with no group, and every collective is the identity. A group
of one process runs every collective, which then changes no bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from audio_transformers_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh:
    """`size` processes on the "data" axis, of which this is `rank`;
    `group` is their process group, None where the axis has one process.
    `model_size` processes on the "model" axis share this process's rows
    (its tensor-parallel peers), of which this is `model_rank`;
    `model_group` is theirs, None at model_size 1."""
    size: int
    rank: int
    group: Optional[object] = None
    model_size: int = 1
    model_rank: int = 0
    model_group: Optional[object] = None

    @property
    def writer(self) -> bool:
        """True on global rank 0 alone, the process that writes files."""
        return self.rank == 0 and self.model_rank == 0


def build_mesh(shape: Sequence[Tuple[str, int]] = (("data", -1),)) -> Mesh:
    """The mesh of this process group. One axis size may be -1 (what the
    fixed axes leave of the world size); the axes must cover the world
    exactly, since every process holds a replica."""
    names = [n for n, _ in shape]
    sizes = [s for _, s in shape]
    unknown = sorted(set(names) - {"data", "model"})
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}")
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    world = distributed.process_count()
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes and not world % known:
        sizes[sizes.index(-1)] = world // known
    axes = dict(zip(names, sizes))
    if -1 in sizes:
        raise ValueError(
            f"{world} processes not divisible by fixed axes {known}")
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {axes} needs {math.prod(sizes)} "
                         f"processes, have {world}")
    t = axes.get("model", 1)
    d = world // t
    rank = distributed.process_index()
    if t == 1:
        group = dist.group.WORLD if dist.is_initialized() else None
        distributed.set_data_axis(None)     # every process is a replica
        return Mesh(size=d, rank=rank, group=group)
    # every process creates every group, in the same order
    data_groups = [dist.new_group([di * t + mi for di in range(d)])
                   if d > 1 else None for mi in range(t)]
    model_groups = [dist.new_group([di * t + mi for mi in range(t)])
                    for di in range(d)]
    di, mi = divmod(rank, t)
    distributed.set_data_axis((d, di))
    return Mesh(size=d, rank=di, group=data_groups[mi], model_size=t,
                model_rank=mi, model_group=model_groups[di])


def replicated(tree, mesh: Mesh):
    """Overwrites every tensor of `tree` (nested dicts and lists) in place
    with the data group's first rank's and returns the tree (a model
    rank's shards come from the first replica of the same shard)."""
    if mesh.group is None:
        return tree
    src = mesh.model_rank   # global rank of data index 0, model index r

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            with torch.no_grad():
                dist.broadcast(t, src=src, group=mesh.group)

    walk(tree)
    return tree


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`t` summed over the ranks, in place; returns it."""
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t


def average_gradients(params: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Replaces each parameter's gradient by its mean over the ranks: one
    all-reduce of a flat bucket of every gradient (one dtype)."""
    if mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    with torch.no_grad():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.size
        # one multi-tensor launch, not one copy per leaf (168 for
        # whisper-tiny, which left the card waiting on the host)
        torch._foreach_copy_(grads, [
            part.view_as(g) for part, g in
            zip(flat.split([g.numel() for g in grads]), grads)])
