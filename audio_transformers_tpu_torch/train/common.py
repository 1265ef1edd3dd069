"""What both trainers share: the compute dtypes, the move of a host batch
to the device, the per-epoch random stream, host snapshots, the
in-place restore of a resume checkpoint, and what data parallelism asks
of a trainer (`parallel/mesh.py`):
random draws made for the global batch and sliced to this rank's rows,
metrics averaged over the ranks, and writes (metrics.jsonl,
checkpoints, exports, the label map) left to rank 0. Every rank resumes
from the same bundle (`restore_into`)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core.checkpoint import (Checkpointer,
                                                          check_structure)
from audio_transformers_tpu_torch.core.metrics import MetricLogger
from audio_transformers_tpu_torch.ops.nn import RowShard
from audio_transformers_tpu_torch.parallel.mesh import Mesh, all_reduce_sum

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The random stream of one epoch on `device`, a function of (seed,
    epoch) alone, so that a resumed run replays an uninterrupted one's."""
    state = np.random.SeedSequence([seed, epoch + 1]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> dict:
    """A host batch (numpy) -> tensors on `device`; ids become int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[k] = t.to(device)
    return out


def rank_generator(generator: torch.Generator, mesh: Mesh):
    """The random stream of this rank: `generator` itself on one process,
    else its draws for the global batch sliced to this rank's rows
    (`ops.nn.RowShard`), so that dropout and SpecAugment give each row
    the values one process would, whatever the number of ranks."""
    if mesh.size == 1:
        return generator
    return RowShard(generator, mesh.rank, mesh.size)


def mean_over_ranks(metrics: Dict[str, torch.Tensor], mesh: Mesh
                    ) -> Dict[str, float]:
    """Device scalars averaged over the ranks (each rank's means are over
    equal shares of the global batch), as host floats."""
    keys = list(metrics)
    vec = all_reduce_sum(torch.stack([metrics[k] for k in keys]), mesh)
    return dict(zip(keys, (vec / mesh.size).tolist()))


def metric_logger(mesh: Mesh, **kwargs) -> MetricLogger:
    """A MetricLogger on global rank 0; elsewhere one that writes
    nothing."""
    if mesh.writer:
        return MetricLogger(**kwargs)
    return MetricLogger(console=False)


def host_copy(tree):
    """A detached copy of a tree's tensors on the host."""
    return cp.map_tensors(tree, lambda t: t.detach().cpu().clone())


def restore_into(params, opt, resume_ckpt: Checkpointer, *,
                 shard=None) -> tuple:
    """Loads the resume checkpointer's latest step into the live `params`
    (copied in place: `opt` holds references to these leaves) and `opt`;
    returns (tree, metadata, step). Under tensor parallelism `shard` cuts
    the checkpoint's whole tree to this rank's shards (and `opt` cuts its
    moments: `Optimizer.load_full_state_dict`)."""
    tree, meta, step = resume_ckpt.restore()
    src_tree = tree["params"] if shard is None else shard(tree["params"])
    check_structure(src_tree, params, f"{resume_ckpt.directory} step {step}")
    with torch.no_grad():
        for (_, t), (_, src) in zip(cp.leaves_with_path(params),
                                    cp.leaves_with_path(src_tree)):
            t.copy_(src)
    opt.load_full_state_dict(tree["opt_state"])
    return tree, meta or {}, step
