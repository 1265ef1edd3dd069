"""Optimizer and learning-rate schedules from OptimizerConfig.

The reference's `audio_transformers_tpu/train/optim.py` builds an optax
chain; this builds the same update from `torch.optim`:

  - "adamw": AdamW with decoupled weight decay, limited to the leaves a
    decay mask marks (`frozen_leaf_decay_mask`);
  - "adam": Adam;
  - schedules "constant", "linear_warmup_decay" (optax counts updates from
    0, so the very first update has learning rate 0; warmup =
    max(1, int(warmup_fraction * total_steps)) steps up, then linear decay
    to 0) and "reduce_on_plateau" (a host-set learning rate:
    `set_learning_rate` between epochs, fed by `PlateauScheduler`);
  - optional clipping by global gradient norm before the update, with
    optax's rule: gradients are scaled by max_norm / norm only when
    norm >= max_norm.

Only trainable leaves are optimized: the frozen encoder positional table
(`core.params.FROZEN`) takes neither an update nor weight decay, as in the
reference, where its gradient is stopped and the decay mask spares it.

Under tensor parallelism (`model_group`, with `axes` the tree of
`parallel.tensor.Split`s the parameters were cut by) the clip's global
norm is the whole tree's: the squares of the cut leaves are summed over
the model group and every whole (replicated) leaf counts once.
`full_state_dict` and `load_full_state_dict` move the moments as the
whole tree's, so a checkpoint does not depend on the mesh.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from audio_transformers_tpu_torch.core.config import OptimizerConfig
from audio_transformers_tpu_torch.core.params import (FROZEN,
                                                      leaves_with_path)
from audio_transformers_tpu_torch.parallel import tensor as tp


def frozen_leaf_decay_mask(params, *, frozen=FROZEN) -> dict:
    """A tree of bools shaped like `params`: True where adamw may decay
    the leaf, False for the frozen leaves."""
    frozen = {tuple(f) for f in frozen}

    def mark(tree, path):
        if isinstance(tree, dict):
            return {k: mark(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [mark(v, path + (i,)) for i, v in enumerate(tree)]
        return path not in frozen

    return mark(params, ())


def learning_rate_schedule(cfg: OptimizerConfig,
                           total_steps: Optional[int] = None
                           ) -> Callable[[int], float]:
    """count (updates done so far) -> learning rate."""
    lr = cfg.learning_rate
    if cfg.schedule != "linear_warmup_decay":
        return lambda count: lr
    if not total_steps:
        raise ValueError("linear_warmup_decay needs total_steps")
    warmup = max(1, int(cfg.warmup_fraction * total_steps))
    decay = max(1, total_steps - warmup)

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        return lr * (1.0 - min(count - warmup, decay) / decay)

    return schedule


class Optimizer:
    """A `torch.optim` Adam or AdamW over the trainable leaves of a
    parameter tree, with the configured schedule and clipping.

    `step()` clips the gradients (when configured), sets the learning rate
    of this update and applies it; `zero_grad()` clears the gradients."""

    def __init__(self, cfg: OptimizerConfig, params,
                 total_steps: Optional[int] = None, decay_mask=None, *,
                 model_group=None, axes=None):
        if cfg.name not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        self.cfg = cfg
        self.schedule = learning_rate_schedule(cfg, total_steps)
        self.count = 0
        self.model_group = model_group
        splits = (tp.split_leaves(axes) if axes is not None
                  else [None] * len(leaves_with_path(params)))
        trainable = [(t, s) for (_, t), s in zip(leaves_with_path(params),
                                                 splits) if t.requires_grad]
        self.params = [t for t, _ in trainable]
        # id(param) -> its Split, for the leaves the model axis cuts
        self.splits = {id(t): s for t, s in trainable if s is not None}
        if not self.params:
            raise ValueError("no trainable leaves (see core.params."
                             "set_trainable)")
        lr = self.schedule(0)
        kw = {"betas": (cfg.b1, cfg.b2), "eps": cfg.eps}
        if cfg.name == "adam":
            self.opt = torch.optim.Adam(self.params, lr=lr, **kw)
            return
        if callable(decay_mask):
            decay_mask = decay_mask(params)
        marks = ([m for _, m in leaves_with_path(decay_mask)]
                 if decay_mask is not None
                 else [True] * len(leaves_with_path(params)))
        decayed, kept = [], []
        for (_, t), m in zip(leaves_with_path(params), marks):
            if t.requires_grad:
                (decayed if m else kept).append(t)
        groups = [{"params": decayed, "weight_decay": cfg.weight_decay},
                  {"params": kept, "weight_decay": 0.0}]
        self.opt = torch.optim.AdamW([g for g in groups if g["params"]],
                                     lr=lr, **kw)

    @property
    def learning_rate(self) -> float:
        return self.opt.param_groups[0]["lr"]

    def set_learning_rate(self, lr: float) -> None:
        for g in self.opt.param_groups:
            g["lr"] = lr

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def grad_norm(self) -> torch.Tensor:
        """The global gradient norm of the whole tree (a device scalar)."""
        sq = [[], []]    # whole leaves, cut leaves
        for p in self.params:
            if p.grad is not None:
                sq[id(p) in self.splits].append((p.grad.float() ** 2).sum())
        zero = torch.zeros((), device=self.params[0].device)
        whole, cut = (sum(x) if x else zero for x in sq)
        if self.model_group is not None and sq[1]:
            cut = cut.clone()
            dist.all_reduce(cut, group=self.model_group)
        return torch.sqrt(whole + cut)

    @torch.no_grad()
    def _clip(self, max_norm: float) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = self.grad_norm()
        for g in grads:
            g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))

    def step(self) -> None:
        if self.cfg.grad_clip_norm:
            self._clip(self.cfg.grad_clip_norm)
        if self.cfg.schedule != "reduce_on_plateau":
            self.set_learning_rate(self.schedule(self.count))
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        """{"count": updates so far (the schedule's position), "torch":
        the torch optimizer's state_dict (moments and learning rates)}."""
        return {"count": self.count, "torch": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["torch"])
        self.count = int(state["count"])

    def _order(self) -> list:
        """The parameters in the order of the torch state's indices."""
        return [p for g in self.opt.param_groups for p in g["params"]]

    def full_state_dict(self) -> dict:
        """`state_dict` with the moments of the cut leaves gathered over
        the model group: the state of the whole tree (every rank of the
        group must call it)."""
        state = self.state_dict()
        if self.model_group is None:
            return state
        moments = state["torch"]["state"]
        for i, p in enumerate(self._order()):
            split = self.splits.get(id(p))
            if split is not None and i in moments:
                moments[i] = {k: (tp.gather_params(v, self.model_group, split)
                                  if v.dim() else v)
                              for k, v in moments[i].items()}
        return state

    def load_full_state_dict(self, state: dict) -> None:
        """`load_state_dict` of a whole tree's state (`full_state_dict`),
        each moment of a cut leaf cut to this rank's shard."""
        if self.model_group is not None:
            t = tp.model_size(self.model_group)
            r = tp.model_rank(self.model_group)
            moments = state["torch"]["state"]
            for i, p in enumerate(self._order()):
                split = self.splits.get(id(p))
                if split is not None and i in moments:
                    moments[i] = {k: (tp.shard_params(v, t, r, split)
                                      if v.dim() else v)
                                  for k, v in moments[i].items()}
        self.load_state_dict(state)


def build_optimizer(cfg: OptimizerConfig, params,
                    total_steps: Optional[int] = None,
                    decay_mask=None, *, model_group=None,
                    axes=None) -> Optimizer:
    """The optimizer for the trainable leaves of `params`. For
    "linear_warmup_decay", `total_steps` is required. `decay_mask` (a tree
    of bools, or a params -> tree callable such as
    `frozen_leaf_decay_mask`) limits adamw's weight decay to the marked
    leaves. Under tensor parallelism `params` are this rank's shards,
    `axes` the tree of Splits that cut them and `model_group` the model
    axis's group (the clip's norm and `full_state_dict` need them)."""
    return Optimizer(cfg, params, total_steps, decay_mask,
                     model_group=model_group, axes=axes)


def set_learning_rate(opt: Optimizer, lr: float) -> Optimizer:
    """Sets the learning rate (reduce_on_plateau schedule)."""
    opt.set_learning_rate(lr)
    return opt


def get_learning_rate(opt: Optimizer) -> float:
    return opt.learning_rate


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (min mode), the reference's semantics."""

    def __init__(self, cfg: OptimizerConfig):
        self.patience = cfg.plateau_patience
        self.factor = cfg.plateau_factor
        self.lr = cfg.learning_rate
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        """Feed the epoch's val metric; returns the (possibly reduced) lr."""
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr
