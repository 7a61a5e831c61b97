"""Optimizer, learning-rate schedule and checkpoints of training (port of
`egonn_tpu/train/state.py`).

The optimizer is Adam with the reference's coupled L2 weight decay: the
decay is added to the gradient ahead of the moments, which is
`torch.optim.Adam(weight_decay=...)` and not AdamW (the JAX package's
`add_decayed_weights` + `scale_by_adam`, then `p -= lr * u`).  The LR comes
from an epoch-indexed schedule (None, MultiStepLR with gamma 0.1, or
CosineAnnealingLR with T_max = epochs + 1) and is set into the param groups
once per epoch.

A checkpoint holds the whole training state: the model's parameters and
BatchNorm statistics, the optimizer's state and the epoch, in
`step_N.pt` (`torch.save`), plus an optional `step_N.meta.json` sidecar for
host-side state such as the sampler's batch size.
"""
from __future__ import annotations

import json
import math
import os
import re
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    epoch: int = 0


def make_lr_schedule(params) -> Callable[[int], float]:
    """epoch (0-based) -> learning rate, from TrainingParams.  Computed in
    float32 as the JAX schedule is."""
    lr = np.float32(params.lr)
    if params.scheduler is None:
        return lambda epoch: float(lr)
    if params.scheduler == "MultiStepLR":
        milestones = sorted(params.scheduler_milestones)

        def sched(epoch: int) -> float:
            factor = np.float32(1.0)
            for m in milestones:
                factor = factor * np.float32(0.1 if epoch >= m else 1.0)
            return float(lr * factor)

        return sched
    if params.scheduler == "CosineAnnealingLR":
        t_max = params.epochs + 1
        min_lr = np.float32(params.min_lr)

        def sched(epoch: int) -> float:
            cos = np.cos(np.float32(math.pi) * np.float32(min(epoch, t_max)) / np.float32(t_max))
            return float(min_lr + np.float32(0.5) * (lr - min_lr) * (np.float32(1.0) + cos))

        return sched
    raise NotImplementedError(params.scheduler)


def make_optimizer(parameters: Iterable[torch.Tensor], params) -> torch.optim.Adam:
    """Adam(betas 0.9, 0.999, eps 1e-8) with coupled L2 weight decay."""
    return torch.optim.Adam(parameters, lr=params.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=params.weight_decay or 0.0)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.pt")


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    extra_meta: Optional[dict] = None) -> None:
    """Save the whole training state as step_{step}.pt; `extra_meta` (JSON)
    goes to the step_{step}.meta.json sidecar."""
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "epoch": int(state.epoch)}, _step_path(ckpt_dir, step))
    if extra_meta is not None:
        with open(os.path.join(ckpt_dir, f"step_{step}.meta.json"), "w") as f:
            json.dump(extra_meta, f)


def load_checkpoint_meta(ckpt_dir: str, step: int) -> dict:
    """The sidecar saved with `save_checkpoint(..., extra_meta=...)`; {} when
    there is none."""
    path = os.path.join(ckpt_dir, f"step_{step}.meta.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_checkpoint(ckpt_dir: str, state: TrainState, step: Optional[int] = None) -> int:
    """Restore `state` (model, optimizer, epoch) in place from step `step`
    (default: the latest) and return the step.  Tensors land on the model's
    device."""
    steps = sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                   if (m := re.fullmatch(r"step_(\d+)\.pt", name)))
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    device = next(state.model.parameters()).device
    saved = torch.load(_step_path(ckpt_dir, step), map_location=device, weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.epoch = int(saved["epoch"])
    return step
