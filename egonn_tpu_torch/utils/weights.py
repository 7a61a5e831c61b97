"""Moves a flax variable tree (EgoNN, MinkLoc, ResNetBase, or a converted
reference checkpoint) into the port's modules."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, key + "."))
        else:
            out[key] = np.asarray(value)
    return out


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables: Mapping) -> None:
    """Fill `model`'s parameters and BatchNorm buffers from a flax
    `{"params": ..., "batch_stats": ...}` tree of nested dicts of arrays.

    The port's module and tensor names are the flax names, so each leaf's
    dotted path is a `state_dict()` key and the layouts agree.  Raises unless
    every leaf is used and every entry of the state dict is filled, with
    equal shapes."""
    leaves = {}
    for collection in ("params", "batch_stats"):
        leaves.update(_flatten(variables.get(collection, {})))
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected flax collections: {sorted(unknown)}")
    state = model.state_dict()
    unused = sorted(set(leaves) - set(state))
    unset = sorted(set(state) - set(leaves))
    if unused or unset:
        raise ValueError(f"flax leaves without a port tensor: {unused}; "
                         f"port tensors without a flax leaf: {unset}")
    for key, value in leaves.items():
        target = state[key]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{key}: flax shape {value.shape}, port shape "
                             f"{tuple(target.shape)}")
        target.copy_(torch.as_tensor(value, dtype=target.dtype))
