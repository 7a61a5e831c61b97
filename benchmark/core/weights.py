"""Seeded model weights, made on the device in one draw.

Every tensor of the reference model's state dict (parameters and BatchNorm
statistics) takes its slice of one uniform draw of a generator on the card,
scaled by its kind: convs and dense layers uniform within
+-sqrt(3 / fan_in), a variance of 1 / fan_in (fan_in of a sparse conv counts
the offsets a LiDAR voxel finds filled, ~8 of 27, so activations keep their
scale through the seven levels), biases within +-1/sqrt(fan_in), BatchNorm scales 0.5-1.5, shifts
and running means within +-0.1, running variances 0.5-1.5 (perturbed
statistics keep the local descriptors apart), ECA within +-1/sqrt(k), GeM's
p 2.5-3.5.  The same dict loads into the program's model and the
reference's.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.core.scans import generator


def _scaled(u: torch.Tensor, kind: str, fan_in: int) -> torch.Tensor:
    if kind in ("conv", "dense"):
        return (2 * u - 1) * math.sqrt(3.0 / fan_in)
    if kind == "bias":
        return (2 * u - 1) / math.sqrt(fan_in)
    if kind in ("bn_scale", "bn_var"):
        return 0.5 + u
    if kind in ("bn_bias", "bn_mean"):
        return (2 * u - 1) * 0.1
    if kind == "eca":
        return (2 * u - 1) / math.sqrt(fan_in)
    if kind == "gem":
        return 2.5 + u
    raise ValueError(kind)


def seeded_state(shapes: Dict[str, torch.Size], kinds: Dict[str, tuple], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} for every entry of `shapes` (a state dict's shapes,
    taken in sorted name order), from one draw seeded by `seed`."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    u = torch.rand(sum(sizes), generator=generator(device, seed, 1), device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        kind, fan_in = kinds[name]
        out[name] = _scaled(u[at:at + size], kind, fan_in).reshape(shapes[name]).contiguous()
        at += size
    return out
