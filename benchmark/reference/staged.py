"""MinkLoc3Dv2's training step, plain PyTorch: multistaged backpropagation
(jac99/MinkLoc3Dv2 `training/trainer.py::multistaged_training_step`)
around the Truncated Smooth AP loss (`reference/smoothap.py`), with the
augmentation of its Oxford submaps (aug_mode 1, set_aug_mode 1) and Adam
with coupled L2 weight decay (`reference/train.py::Adam`).

1. every chunk of `split` clouds, in order, through the model in train mode
   with gradients off;
2. the loss over the whole batch, backpropagated to the (B, D) embeddings;
3. every chunk through the model again with gradients on, and its slice of
   the embedding gradient backpropagated; one Adam step.

Departures from the published code: the augmentation's random numbers are
drawn from a `torch.Generator` in the program's order; each stage builds
its chunks' voxel maps itself (the published step rebuilds its sparse
tensors from the collated coordinates in stage 3 as well); no
`torch.cuda.empty_cache()` between the stages; matmuls in full f32 (TF32
off, as below, unless a caller turns it on).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import sparse
from benchmark.reference.models import record_work
from benchmark.reference.smoothap import truncated_smooth_ap
from benchmark.reference.train import Adam, forward

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# TrainTransform's amplitudes on submaps normalized to [-1, 1] (Oxford's)
JITTER_SIGMA, JITTER_CLIP, TRANSLATION = 0.001, 0.002, 0.01


def draw_augmentation(gen: torch.Generator, b: int, n: int) -> Dict[str, torch.Tensor]:
    """aug_mode 1's and set_aug_mode 1's random numbers, in the program's
    order."""
    dev = gen.device

    def uni(shape, lo=0.0, hi=1.0):
        return torch.empty(shape, device=dev).uniform_(lo, hi, generator=gen)

    d = {"noise": torch.empty((b, n, 3), device=dev).normal_(generator=gen),
         "remove_r": uni((b,), 0.0, 0.1), "remove_u": uni((b, n)),
         "translation": torch.empty((b, 1, 3), device=dev).normal_(generator=gen),
         "block_area": uni((b,), 0.02, 0.33), "block_aspect": uni((b,), 0.3, 3.3),
         "block_ux": uni((b,)), "block_uy": uni((b,)), "block_apply": uni((b,))}
    d["flip_u"] = uni(())
    d["set_rotation_u"] = uni(())
    return d


def _rotz(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([c, -s, zero, s, c, zero, zero, zero, one], -1).reshape(-1, 3, 3)


def augment(pc: torch.Tensor, mask: torch.Tensor, d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """TrainTransform (jitter, random removal, translation, a random block)
    per cloud, then the batch's TrainSetTransform (a z-rotation of at most
    5 deg, then a flip of x or y); a rotation is pc @ R."""
    pc = pc + torch.clamp(JITTER_SIGMA * d["noise"], -JITTER_CLIP, JITTER_CLIP)
    pc = torch.where((d["remove_u"] < d["remove_r"][:, None])[..., None], 0.0, pc)
    pc = pc + TRANSLATION * d["translation"]
    big = 1e9
    lo = torch.where(mask[..., None], pc, big).amin(1)
    hi = torch.where(mask[..., None], pc, -big).amax(1)
    span = hi - lo
    area = d["block_area"] * (span[:, 0] * span[:, 1])
    h = torch.sqrt(area * d["block_aspect"])
    w = torch.sqrt(area / d["block_aspect"])
    x = (lo[:, 0] + d["block_ux"] * (span[:, 0] - w))[:, None]
    y = (lo[:, 1] + d["block_uy"] * (span[:, 1] - h))[:, None]
    inside = ((x < pc[..., 0]) & (pc[..., 0] < x + w[:, None])
              & (y < pc[..., 1]) & (pc[..., 1] < y + h[:, None]))
    pc = torch.where((inside & (d["block_apply"] < 0.4)[:, None])[..., None], 0.0, pc)
    theta = math.radians(5.0) * 2.0 * (d["set_rotation_u"].reshape(1) - 0.5)
    pc = pc @ _rotz(theta)
    r = d["flip_u"]
    sign = torch.stack([torch.where(r <= 0.25, -1.0, 1.0),
                        torch.where((r > 0.25) & (r <= 0.5), -1.0, 1.0),
                        torch.where((r > 0.5) & (r <= 0.5), -1.0, 1.0)])
    return pc * sign


def _embed(model, quantizer, spec, clouds, mask, split: int) -> torch.Tensor:
    return torch.cat([forward(model, quantizer, spec, clouds[at:at + split],
                              mask[at:at + split])["global"]
                      for at in range(0, clouds.shape[0], split)])


def staged_step(model, quantizer, spec, opt: Adam, g: dict, gen: torch.Generator,
                train_cfg: dict, work: List[dict]) -> tuple:
    """One step on the global batch g; returns (loss, the gradients as Adam
    took them, stage 1's embeddings, the loss's stats).  The work records of
    both stages go to `work`, each tagged with its stage, stage 1's as the
    training forwards they are (`train` True, no backward)."""
    t = train_cfg
    split = t["batch_split_size"]
    model.train()
    b, n, _ = g["clouds"].shape
    clouds = augment(g["clouds"], g["point_mask"], draw_augmentation(gen, b, n))
    mask = g["point_mask"]

    with torch.no_grad(), record_work([]) as log:
        embeddings = _embed(model, quantizer, spec, clouds, mask, split)
    work.extend(dict(r, train=True, stage=1) for r in log)

    emb = embeddings.clone().requires_grad_(True)
    loss, stats = truncated_smooth_ap(emb, g["positives_mask"], g["negatives_mask"],
                                      t["tau1"], t["positives_per_query"], t["similarity"])
    loss.backward()
    grad = emb.grad

    for p in model.parameters():
        p.grad = None
    with record_work([]) as log:
        for at in range(0, b, split):
            y = forward(model, quantizer, spec, clouds[at:at + split], mask[at:at + split])
            y["global"].backward(gradient=grad[at:at + split])
    work.extend(dict(r, stage=3) for r in log)
    return loss.detach(), opt.step(), embeddings, stats


def reference_spec(capacities, conv0_kernel_size: int) -> sparse.PyramidSpec:
    return sparse.PyramidSpec(tuple(capacities), conv0_kernel_size=conv0_kernel_size)
