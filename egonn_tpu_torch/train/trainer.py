"""The EgoNN training step (port of `egonn_tpu/train/trainer.py:62-187`).

One step processes one global batch (batch-hard triplet loss on the global
descriptors) and one local batch of cloud pairs (keypoint + correspondence
losses) and makes one optimizer update for the summed loss, as the
reference does (training/trainer.py:160-193).  Three train-mode forwards run
in order, global (augmented), anchor, positive, so the BatchNorm running
statistics advance through all three as the JAX step threads them.  The
validation form runs the same forwards in eval mode under no_grad, without
augmentation, and changes nothing.

The epoch loop (`do_train`: datasets, samplers, checkpoint cadence,
in-training evaluation) is not ported yet; a caller drives the step.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from egonn_tpu_torch.data.pipeline import device_preprocess_global
from egonn_tpu_torch.losses.keypoint import make_losses
from egonn_tpu_torch.models.factory import BuiltModel
from egonn_tpu_torch.train.state import TrainState, make_optimizer, set_lr


def expansion_buckets(batch_size: int, limit: int, rate: Optional[float],
                      multiple_of: int = 1) -> List[int]:
    """The batch sizes dynamic batch expansion can produce (reference
    datasets/samplers.py:79-90), each rounded up to `multiple_of`."""
    sizes = [batch_size]
    if rate:
        b = batch_size
        while b < limit:
            b = min(int(b * rate), limit)
            sizes.append(b)
    if multiple_of > 1:
        sizes = sorted({-(-b // multiple_of) * multiple_of for b in sizes})
    return sizes


class TrainStep:
    """`step(g, l, gen, lr, train)` -> stats.

    g: {"clouds" (B, N, 3), "point_mask" (B, N), "positives_mask" (B, B),
    "negatives_mask" (B, B)}; l: {"anc_clouds", "anc_mask", "pos_clouds",
    "pos_mask" (as g's clouds), "t_gt" (B_l, 4, 4)}; all on the model's
    device.  gen: the `torch.Generator` the global batch's augmentation draws
    from (train only; None skips augmentation).  lr: this epoch's learning
    rate.  Returns the JAX step's stats as detached 0-d tensors: the global
    and local losses' stats, `global_loss`, `local_loss` and `loss` (their
    sum, what the update steps on).  `state` holds the model, the optimizer
    and the epoch (for checkpoints)."""

    def __init__(self, built: BuiltModel, params):
        self.built = built
        self.aug_mode = params.aug_mode
        self.gl_loss_fn, self.loc_loss_fn = make_losses(params)
        self.state = TrainState(built.model, make_optimizer(built.model.parameters(), params))

    def _forward(self, clouds, mask, gen, train: bool):
        b = self.built
        for name, t in (("clouds", clouds), ("mask", mask)):
            if t.device != b.device:
                raise ValueError(f"{name} on {t.device}, the model on {b.device}")
        pyr = device_preprocess_global(clouds, mask, b.quantizer, b.pyramid_spec, gen=gen,
                                       aug_mode=self.aug_mode, with_kmap_down=train)
        return b.model(pyr, b.quantizer)

    def _losses(self, g: Dict, l: Dict, gen, train: bool):
        yg = self._forward(g["clouds"], g["point_mask"], gen, train)
        gl_loss, gl_stats = self.gl_loss_fn(yg["global"], g["positives_mask"],
                                            g["negatives_mask"])
        y1 = self._forward(l["anc_clouds"], l["anc_mask"], None, train)
        y2 = self._forward(l["pos_clouds"], l["pos_mask"], None, train)
        loc_loss, loc_stats = self.loc_loss_fn(
            l["anc_clouds"], l["anc_mask"],
            y1["keypoints"], y1["sigma"], y1["descriptors"], y1["kp_mask"],
            l["pos_clouds"], l["pos_mask"],
            y2["keypoints"], y2["sigma"], y2["descriptors"], y2["kp_mask"],
            l["t_gt"])
        total = gl_loss + loc_loss
        stats = {k: v for k, v in gl_stats.items() if k != "loss"}
        stats.update({k: v for k, v in loc_stats.items() if k != "loss"})
        stats.update(global_loss=gl_loss.detach(), local_loss=loc_loss.detach(),
                     loss=total.detach())
        return total, stats

    def __call__(self, g: Dict, l: Dict, gen: Optional[torch.Generator], lr: float,
                 train: bool) -> Dict[str, torch.Tensor]:
        model, optimizer = self.state.model, self.state.optimizer
        was_training = model.training
        try:
            if train:
                model.train()
                set_lr(optimizer, lr)
                optimizer.zero_grad(set_to_none=True)
                total, stats = self._losses(g, l, gen, train=True)
                total.backward()
                optimizer.step()
            else:
                # the reference's validation sets have no transform
                model.eval()
                with torch.no_grad():
                    _, stats = self._losses(g, l, None, train=False)
        finally:
            model.train(was_training)
        return stats


def make_train_step(built: BuiltModel, params) -> TrainStep:
    """The combined (global + local) train / validation step."""
    return TrainStep(built, params)


def print_stats(stats: Dict[str, float], phase: str) -> None:
    """Reference training/trainer.py:18-43."""
    if "num_triplets" in stats:
        print(f"{phase} - Global loss: {stats['global_loss']:.6f}    "
              f"Embedding norm: {stats['avg_embedding_norm']:.4f}   "
              f"Triplets (all/active): {stats['num_triplets']:.1f}/"
              f"{stats['num_non_zero_triplets']:.1f}")
    if "mean_pos_pair_dist" in stats:
        print("Pos dist (min/mean/max): {:.4f}/{:.4f}/{:.4f}   "
              "Neg dist (min/mean/max): {:.4f}/{:.4f}/{:.4f}".format(
                  stats["min_pos_pair_dist"], stats["mean_pos_pair_dist"],
                  stats["max_pos_pair_dist"], stats["min_neg_pair_dist"],
                  stats["mean_neg_pair_dist"], stats["max_neg_pair_dist"]))
    if "local_loss" in stats:
        print(f"Local loss: {stats['local_loss']:.4f}   "
              f"loss chamfer: {stats['loss_chamfer']:.4f}   "
              f"loss p2p: {stats['loss_p2p']:.4f}  "
              f"desc. loss: {stats['correspondence_loss']:.4f}")
        print(f"repeat.: {stats['repeatability']:0.3f}   "
              f"match. descriptors: {stats['matching_descriptors']:0.3f}")
