"""Local losses (port of `egonn_tpu/losses/keypoint.py`): the USIP-style
probabilistic chamfer + point-to-point keypoint loss and the descriptor
correspondence loss, over padded (B, K, ...) buffers with masks.

The JAX package writes each loss for one cloud pair and vmaps it; here every
function takes the batch of pairs as a leading dimension and returns one
value per pair.  Means are over the valid entries only.  Metrics are
detached.  Under data parallelism each rank holds its rows of the pairs and
the means over the pairs are global: the sums are summed over the ranks
and divided by the global count (`parallel/mesh.py`).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Dict, Tuple

import torch

from egonn_tpu_torch.losses.triplet import (
    batch_hard_contrastive_loss,
    batch_hard_triplet_loss,
    pairwise_l2,
)
from egonn_tpu_torch.ops.geometry import apply_transform, true_f32
from egonn_tpu_torch.parallel.mesh import all_reduce_sum
from egonn_tpu_torch.utils.tracing import span

BIG = 1e9
_CLOUD_CHUNK = 8192  # points per block of the keypoint-to-cloud distance search


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the last dimension's valid entries (0 where none are)."""
    return torch.where(mask, x, 0.0).sum(-1) / torch.clamp_min(mask.sum(-1), 1)


def _nearest_point_dist(kp: torch.Tensor, pc: torch.Tensor, pc_mask: torch.Tensor
                        ) -> torch.Tensor:
    """min over the valid points j of pairwise_l2(kp, pc)[..., j]: (B, K), BIG
    for a cloud without valid points.

    The JAX package forms the whole (B, K, N) matrix; at full width that is
    8 x 4096 x 65536 floats per temporary.  Here the nearest point is found
    in blocks of points without autograd, and the distance to it is then
    recomputed, with its gradient, by the same formula (the cloud carries no
    gradient, so the min's gradient reaches the nearest point only)."""
    with span("egonn.loss.nearest_point"):
        b, k, _ = kp.shape
        with torch.no_grad():
            best = torch.full((b, k), math.inf, dtype=kp.dtype, device=kp.device)
            best_i = torch.zeros((b, k), dtype=torch.long, device=kp.device)
            for s in range(0, pc.shape[1], _CLOUD_CHUNK):
                d = pairwise_l2(kp, pc[:, s:s + _CLOUD_CHUNK])
                d = torch.where(pc_mask[:, None, s:s + _CLOUD_CHUNK], d, BIG)
                d_min, i_min = d.min(-1)
                better = d_min < best  # strict: the first of equal points wins
                best = torch.where(better, d_min, best)
                best_i = torch.where(better, i_min + s, best_i)
        nearest = torch.gather(pc, 1, best_i[..., None].expand(-1, -1, 3))
        sq = (kp ** 2).sum(-1) + (nearest ** 2).sum(-1) - 2.0 * (kp * nearest).sum(-1)
        sq = torch.clamp_min(sq, 0.0)
        pos = sq > 0.0
        d = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
        return torch.where(pc_mask.any(1)[:, None], d, BIG)


class _GatherRows(torch.autograd.Function):
    """x.gather(1, idx) for x (B, N) and idx (B, K), whose backward adds each
    row's gradients with a matmul by the one-hot of idx, in true f32: the
    card's scatter_add (torch.gather's backward) adds a row's duplicates
    with atomics in any order, so two train steps from one state would
    differ in the last bits.  The (B, K, N) one-hot is the size of the
    loss's distance matrix."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[1]
        return torch.gather(x, 1, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        onehot = (idx[..., None] == torch.arange(ctx.n, device=idx.device)).to(g.dtype)
        with true_f32():
            return torch.bmm(g[:, None, :], onehot)[:, 0], None


def keypoint_loss_single(pc1, pc1_mask, kp1, sigma1, kp1_mask, pc2, pc2_mask, kp2, sigma2,
                         kp2_mask, dist12, gamma_chamfer=1.0, gamma_p2p=1.0,
                         repeatability_dist_th=0.5):
    """Per pair: dist12 (B, K1, K2) between transformed kp1 and kp2, invalid
    entries >= BIG.  Returns (loss (B,), metrics of (B,))."""
    sigma1 = sigma1[..., 0]
    sigma2 = sigma2[..., 0]
    min_dist1 = dist12.amin(-1)
    min_ndx1 = dist12.argmin(-1)
    min_dist2 = dist12.amin(-2)
    min_ndx2 = dist12.argmin(-2)

    # probabilistic chamfer: log(s12) + d / s12, s12 = (sigma1 + sigma2[match]) / 2
    s12 = torch.clamp_min((sigma1 + _GatherRows.apply(sigma2, min_ndx1)) / 2.0, 1e-12)
    loss1 = _masked_mean(torch.log(s12) + torch.clamp_max(min_dist1, BIG) / s12, kp1_mask)
    s21 = torch.clamp_min((sigma2 + _GatherRows.apply(sigma1, min_ndx2)) / 2.0, 1e-12)
    loss2 = _masked_mean(torch.log(s21) + torch.clamp_max(min_dist2, BIG) / s21, kp2_mask)

    metrics: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        metrics["repeatability"] = _masked_mean(
            (min_dist1 <= repeatability_dist_th).to(torch.float32), kp1_mask)
        metrics["chamfer_pure"] = 0.5 * (_masked_mean(min_dist1, kp1_mask)
                                         + _masked_mean(min_dist2, kp2_mask))
        w12 = (1.0 / s12) / torch.clamp_min(_masked_mean(1.0 / s12, kp1_mask), 1e-12)[:, None]
        w21 = (1.0 / s21) / torch.clamp_min(_masked_mean(1.0 / s21, kp2_mask), 1e-12)[:, None]
        metrics["chamfer_weighted"] = (0.5 * _masked_mean(w12 * min_dist1, kp1_mask)
                                       + 0.5 * _masked_mean(w21 * min_dist2, kp2_mask))
        metrics["mean_sigma"] = 0.5 * (_masked_mean(s12, kp1_mask)
                                       + _masked_mean(s21, kp2_mask))

    loss = gamma_chamfer * 0.5 * (loss1 + loss2)
    metrics["loss_chamfer"] = loss.detach()

    # point-to-point: distance of each keypoint to its own cloud
    p2p = 0.5 * (_masked_mean(_nearest_point_dist(kp1, pc1, pc1_mask), kp1_mask)
                 + _masked_mean(_nearest_point_dist(kp2, pc2, pc2_mask), kp2_mask))
    metrics["loss_p2p"] = p2p.detach()
    loss = loss + gamma_p2p * p2p
    metrics["keypoint_loss"] = loss.detach()
    return loss, metrics


def _neg_similarity(logits, sim, target, row_sel, kp2_mask):
    """Zero the columns that are targets of the selected rows, then the mean
    over the selected rows of the max.

    The JAX package marks the columns with one scatter of row_sel at
    where(row_sel, target, 0); where rows collide the last row's value wins
    (its CPU scatter runs in order), so an unselected row after a selected
    row with target 0 clears column 0 again.  Kept as is."""
    b, k1 = target.shape
    idx = torch.where(row_sel, target, 0)
    order = torch.arange(k1, device=target.device).expand(b, k1)
    last = torch.full((b, sim.shape[2]), -1, dtype=torch.long, device=target.device)
    last = last.scatter_reduce(1, idx, order, reduce="amax")
    tgt_cols = (last >= 0) & torch.gather(row_sel, 1, last.clamp_min(0))
    neg = torch.where(tgt_cols[:, None, :], 0.0,
                      torch.where(kp2_mask[:, None, :], sim, -BIG))
    return _masked_mean(neg.amax(-1), row_sel)


def correspondence_loss_single(desc1, kp1_mask, desc2, kp2_mask, dist12, beta=1.0,
                               dist_th=0.5):
    """Per pair: cross-entropy over desc1 @ desc2^T * exp(beta), rows
    restricted to keypoints whose transformed position has a match within
    dist_th.  Returns (loss (B,), metrics of (B,))."""
    min_dist1 = dist12.amin(-1)
    target = dist12.argmin(-1)
    row_sel = kp1_mask & (min_dist1 <= dist_th)

    sim = (desc1 @ desc2.transpose(-1, -2)) * math.exp(beta)
    logits = torch.where(kp2_mask[:, None, :], sim, -BIG)
    logz = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, 2, target[..., None])[..., 0]
    ce = logz - tgt_logit
    n_sel = row_sel.sum(-1)
    loss = torch.where(row_sel, ce, 0.0).sum(-1) / torch.clamp_min(n_sel, 1)

    with torch.no_grad():
        pred = logits.argmax(-1)
        metrics = {
            "correspondence_loss": loss.detach(),
            "matching_keypoints": n_sel.to(torch.float32),
            "matching_descriptors": torch.where(
                row_sel, (pred == target).to(torch.float32), 0.0).sum(-1),
            # reference quirk, kept: the mean of the ARGMAX INDICES, not values
            "pos_similarity": torch.where(row_sel, pred.to(torch.float32), 0.0).sum(-1)
            / torch.clamp_min(n_sel, 1),
            "neg_similarity": _neg_similarity(logits, sim, target, row_sel, kp2_mask),
        }
    return loss, metrics


def keypoint_corr_loss(clouds1, clouds1_mask, kp1, sigma1, desc1, kp1_mask,
                       clouds2, clouds2_mask, kp2, sigma2, desc2, kp2_mask,
                       t_gt, gamma_c=1.0, gamma_k=1.0, gamma_chamfer=1.0,
                       gamma_p2p=1.0, beta=1.0, dist_th=0.5, group=None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Keypoint + correspondence loss over a batch of pairs.

    clouds* (B, N, 3) + (B, N) masks; kp*/sigma*/desc* (B, K, ...) + (B, K)
    masks; t_gt (B, 4, 4) maps cloud 1's frame into cloud 2's.  Returns the
    loss to step on and the mean of each metric over the pairs: the sum
    over these pairs / the count of every rank's pairs (with `group` this
    rank's share of the global mean, whose sum over the ranks is the mean;
    the metrics and `loss` are the global means)."""
    kp1_trans = apply_transform(kp1, t_gt)
    dist12 = pairwise_l2(kp1_trans, kp2)
    dist12 = torch.where(kp1_mask[:, :, None] & kp2_mask[:, None, :], dist12, BIG)

    kp_loss, km = keypoint_loss_single(
        clouds1, clouds1_mask, kp1, sigma1, kp1_mask, clouds2, clouds2_mask, kp2, sigma2,
        kp2_mask, dist12, gamma_chamfer=gamma_chamfer, gamma_p2p=gamma_p2p,
        repeatability_dist_th=dist_th)
    corr_loss, cm = correspondence_loss_single(desc1, kp1_mask, desc2, kp2_mask, dist12,
                                               beta=beta, dist_th=dist_th)
    loss = gamma_k * kp_loss + gamma_c * corr_loss
    metrics = {"kp_per_cloud": 0.5 * (kp1_mask.sum(-1) + kp2_mask.sum(-1)).to(torch.float32)}
    metrics.update(km)
    metrics.update(cm)
    metrics["loss"] = loss.detach()
    names = list(metrics)
    sums = torch.stack([metrics[k].sum() for k in names] + [loss.new_full((), loss.shape[0])])
    sums = all_reduce_sum(sums, group)
    return loss.sum() / sums[-1], {k: sums[i] / sums[-1] for i, k in enumerate(names)}


def make_losses(params):
    """(global_loss_fn, local_loss_fn) from TrainingParams."""
    if params.loss == "BatchHardTripletMarginLoss":
        gl_loss_fn = partial(batch_hard_triplet_loss, margin=params.margin)
    elif params.loss == "BatchHardContrastiveLoss":
        gl_loss_fn = partial(batch_hard_contrastive_loss, pos_margin=params.pos_margin,
                             neg_margin=params.neg_margin)
    else:
        raise NotImplementedError(f"Unknown loss: {params.loss}")

    if params.loss_gammas is not None:
        gamma_chamfer, gamma_p2p, gamma_c, beta = params.loss_gammas
    else:
        gamma_chamfer, gamma_p2p, gamma_c, beta = 1.0, 1.0, 1.0, 2.0
    loc_loss_fn = partial(keypoint_corr_loss, gamma_c=gamma_c, gamma_chamfer=gamma_chamfer,
                          gamma_p2p=gamma_p2p, beta=beta)
    return gl_loss_fn, loc_loss_fn
