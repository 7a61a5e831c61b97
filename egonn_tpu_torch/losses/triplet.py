"""Global-descriptor losses (port of `egonn_tpu/losses/triplet.py`): batch-hard
triplet and contrastive losses over boolean (B, B) positive / negative masks,
with the miner statistics that dynamic batch expansion reads.

Each loss returns (loss, stats); the stats are detached 0-d tensors (no
device synchronize until a caller reads them).  Reductions over ties split
the gradient evenly, as JAX's do (`amax` / `amin`, not `max(dim)`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

EPS = 1e-12
BIG = 1e9


def pairwise_l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix (..., N, M) in f32.

    Gradient-safe at zero distance: sqrt'(0) = inf would turn the whole
    gradient into 0 * inf = NaN (the self-diagonal is exactly 0), so the zero
    branch is kept out of the sqrt by a double `where`."""
    sq = ((x ** 2).sum(-1)[..., :, None] + (y ** 2).sum(-1)[..., None, :]
          - 2.0 * (x @ y.transpose(-1, -2)))
    sq = torch.clamp_min(sq, 0.0)
    pos = sq > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def mine_hardest(dist: torch.Tensor, positives_mask: torch.Tensor,
                 negatives_mask: torch.Tensor):
    """Per anchor the hardest positive (max masked distance) and the hardest
    negative (min).  Returns (valid (B,), p_idx (B,), n_idx (B,),
    hardest_pos_dist, hardest_neg_dist, stats); rows without a positive or a
    negative are invalid."""
    a1p_keep = positives_mask.any(1)
    a2n_keep = negatives_mask.any(1)
    valid = a1p_keep & a2n_keep

    hardest_pos = torch.where(positives_mask, dist, 0.0).amax(1)
    # index from a -1 fill, so a tie at distance 0 still picks a true positive
    p_idx = torch.where(positives_mask, dist, -1.0).argmax(1)

    neg_d = torch.where(negatives_mask, dist, torch.inf)
    hardest_neg = neg_d.amin(1)
    n_idx = neg_d.argmin(1)

    with torch.no_grad():
        finite_neg = torch.isfinite(hardest_neg)
        n_pos = torch.clamp_min(a1p_keep.sum(), 1)
        n_neg = torch.clamp_min(a2n_keep.sum(), 1)
        stats = {
            "max_pos_pair_dist": torch.where(a1p_keep, hardest_pos, -BIG).amax(),
            "min_pos_pair_dist": torch.where(a1p_keep, hardest_pos, BIG).amin(),
            "mean_pos_pair_dist": torch.where(a1p_keep, hardest_pos, 0.0).sum() / n_pos,
            "max_neg_pair_dist": torch.where(
                a2n_keep, torch.where(finite_neg, hardest_neg, 0.0), -BIG).amax(),
            "min_neg_pair_dist": torch.where(
                a2n_keep, torch.where(finite_neg, hardest_neg, BIG), BIG).amin(),
            "mean_neg_pair_dist": torch.where(
                a2n_keep, torch.where(finite_neg, hardest_neg, 0.0), 0.0).sum() / n_neg,
        }
    return valid, p_idx, n_idx, hardest_pos, hardest_neg, stats


def _embedding_norm(embeddings: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(embeddings.detach(), dim=-1).mean()


def batch_hard_triplet_loss(embeddings: torch.Tensor, positives_mask: torch.Tensor,
                            negatives_mask: torch.Tensor, margin: float
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """TripletMarginLoss(margin, swap=True) over the mined (anchor, hardest
    positive, hardest negative) triplets, averaged over the non-zero losses."""
    dist = pairwise_l2(embeddings, embeddings)
    valid, p_idx, n_idx, d_ap, d_an, stats = mine_hardest(dist, positives_mask,
                                                          negatives_mask)
    # swap: the smaller of d(a, n) and d(p, n)
    d_pn = dist[p_idx, n_idx]
    d_neg = torch.minimum(torch.where(torch.isfinite(d_an), d_an, BIG), d_pn)
    losses = torch.clamp_min(d_ap - d_neg + margin, 0.0)
    losses = torch.where(valid, losses, 0.0)
    num_non_zero = (losses > 0.0).sum()
    loss = losses.sum() / torch.clamp_min(num_non_zero, 1)
    stats.update(loss=loss.detach(), avg_embedding_norm=_embedding_norm(embeddings),
                 num_non_zero_triplets=num_non_zero.to(torch.float32),
                 num_triplets=valid.sum().to(torch.float32))
    return loss, stats


def batch_hard_contrastive_loss(embeddings: torch.Tensor, positives_mask: torch.Tensor,
                                negatives_mask: torch.Tensor, pos_margin: float,
                                neg_margin: float
                                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ContrastiveLoss over the mined pairs: relu(d_ap - pos_margin) and
    relu(neg_margin - d_an), each averaged over its non-zero entries."""
    dist = pairwise_l2(embeddings, embeddings)
    valid, p_idx, n_idx, d_ap, d_an, stats = mine_hardest(dist, positives_mask,
                                                          negatives_mask)
    d_an = torch.where(torch.isfinite(d_an), d_an, 0.0)
    pos_l = torch.where(valid, torch.clamp_min(d_ap - pos_margin, 0.0), 0.0)
    neg_l = torch.where(valid, torch.clamp_min(neg_margin - d_an, 0.0), 0.0)
    pos_nz = (pos_l > 0).sum()
    neg_nz = (neg_l > 0).sum()
    pos_loss = pos_l.sum() / torch.clamp_min(pos_nz, 1)
    neg_loss = neg_l.sum() / torch.clamp_min(neg_nz, 1)
    loss = pos_loss + neg_loss
    stats.update(loss=loss.detach(), avg_embedding_norm=_embedding_norm(embeddings),
                 pos_pairs_above_threshold=pos_nz.to(torch.float32),
                 neg_pairs_above_threshold=neg_nz.to(torch.float32),
                 pos_loss=pos_loss.detach(), neg_loss=neg_loss.detach(),
                 num_pairs=2.0 * valid.sum().to(torch.float32))
    return loss, stats
