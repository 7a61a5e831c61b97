"""Truncated Smooth AP as MinkLoc3Dv2 publishes it (jac99/MinkLoc3Dv2,
`losses/truncated_smoothap.py`; Komorowski, ICPR 2022), plain PyTorch.

Departures from the published code: the stats come back as 0-d tensors
instead of `.item()` numbers, and only those the program reports are
kept (`loss`, `positives_per_query`, `best_positive_ranking`, `recall@1`).
The mean over queries keeps the published boolean indexing.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def sigmoid(tensor: torch.Tensor, temp: float) -> torch.Tensor:
    exponent = -tensor / temp
    exponent = torch.clamp(exponent, min=-50, max=50)
    return 1.0 / (1.0 + torch.exp(exponent))


def truncated_smooth_ap(embeddings: torch.Tensor, positives_mask: torch.Tensor,
                        negatives_mask: torch.Tensor, tau1: float, positives_per_query: int,
                        similarity: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if similarity == "cosine":
        s_qz = torch.mm(embeddings, embeddings.t())
    elif similarity == "euclidean":
        s_qz = -torch.cdist(embeddings, embeddings)
    else:
        raise ValueError(similarity)

    # the positives_per_query closest positives of each query
    s_positives = s_qz.detach().clone()
    s_positives.masked_fill_(torch.logical_not(positives_mask), float("-inf"))
    closest_positives_ndx = torch.topk(s_positives, k=positives_per_query, dim=1, largest=True,
                                       sorted=True)[1]
    n_positives = positives_mask.sum(dim=1)

    # the rank of each z with respect to each closest positive of q
    s_diff = s_qz.unsqueeze(1) - s_qz.gather(1, closest_positives_ndx).unsqueeze(2)
    s_sigmoid = sigmoid(s_diff, temp=tau1)

    # among the positives, the closest positive itself left out
    pos_mask = positives_mask.unsqueeze(1)
    pos_s_sigmoid = s_sigmoid * pos_mask
    mask = torch.ones_like(pos_s_sigmoid).scatter(2, closest_positives_ndx.unsqueeze(2), 0.)
    pos_s_sigmoid = pos_s_sigmoid * mask
    r_p = torch.sum(pos_s_sigmoid, dim=2) + 1.

    # among positives and negatives
    neg_mask = negatives_mask.unsqueeze(1)
    neg_s_sigmoid = s_sigmoid * neg_mask
    r_omega = r_p + torch.sum(neg_s_sigmoid, dim=2)
    r = r_p / r_omega

    stats = {"positives_per_query": n_positives.float().mean(dim=0)}
    temp = s_diff.detach() > 0
    temp = torch.logical_and(temp[:, 0], negatives_mask)
    hard_ranking = temp.sum(dim=1)
    stats["best_positive_ranking"] = hard_ranking.float().mean(dim=0)
    stats["recall@1"] = (hard_ranking <= 1).float().mean(dim=0)

    # picks that are no positive (a query with fewer positives) zeroed
    valid_positives_mask = torch.gather(positives_mask, 1, closest_positives_ndx)
    masked_r = r * valid_positives_mask
    n_valid_positives = valid_positives_mask.sum(dim=1)
    valid_q_mask = n_valid_positives > 0
    masked_r = masked_r[valid_q_mask]
    ap = torch.sum(masked_r, dim=1) / n_valid_positives[valid_q_mask]
    loss = 1. - torch.mean(ap)
    stats["loss"] = loss.detach()
    return loss, stats
