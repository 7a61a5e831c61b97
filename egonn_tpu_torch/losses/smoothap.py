"""Truncated Smooth AP, MinkLoc3Dv2's global loss (Komorowski, "Improving
Point Cloud Based Place Recognition with Ranking-based Loss and Large Batch
Training", ICPR 2022; jac99/MinkLoc3Dv2 `losses/truncated_smoothap.py`).

For each query q the k closest positives P[q, j] are ranked by a sigmoid of
temperature tau1 over similarity differences D[q, j, z] = s[q, z] -
s[q, P[q, j]]: among the positives, r_p = 1 + sum over positives z other than
P[q, j] of sig(D), and among all, r_omega = r_p + sum over negatives z of
sig(D).  AP_q averages r_p / r_omega over the valid picks (those that are
positives: a query with fewer than k positives picks non-positives too),
and the loss is 1 - the mean of AP_q over the queries with a valid pick.

The published loss takes that mean by boolean indexing and reads its stats
with `.item()`, both of which wait for the device.  Here the mean is a
masked one over the same terms, and the stats are detached 0-d tensors, so
a train step never blocks the host.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def similarity_matrix(embeddings: torch.Tensor, similarity: str) -> torch.Tensor:
    """(B, B) similarities: E E^T (`cosine`, on the embeddings as given: the
    published loss does not normalize them) or -cdist(E, E) (`euclidean`)."""
    if similarity == "cosine":
        return embeddings @ embeddings.t()
    if similarity == "euclidean":
        return -torch.cdist(embeddings, embeddings)
    raise NotImplementedError(f"Unknown similarity: {similarity}")


def sigmoid(x: torch.Tensor, tau: float) -> torch.Tensor:
    """1 / (1 + exp(-x / tau)), the exponent clamped to [-50, 50]."""
    return 1.0 / (1.0 + torch.exp(torch.clamp(-x / tau, -50.0, 50.0)))


def truncated_smooth_ap(embeddings: torch.Tensor, positives_mask: torch.Tensor,
                        negatives_mask: torch.Tensor, tau1: float = 0.01, k: int = 4,
                        similarity: str = "euclidean"
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, stats) of embeddings (B, D) with boolean (B, B) masks.  Stats:
    `loss`, `positives_per_query`, `best_positive_ranking` (negatives ranked
    above the closest positive, mean over queries) and `recall@1` (the share
    of queries whose closest positive has at most one negative above it, as
    the published loss counts it)."""
    s = similarity_matrix(embeddings, similarity)
    closest = torch.topk(s.detach().masked_fill(~positives_mask, float("-inf")), k,
                         dim=1).indices                                   # (B, k)
    d = s.unsqueeze(1) - s.gather(1, closest).unsqueeze(2)                # (B, k, B)
    sig = sigmoid(d, tau1)
    others = torch.ones_like(sig).scatter(2, closest.unsqueeze(2), 0.0)
    r_p = (sig * positives_mask.unsqueeze(1) * others).sum(2) + 1.0
    r_omega = r_p + (sig * negatives_mask.unsqueeze(1)).sum(2)
    r = r_p / r_omega

    valid = positives_mask.gather(1, closest)                             # (B, k)
    n_valid = valid.sum(1)
    valid_q = n_valid > 0
    ap = (r * valid).sum(1) / n_valid.clamp_min(1)
    loss = 1.0 - (ap * valid_q).sum() / valid_q.sum()

    with torch.no_grad():
        hard_ranking = ((d[:, 0] > 0) & negatives_mask).sum(1)
        stats = {"loss": loss.detach(),
                 "positives_per_query": positives_mask.sum(1).float().mean(),
                 "best_positive_ranking": hard_ranking.float().mean(),
                 "recall@1": (hard_ranking <= 1).float().mean()}
    return loss, stats
