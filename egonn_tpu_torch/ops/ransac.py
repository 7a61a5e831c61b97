"""Batched 6DoF RANSAC registration (port of `egonn_tpu/ops/ransac.py`): every
pair P and every hypothesis H at once, as PyTorch ops on the pairs' device.

* feature matching: one descriptor product per pair and a row / column
  argmin (the mutual check);
* each hypothesis: 3 distinct valid correspondences, 3-point Kabsch (SVD of
  a 3x3), Open3D's edge-length checker (ratio 0.8) and distance checker on
  the sample, then its inliers among all correspondences (0.5 m);
* the best hypothesis by inlier count (the first maximum), then
  `refine_iters` rounds of weighted Kabsch on its inliers, each kept only
  if it loses no inliers.

The geometry runs in true f32: every product of points and rotations is an
elementwise sum, and the descriptor product is a matmul with TF32 off (a
bf16-class pass floors the rotation error at 1-2 degrees).  T maps cloud-1
(query) points into the cloud-2 (map) frame.

Draws: each hypothesis takes 3 distinct indices uniformly among the pair's
valid matches, which is the JAX package's draw weighted to the valid matches,
from uniforms of a `torch.Generator` (on its own device, then moved); or
they are handed over as `samples`.  JAX's random stream cannot be
reproduced, so tests hand over JAX's draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from egonn_tpu_torch.losses.triplet import pairwise_l2
from egonn_tpu_torch.ops.geometry import true_f32

BIG = 1e9


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices in closed form."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def apply_t(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Points (..., N, 3) by 4x4 poses (..., 4, 4): p @ R^T + t, in f32 sums."""
    return (p[..., :, None, :] * m[..., None, :3, :3]).sum(-1) + m[..., None, :3, 3]


def _residual(p: torch.Tensor, q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """|R p + t - q| for points (P, N, 3) under poses (P, H, 4, 4): (P, H, N),
    one coordinate at a time, so that no (P, H, N, 3) block is formed."""
    sq = 0.0
    for i in range(3):
        r = m[..., i, :3]                                   # (P, H, 3)
        x = (r[..., 0, None] * p[:, None, :, 0] + r[..., 1, None] * p[:, None, :, 1]
             + r[..., 2, None] * p[:, None, :, 2] + m[..., i, 3, None])
        sq = sq + (x - q[:, None, :, i]) ** 2
    return torch.sqrt(sq)


def kabsch(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted rigid alignment: 4x4 T (..., 4, 4) with q ~ R p + t.

    p, q (..., N, 3); w (..., N) nonnegative weights."""
    wsum = w.sum(-1).clamp_min(1e-9)
    wn = (w / wsum[..., None])[..., None]
    mu_p = (p * wn).sum(-2)
    mu_q = (q * wn).sum(-2)
    pc = p - mu_p[..., None, :]
    qc = q - mu_q[..., None, :]
    h = ((pc * wn)[..., :, :, None] * qc[..., :, None, :]).sum(-3)   # (..., 3, 3)
    u, _, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    # a proper rotation: the third axis flipped where det(V U^T) < 0 (three
    # points give a rank-2 h, whose third singular pair has a free sign)
    d = torch.sign(_det3(v) * _det3(u))
    v = torch.cat([v[..., :2], v[..., 2:] * d[..., None, None]], dim=-1)
    r = (v[..., :, None, :] * u[..., None, :, :]).sum(-1)              # V diag(1, 1, d) U^T
    t = mu_q - (r * mu_p[..., None, :]).sum(-1)
    m = torch.zeros(*r.shape[:-2], 4, 4, dtype=r.dtype, device=r.device)
    m[..., :3, :3] = r
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def mutual_matches(desc1: torch.Tensor, mask1: torch.Tensor, desc2: torch.Tensor,
                   mask2: torch.Tensor):
    """Mutual nearest neighbours by descriptor L2 distance.

    desc1 (..., K1, D), mask1 (..., K1), desc2 (..., K2, D), mask2 (..., K2).
    Returns (idx2 (..., K1) int64, valid (..., K1) bool): each keypoint of
    cloud 1's match in cloud 2, valid where the match is mutual."""
    with true_f32():
        d = pairwise_l2(desc1, desc2)
    d = torch.where(mask1[..., :, None] & mask2[..., None, :], d, BIG)
    nn12 = d.argmin(-1)
    nn21 = d.argmin(-2)
    rows = torch.arange(desc1.shape[-2], device=desc1.device)
    mutual = torch.gather(nn21, -1, nn12) == rows
    valid = mask1 & mutual & (d.amin(-1) < BIG)
    return nn12, valid


def draw_samples(valid: torch.Tensor, n_hypotheses: int, gen: torch.Generator
                 ) -> torch.Tensor:
    """(P, H, 3) int64: per hypothesis 3 distinct indices, uniform among the
    pair's valid matches (valid (P, K)).  The uniforms come from `gen` on its
    own device, so a CPU generator gives the same draws to a card run and a
    CPU run.  A pair with fewer than 3 valid matches gets indices that
    include an invalid one, so all its hypotheses fail."""
    p, k = valid.shape
    if k < 3:
        raise ValueError(f"RANSAC needs at least 3 keypoints, got {k}")
    u = torch.rand((p, n_hypotheses, 3), generator=gen, dtype=torch.float64,
                   device=gen.device).to(valid.device)
    n = valid.sum(-1).clamp_min(3)[:, None]                           # (P, 1)
    draw = [torch.minimum((u[..., j] * (n - j)).long(), n - j - 1) for j in range(3)]
    a, b, c = draw
    b = b + (b >= a).long()                  # b uniform over [0, n) minus a
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    c = c + (c >= lo).long()
    c = c + (c >= hi).long()                 # c uniform over [0, n) minus {a, b}
    # the valid matches first, in index order
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices
    return torch.gather(order, 1, torch.stack([a, b, c], dim=-1).reshape(p, -1)
                        ).reshape(p, n_hypotheses, 3)


class RansacResult(NamedTuple):
    transform: torch.Tensor    # (P, 4, 4)
    n_inliers: torch.Tensor    # (P,) int32, of the best refined model
    n_matches: torch.Tensor    # (P,) int32 mutual correspondences
    inlier_rmse: torch.Tensor  # (P,)
    fitness: torch.Tensor      # (P,) inliers / matches


@torch.no_grad()
def ransac_6dof(kp1: torch.Tensor, desc1: torch.Tensor, mask1: torch.Tensor,
                kp2: torch.Tensor, desc2: torch.Tensor, mask2: torch.Tensor,
                n_hypotheses: int = 1024, distance_threshold: float = 0.5,
                edge_length_ratio: float = 0.8, refine_iters: int = 2,
                gen: Optional[torch.Generator] = None,
                samples: Optional[torch.Tensor] = None) -> RansacResult:
    """RANSAC over P pairs: kp* (P, K, 3) keypoints, desc* (P, K, D)
    descriptors, mask* (P, K) validity.  The hypotheses' draws are `samples`
    (P, H, 3) int64 indices into cloud 1's keypoints if given, else drawn
    from `gen` (`draw_samples`)."""
    idx2, valid = mutual_matches(desc1, mask1, desc2, mask2)
    p = kp1
    q = torch.gather(kp2, 1, idx2[..., None].expand(-1, -1, 3))      # matched targets
    n_matches = valid.sum(-1)
    if samples is None:
        if gen is None:
            raise ValueError("ransac_6dof needs a generator or the samples")
        samples = draw_samples(valid, n_hypotheses, gen)
    sel = samples.to(kp1.device)
    n_pairs, n_hyp = sel.shape[:2]
    flat = sel.reshape(n_pairs, -1)

    def pick(x):  # (P, K, 3) -> (P, H, 3, 3)
        return torch.gather(x, 1, flat[..., None].expand(-1, -1, 3)).reshape(n_pairs, n_hyp,
                                                                            3, 3)

    p3, q3 = pick(p), pick(q)
    ok = torch.gather(valid, 1, flat).reshape(n_pairs, n_hyp, 3).all(-1)

    def edges(x):
        return torch.stack([(x[..., 0, :] - x[..., 1, :]).norm(dim=-1),
                            (x[..., 1, :] - x[..., 2, :]).norm(dim=-1),
                            (x[..., 0, :] - x[..., 2, :]).norm(dim=-1)], dim=-1)

    ep, eq = edges(p3), edges(q3)
    ratio_ok = ((ep > edge_length_ratio * eq) & (eq > edge_length_ratio * ep)).all(-1)
    m = kabsch(p3, q3, torch.ones(p3.shape[:-1], dtype=p3.dtype, device=p3.device))
    sample_ok = ((apply_t(p3, m) - q3).norm(dim=-1) <= distance_threshold).all(-1)
    inl = valid[:, None, :] & (_residual(p, q, m) <= distance_threshold)
    score = torch.where(ok & ratio_ok & sample_ok, inl.sum(-1), -1)
    best = score.argmax(-1)                                           # the first maximum
    m = m[torch.arange(n_pairs, device=m.device), best]              # (P, 4, 4)

    def inliers(m):
        dist = _residual(p, q, m[:, None])[:, 0]
        return dist, valid & (dist <= distance_threshold)

    for _ in range(refine_iters):
        _, inl = inliers(m)
        w = inl.to(p.dtype)
        m2 = kabsch(p, q, w)
        better = inliers(m2)[1].sum(-1) >= inl.sum(-1)
        m = torch.where(better[:, None, None], m2, m)

    dist, inl = inliers(m)
    n_inl = inl.sum(-1)
    rmse = torch.sqrt(torch.where(inl, dist ** 2, 0.0).sum(-1) / n_inl.clamp_min(1))
    fitness = n_inl / n_matches.clamp_min(1)
    return RansacResult(m, n_inl.to(torch.int32), n_matches.to(torch.int32), rmse, fitness)
