"""The EgoNN training step, plain PyTorch: augmentation (its draws taken from
a `torch.Generator` in the program's order), the batch-hard triplet loss on
the global descriptors, the keypoint (probabilistic chamfer + point to
point) and descriptor correspondence losses on the local pairs, autograd,
and Adam with coupled L2 weight decay written out.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import sparse

BIG = 1e9


# ---------------------------------------------------------------------------
# augmentation (TrainTransform per cloud, TrainSetTransform per batch)
# ---------------------------------------------------------------------------

def draw_augmentation(gen: torch.Generator, b: int, n: int) -> Dict[str, torch.Tensor]:
    """aug_mode 2's random numbers, drawn in the program's order."""
    dev = gen.device

    def uni(shape, lo=0.0, hi=1.0):
        return torch.empty(shape, device=dev).uniform_(lo, hi, generator=gen)

    d = {"noise": torch.empty((b, n, 3), device=dev).normal_(generator=gen),
         "remove_r": uni((b,), 0.0, 0.1), "remove_u": uni((b, n)),
         "translation": torch.empty((b, 1, 3), device=dev).normal_(generator=gen),
         "block_area": uni((b,), 0.02, 0.33), "block_aspect": uni((b,), 0.3, 3.3),
         "block_ux": uni((b,)), "block_uy": uni((b,)), "block_apply": uni((b,)),
         "rotation_u": uni((b,))}
    d["flip_u"] = uni(())
    return d


def augment(pc: torch.Tensor, mask: torch.Tensor, d: Dict[str, torch.Tensor]) -> torch.Tensor:
    pc = pc + torch.clamp(0.1 * d["noise"], -0.2, 0.2)
    pc = torch.where((d["remove_u"] < d["remove_r"][:, None])[..., None], 0.0, pc)
    pc = pc + 0.3 * d["translation"]
    theta = math.pi * 2.0 * (d["rotation_u"] - 0.5)
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    rot = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], -1).reshape(-1, 3, 3)
    pc = pc @ rot
    # a random (x, y) rectangle of the valid points' box, with probability 0.4
    lo = torch.where(mask[..., None], pc, BIG).amin(1)
    hi = torch.where(mask[..., None], pc, -BIG).amax(1)
    span = hi - lo
    area = d["block_area"] * (span[:, 0] * span[:, 1])
    h = torch.sqrt(area * d["block_aspect"])
    w = torch.sqrt(area / d["block_aspect"])
    x = (lo[:, 0] + d["block_ux"] * (span[:, 0] - w))[:, None]
    y = (lo[:, 1] + d["block_uy"] * (span[:, 1] - h))[:, None]
    inside = ((x < pc[..., 0]) & (pc[..., 0] < x + w[:, None])
              & (y < pc[..., 1]) & (pc[..., 1] < y + h[:, None]))
    pc = torch.where((inside & (d["block_apply"] < 0.4)[:, None])[..., None], 0.0, pc)
    # one flip of x (p .25) or y (p .25) for the whole batch
    r = d["flip_u"]
    sign = torch.stack([torch.where(r <= 0.25, -1.0, 1.0),
                        torch.where((r > 0.25) & (r <= 0.5), -1.0, 1.0),
                        torch.where((r > 0.5) & (r <= 0.5), -1.0, 1.0)])
    return pc * sign


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def pairwise_l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    sq = ((x ** 2).sum(-1)[..., :, None] + (y ** 2).sum(-1)[..., None, :]
          - 2.0 * (x @ y.transpose(-1, -2)))
    sq = torch.clamp_min(sq, 0.0)
    pos = sq > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def triplet_loss(emb: torch.Tensor, positives: torch.Tensor, negatives: torch.Tensor,
                 margin: float, parts: dict) -> torch.Tensor:
    """Batch-hard triplet margin loss with swap, averaged over the non-zero
    triplets."""
    dist = pairwise_l2(emb, emb)
    valid = positives.any(1) & negatives.any(1)
    d_ap = torch.where(positives, dist, 0.0).amax(1)
    p_idx = torch.where(positives, dist, -1.0).argmax(1)
    neg_d = torch.where(negatives, dist, torch.inf)
    d_an = neg_d.amin(1)
    n_idx = neg_d.argmin(1)
    d_neg = torch.minimum(torch.where(torch.isfinite(d_an), d_an, BIG), dist[p_idx, n_idx])
    losses = torch.where(valid, torch.clamp_min(d_ap - d_neg + margin, 0.0), 0.0)
    parts["num_non_zero_triplets"] = (losses > 0.0).sum()
    return losses.sum() / torch.clamp_min((losses > 0.0).sum(), 1)


def _mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, 0.0).sum(-1) / torch.clamp_min(mask.sum(-1), 1)


def _nearest_dist(kp: torch.Tensor, pc: torch.Tensor, pc_mask: torch.Tensor) -> torch.Tensor:
    """Distance of each keypoint to the nearest valid point of its cloud."""
    with torch.no_grad():
        best = torch.full(kp.shape[:2], math.inf, device=kp.device)
        best_i = torch.zeros(kp.shape[:2], dtype=torch.long, device=kp.device)
        for s in range(0, pc.shape[1], 8192):
            d = torch.where(pc_mask[:, None, s:s + 8192], pairwise_l2(kp, pc[:, s:s + 8192]), BIG)
            d_min, i_min = d.min(-1)
            better = d_min < best
            best = torch.where(better, d_min, best)
            best_i = torch.where(better, i_min + s, best_i)
    nearest = torch.gather(pc, 1, best_i[..., None].expand(-1, -1, 3))
    sq = torch.clamp_min((kp ** 2).sum(-1) + (nearest ** 2).sum(-1)
                         - 2.0 * (kp * nearest).sum(-1), 0.0)
    pos = sq > 0.0
    d = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
    return torch.where(pc_mask.any(1)[:, None], d, BIG)


def local_loss(pc1, m1, y1, pc2, m2, y2, t_gt, gammas, parts: dict) -> torch.Tensor:
    """Keypoint loss (probabilistic chamfer + point to point) plus the
    descriptor correspondence loss, averaged over the pairs."""
    g_chamfer, g_p2p, g_c, beta = gammas
    kp1, kp2, k1m, k2m = y1["keypoints"], y2["keypoints"], y1["kp_mask"], y2["kp_mask"]
    s1, s2 = y1["sigma"][..., 0], y2["sigma"][..., 0]
    kp1t = kp1 @ t_gt[:, :3, :3].transpose(-1, -2) + t_gt[:, None, :3, 3]
    dist = torch.where(k1m[:, :, None] & k2m[:, None, :], pairwise_l2(kp1t, kp2), BIG)
    d1, i1 = dist.amin(-1), dist.argmin(-1)
    d2, i2 = dist.amin(-2), dist.argmin(-2)
    s12 = torch.clamp_min((s1 + torch.gather(s2, 1, i1)) / 2.0, 1e-12)
    s21 = torch.clamp_min((s2 + torch.gather(s1, 1, i2)) / 2.0, 1e-12)
    chamfer = 0.5 * (_mean(torch.log(s12) + torch.clamp_max(d1, BIG) / s12, k1m)
                     + _mean(torch.log(s21) + torch.clamp_max(d2, BIG) / s21, k2m))
    p2p = 0.5 * (_mean(_nearest_dist(kp1, pc1, m1), k1m) + _mean(_nearest_dist(kp2, pc2, m2), k2m))
    kp_loss = g_chamfer * chamfer + g_p2p * p2p
    # correspondence: cross-entropy of each matched keypoint's similarities
    rows = k1m & (d1 <= 0.5)
    logits = torch.where(k2m[:, None, :],
                         (y1["descriptors"] @ y2["descriptors"].transpose(-1, -2))
                         * math.exp(beta), -BIG)
    ce = torch.logsumexp(logits, -1) - torch.gather(logits, 2, i1[..., None])[..., 0]
    corr = torch.where(rows, ce, 0.0).sum(-1) / torch.clamp_min(rows.sum(-1), 1)
    parts.update(kp_per_cloud=0.5 * (k1m.sum(-1) + k2m.sum(-1)).float().mean(),
                 loss_chamfer=(g_chamfer * chamfer).mean(), loss_p2p=p2p.mean(),
                 correspondence_loss=corr.mean(), matching_keypoints=rows.sum(-1).float().mean())
    return (kp_loss + g_c * corr).mean()


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

class Adam:
    """Adam (0.9, 0.999, eps 1e-8) with the decay added to the gradient
    before the moments (coupled L2, not AdamW)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """Returns the gradients as the moments took them (with the decay)."""
        self.t += 1
        taken = {}
        for n, p in self.params.items():
            g = p.grad + self.wd * p
            taken[n] = g
            m, v = self.m[n], self.v[n]
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            m_hat = m / (1 - 0.9 ** self.t)
            v_hat = v / (1 - 0.999 ** self.t)
            p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + 1e-8))
            p.grad = None
        return taken


def forward(model, quantizer, spec, clouds, mask):
    keys, _, _ = sparse.quantize(quantizer, clouds, mask, spec.capacities[0], spec.pack)
    return model(sparse.build_pyramid(keys, spec), quantizer)


def train_step(model, quantizer, spec, opt: Adam, g: dict, l: dict, gen: torch.Generator,
               train_cfg: dict):
    """One step on the global batch g and the local pairs l; returns (loss,
    the gradients as Adam took them, the loss's parts under the program's
    stats names)."""
    parts: dict = {}
    model.train()
    b, n, _ = g["clouds"].shape
    clouds = augment(g["clouds"], g["point_mask"], draw_augmentation(gen, b, n))
    yg = forward(model, quantizer, spec, clouds, g["point_mask"])
    gl = triplet_loss(yg["global"], g["positives_mask"], g["negatives_mask"],
                      train_cfg["margin"], parts)
    y1 = forward(model, quantizer, spec, l["anc_clouds"], l["anc_mask"])
    y2 = forward(model, quantizer, spec, l["pos_clouds"], l["pos_mask"])
    loc = local_loss(l["anc_clouds"], l["anc_mask"], y1, l["pos_clouds"], l["pos_mask"], y2,
                     l["t_gt"], train_cfg["loss_gammas"], parts)
    loss = gl + loc
    loss.backward()
    parts["global_loss"] = gl
    return loss.detach(), opt.step(), {k: float(v.detach()) for k, v in parts.items()}
