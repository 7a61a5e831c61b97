"""Nearest-neighbour retrieval on the device (port of `egonn_tpu/ops/knn.py`):
one distance product and `torch.topk` per chunk of queries, for sets too
large for the evaluator's host brute force."""
from __future__ import annotations

import numpy as np
import torch

from egonn_tpu_torch.ops.geometry import true_f32


@torch.no_grad()
def topk_l2(map_emb: np.ndarray, query_emb: np.ndarray, k: int, chunk: int = 4096,
            device=torch.device("cuda")) -> np.ndarray:
    """Indices (n_query, k) int64 of the k nearest map embeddings by L2
    distance, nearest first.  The product runs in true f32 (no TF32)."""
    k = min(k, len(map_emb))
    m = torch.as_tensor(map_emb, dtype=torch.float32, device=device)
    m_sq = (m * m).sum(dim=1)
    outs = []
    with true_f32():
        for s in range(0, len(query_emb), chunk):
            q = torch.as_tensor(query_emb[s : s + chunk], dtype=torch.float32, device=device)
            d = (q * q).sum(dim=1)[:, None] + m_sq[None, :] - 2.0 * (q @ m.T)
            outs.append(torch.topk(-d, k, dim=1).indices.cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros((0, k), np.int64)
