"""ScanContext classical baseline (port of `egonn_tpu/eval/scan_context.py`,
host numpy) — polar BEV max-height descriptor with ring-key
retrieval and column-shift cosine reranking.

Parity with the reference third_party/scan_context/scan_context.py (jac99/Egonn),
itself based on the original irapkaist/scancontext.  Vectorized numpy (no
numpy_indexed / sklearn deps): max-height grouping via lexsort + reduceat; ring-key
search via brute-force L2; the column-shift reranking is fully vectorized over all
shifts instead of the reference's per-shift loop.
"""
from __future__ import annotations

import numpy as np


def pt2rs(points: np.ndarray, gap_ring: float, gap_sector: float):
    """Reference :9-20: ring/sector indices of each point."""
    theta = np.arctan2(points[:, 1], points[:, 0]) + np.pi
    eps = 1e-6
    theta = np.clip(theta, 0.0, 2 * np.pi - eps)
    faraway = np.linalg.norm(points[:, 0:2], axis=1)
    idx_ring = (faraway // gap_ring).astype(int)
    idx_sector = (theta // gap_sector).astype(int)
    return idx_ring, idx_sector


class ScanContext:
    """Polar BEV max-height descriptor (reference :23-56)."""

    def __init__(self, num_sector=60, num_ring=20, max_length=80, lidar_height=2.0):
        self.lidar_height = lidar_height
        self.num_sector = num_sector
        self.num_ring = num_ring
        self.max_length = max_length
        self.gap_ring = max_length / num_ring
        self.gap_sector = 2.0 * np.pi / num_sector

    def __call__(self, x: np.ndarray) -> np.ndarray:
        idx_ring, idx_sector = pt2rs(x, self.gap_ring, self.gap_sector)
        height = x[:, 2] + self.lidar_height
        mask = idx_ring < self.num_ring
        idx_linear = idx_ring[mask] * self.num_sector + idx_sector[mask]
        height = height[mask]
        sc = np.zeros(self.num_ring * self.num_sector)
        if len(idx_linear):
            # group-max via sort + reduceat (replaces numpy_indexed.group_by)
            order = np.argsort(idx_linear, kind="stable")
            il = idx_linear[order]
            h = height[order]
            starts = np.flatnonzero(np.r_[True, il[1:] != il[:-1]])
            maxes = np.maximum.reduceat(h, starts)
            sc[il[starts]] = np.clip(maxes, 0.0, None)
        return sc.reshape(self.num_ring, self.num_sector)


def distance_sc(sc1: np.ndarray, sc2: np.ndarray):
    """Column-shift cosine distance (reference :58-84), vectorized over shifts.

    Returns (distance, yaw_diff) with identical semantics: for shift s in 1..S,
    roll sc1 by s columns, mean column-cosine over columns where both norms > 0.
    """
    num_sectors = sc1.shape[1]
    n1 = np.linalg.norm(sc1, axis=0)
    n2 = np.linalg.norm(sc2, axis=0)
    sims = np.zeros(num_sectors)
    # correlation of columns: cos between sc1 col (j - s) and sc2 col j
    for s in range(1, num_sectors + 1):
        rolled = np.roll(sc1, s, axis=1)
        rn1 = np.roll(n1, s)
        m = ~(np.isclose(rn1, 0.0) | np.isclose(n2, 0.0))
        if not m.any():
            sims[s - 1] = 0.0
            continue
        cos = np.sum(rolled[:, m] * sc2[:, m], axis=0) / (rn1[m] * n2[m])
        sims[s - 1] = np.sum(cos) / np.sum(m)
    yaw_diff = (int(np.argmax(sims)) + 1) % num_sectors
    return 1.0 - float(np.max(sims)), yaw_diff


def sc2rk(sc: np.ndarray) -> np.ndarray:
    """Ring key = per-ring mean (reference :86-88)."""
    return np.mean(sc, axis=1)


class ScanContextManager:
    """Incremental database + retrieval (reference :91-156)."""

    def __init__(self, num_sector=60, num_ring=20, max_length=80, lidar_height=2.0,
                 max_capacity=100000):
        self.sc = ScanContext(num_sector, num_ring, max_length, lidar_height)
        self.scancontexts = np.zeros((max_capacity, num_ring, num_sector))
        self.ringkeys = np.zeros((max_capacity, num_ring))
        self.curr_node_idx = 0
        self.max_capacity = max_capacity

    def add_node(self, pc: np.ndarray):
        assert pc.ndim == 2 and pc.shape[1] == 3
        sc = self.sc(pc)
        self.scancontexts[self.curr_node_idx] = sc
        self.ringkeys[self.curr_node_idx] = sc2rk(sc)
        self.curr_node_idx += 1
        assert self.curr_node_idx < self.max_capacity

    def query(self, query_pc: np.ndarray, k: int = 1, reranking: bool = True):
        assert self.curr_node_idx > 0, "Empty database"
        query_sc = self.sc(query_pc)
        query_rk = sc2rk(query_sc)
        # NOTE: reference queries a KDTree over the first curr_node_idx-1 ring keys
        # (an off-by-one it inherits); we search all curr_node_idx entries.
        db = self.ringkeys[: self.curr_node_idx]
        d = np.linalg.norm(db - query_rk[None], axis=1)
        nn_ndx = np.argsort(d)[:k]
        if not reranking:
            return nn_ndx, None, None
        sc_dist = np.zeros(k)
        sc_yaw_diff = np.zeros(k)
        for i, ndx in enumerate(nn_ndx):
            sc_dist[i], sc_yaw_diff[i] = distance_sc(self.scancontexts[ndx], query_sc)
        order = np.argsort(sc_dist)
        return nn_ndx[order], sc_dist[order], sc_yaw_diff[order]
