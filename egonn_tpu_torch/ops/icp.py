"""Host-side ICP, point-to-point and point-to-plane (port of
`egonn_tpu/ops/icp.py`): the optional refinement of the ground-truth pose in
the evaluation.  Host numpy with scipy's cKDTree (a chunked brute force
without scipy), as in the JAX package; the parameters are the reference's
Open3D defaults (0.1 m voxel downsample, 1.2 m inlier distance, 200
iterations).  Point-to-plane estimates the target's normals by local PCA and
solves the small-angle linearization each iteration.
"""
from __future__ import annotations

import numpy as np


def _voxel_downsample(pc: np.ndarray, voxel: float) -> np.ndarray:
    coords = np.floor(pc / voxel).astype(np.int64)
    _, idx = np.unique(coords, axis=0, return_index=True)
    return pc[np.sort(idx)]


def _nn(query: np.ndarray, ref: np.ndarray):
    try:
        from scipy.spatial import cKDTree

        tree = cKDTree(ref)
        d, i = tree.query(query)
        return d, i
    except ImportError:
        # chunked brute force
        d_out = np.empty(len(query))
        i_out = np.empty(len(query), dtype=np.int64)
        for s in range(0, len(query), 2048):
            c = query[s : s + 2048]
            d = np.linalg.norm(c[:, None] - ref[None], axis=-1)
            i_out[s : s + 2048] = d.argmin(axis=1)
            d_out[s : s + 2048] = d.min(axis=1)
        return d_out, i_out


def _kabsch_np(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    mu_p, mu_q = p.mean(0), q.mean(0)
    h = (p - mu_p).T @ (q - mu_q)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = mu_q - r @ mu_p
    return m


def icp_point_to_point(pc1: np.ndarray, pc2: np.ndarray, init: np.ndarray,
                       voxel: float = 0.1, max_distance: float = 1.2,
                       max_iters: int = 200, tol: float = 1e-6) -> np.ndarray:
    """Refine `init` (pc1 -> pc2) with point-to-point ICP.

    Parameters mirror the reference misc/point_clouds.py:31-62 defaults."""
    p = _voxel_downsample(np.asarray(pc1, np.float64), voxel)
    q = _voxel_downsample(np.asarray(pc2, np.float64), voxel)
    t = np.array(init, np.float64)
    prev_err = np.inf
    for _ in range(max_iters):
        p_t = p @ t[:3, :3].T + t[:3, 3]
        d, idx = _nn(p_t, q)
        sel = d <= max_distance
        if sel.sum() < 3:
            break
        m = _kabsch_np(p_t[sel], q[idx[sel]])
        t = m @ t
        err = float(np.mean(d[sel]))
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return t


def estimate_normals(pc: np.ndarray, k: int = 20) -> np.ndarray:
    """Per-point normals by local PCA over the k nearest neighbors (Open3D
    estimate_normals equivalent; orientation is arbitrary — point-to-plane
    residuals are sign-insensitive through their square)."""
    pc = np.asarray(pc, np.float64)
    k = min(k, len(pc))
    try:
        from scipy.spatial import cKDTree

        _, idx = cKDTree(pc).query(pc, k=k)
    except ImportError:
        d = np.linalg.norm(pc[:, None] - pc[None], axis=-1)
        idx = np.argsort(d, axis=1)[:, :k]
    nbrs = pc[idx]                              # (N, k, 3)
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    # eigenvector of the smallest eigenvalue = surface normal
    _, vecs = np.linalg.eigh(cov)
    return vecs[:, :, 0]


def icp_point_to_plane(pc1: np.ndarray, pc2: np.ndarray, init: np.ndarray,
                       voxel: float = 0.1, max_distance: float = 1.2,
                       max_iters: int = 200, tol: float = 1e-6,
                       normals_k: int = 20) -> np.ndarray:
    """Refine `init` (pc1 -> pc2) with point-to-plane ICP (reference
    misc/point_clouds.py:52-60 point2plane branch; normals estimated on the
    0.1 m-downsampled target as Open3D does with radius/knn search).

    Each iteration solves the small-angle linearization
    min_{w,t} sum ((R(w) p + t - q) . n)^2 via the standard 6x6 normal
    equations with rows [p x n, n]."""
    p = _voxel_downsample(np.asarray(pc1, np.float64), voxel)
    q = _voxel_downsample(np.asarray(pc2, np.float64), voxel)
    n = estimate_normals(q, k=normals_k)
    t = np.array(init, np.float64)
    prev_err = np.inf
    for _ in range(max_iters):
        p_t = p @ t[:3, :3].T + t[:3, 3]
        d, idx = _nn(p_t, q)
        sel = d <= max_distance
        if sel.sum() < 6:
            break
        ps, qs, ns = p_t[sel], q[idx[sel]], n[idx[sel]]
        r = np.einsum("ij,ij->i", ps - qs, ns)          # signed plane residual
        a = np.concatenate([np.cross(ps, ns), ns], axis=1)  # (M, 6)
        h = a.T @ a
        g = a.T @ r
        try:
            x = np.linalg.solve(h + 1e-9 * np.eye(6), -g)
        except np.linalg.LinAlgError:
            break
        wx, wy, wz, tx, ty, tz = x
        c = np.array([
            [1.0, -wz, wy, tx],
            [wz, 1.0, -wx, ty],
            [-wy, wx, 1.0, tz],
            [0.0, 0.0, 0.0, 1.0],
        ])
        # re-orthonormalize the small-angle rotation via SVD
        u, _, vt = np.linalg.svd(c[:3, :3])
        c[:3, :3] = u @ np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))]) @ vt
        t = c @ t
        err = float(np.mean(np.abs(r)))
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return t


def icp(pc1: np.ndarray, pc2: np.ndarray, init: np.ndarray,
        point2plane: bool = False, **kwargs) -> np.ndarray:
    """Reference-API dispatch (misc/point_clouds.py:31-62)."""
    fn = icp_point_to_plane if point2plane else icp_point_to_point
    return fn(pc1, pc2, init, **kwargs)
