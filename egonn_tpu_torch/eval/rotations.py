"""Rotation robustness (port of `egonn_tpu/eval/rotations.py`): Recall@N as a
function of a rotation of every query cloud about +z by theta (default 0,
10, ..., 180 degrees); the map set is embedded once.  The rotation wraps
the point-cloud loader (a 3x3 product on the raw cloud before padding)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from egonn_tpu_torch.eval.evaluator import Evaluator


class _RotatedLoader:
    def __init__(self, base, rot: np.ndarray):
        self.base, self.rot = base, rot

    def __call__(self, path: str) -> np.ndarray:
        return (self.base(path) @ self.rot.T).astype(np.float32)


class RotationEvaluator(Evaluator):
    def __init__(self, *args, thetas_deg: Sequence[float] = tuple(range(0, 181, 10)),
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.thetas_deg = list(thetas_deg)

    def evaluate(self) -> Dict[float, Dict]:
        """{theta_deg: recall dict} (`compute_recall`'s)."""
        map_e = self.compute_embeddings(self.eval_set.map_set)
        results: Dict[float, Dict] = {}
        base_loader = self.pc_loader
        try:
            for theta in self.thetas_deg:
                rad = np.radians(theta)
                c, s = np.cos(rad), np.sin(rad)
                rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
                self.pc_loader = _RotatedLoader(base_loader, rot)
                query_e = self.compute_embeddings(self.eval_set.query_set)
                results[theta] = self.compute_recall(map_e["global"], query_e["global"])
        finally:
            self.pc_loader = base_loader
        return results
