"""Evaluation (port of `egonn_tpu/eval/evaluator.py`): global retrieval
(Recall@N) and local 6DoF registration, with the reference's protocol.

* `Evaluator` (global only): map and query global descriptors, nearest
  neighbours, Recall@N for radii (default 5, 20 m) and N in 1..k, and
  Recall@1%.
* `GLEvaluator`: for each query whose ground-truth distance to its top-1
  map element is <= 20 m, RANSAC registration on the n_k keypoints of
  lowest sigma, keypoint repeatability (matched <= 0.5 m under the
  ground-truth transform), RRE / RTE against the (optionally ICP-refined)
  ground truth, and success = RTE <= 2 m and RRE <= 5 deg.  With
  `icp_refine` the ICP refines the ground truth, not the estimate.

The embeddings run through `inference.forward` on the model's device in
fixed-size batches of padded clouds; keypoint selection and recall are
host numpy, as in the JAX package; RANSAC is `ops/ransac.py`, every
eligible pair in one batched call (chunked to bound memory), its draws from
a CPU `torch.Generator` seeded 0, moved to the device.  The model carries
its weights, so `evaluate` and `compute_embeddings` take none.  `band_ok`
is always {}: no port kernel keeps band windows.

With a data-parallel `group` (`parallel/mesh.py`) the batch size is rounded
up to a multiple of the ranks, each rank reads and embeds its rows of every
batch and the outputs are gathered, so every rank holds every embedding and
returns the same metrics.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from egonn_tpu_torch import inference
from egonn_tpu_torch.data.base import EvaluationSet, get_pointcloud_loader
from egonn_tpu_torch.data.pipeline import pad_cloud
from egonn_tpu_torch.models.factory import BuiltModel
from egonn_tpu_torch.ops.geometry import (
    kitti_relative_pose,
    mulran_relative_pose,
    relative_pose,
    rotation_error_deg,
)
from egonn_tpu_torch.ops.ransac import ransac_6dof
from egonn_tpu_torch.parallel.mesh import all_gather_rows, row_slice, world_size
from egonn_tpu_torch.sparse.pyramid import build_pyramid, capacity_report
from egonn_tpu_torch.utils import tracing

# above this many map x query entries, retrieval runs on the device
DEVICE_KNN_ENTRIES = 4_000_000
# RANSAC pairs per call: the (P, H, K) f32 residual block stays under 1 GiB
RANSAC_BLOCK_BYTES = 1 << 30


def select_keypoints(y: Dict[str, np.ndarray], n_k: int, random_start: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
    """A batch's n_k selected `keypoints`, `descriptors`, `sigma` and
    `kp_valid` per cloud: lowest sigma first, or, given `random_start` (the
    batch's first element), in a seeded random order (one
    `default_rng([0, random_start])` draw per batch); invalid keypoints
    last.  y holds the batch's model outputs as numpy."""
    kp_mask = y["kp_mask"]
    sigma = np.where(kp_mask, y["sigma"][..., 0], np.inf)
    if random_start is not None:
        rnd = np.random.default_rng([0, random_start]).random(sigma.shape)
        order = np.argsort(np.where(kp_mask, rnd, np.inf), axis=1)[:, :n_k]
    else:
        order = np.argsort(sigma, axis=1)[:, :n_k]

    def take(arr):
        return np.take_along_axis(arr, order[..., None] if arr.ndim == 3 else order, axis=1)

    return {"keypoints": take(y["keypoints"]), "descriptors": take(y["descriptors"]),
            "sigma": take(sigma), "kp_valid": take(kp_mask)}


class Evaluator:
    """Global-descriptor evaluator."""

    def __init__(self, dataset_root: str, dataset_type: str, eval_set_pickle: str,
                 built: BuiltModel, num_points: int = 65536, batch_size: int = 8,
                 radius=(5, 20), k: int = 50, debug: bool = False,
                 n_samples: Optional[int] = None, group=None):
        self.dataset_root = dataset_root
        self.dataset_type = dataset_type
        self.built = built
        self.num_points = num_points
        self.group = group
        world = world_size(group)
        self.batch_size = -(-batch_size // world) * world
        self.radius = radius
        self.k = k
        self.eval_set = EvaluationSet()
        self.eval_set.load(os.path.join(dataset_root, eval_set_pickle))
        if debug:
            self.eval_set.map_set = self.eval_set.map_set[:4]
            self.eval_set.query_set = self.eval_set.query_set[:4]
        if n_samples is not None and len(self.eval_set.query_set) > n_samples:
            # an even stride over the queries (in-training evaluation)
            step = len(self.eval_set.query_set) / n_samples
            self.eval_set.query_set = [self.eval_set.query_set[int(i * step)]
                                       for i in range(n_samples)]
        self.pc_loader = get_pointcloud_loader(dataset_type)
        self.ignore_keypoint_saliency = False
        self._calibrated = False
        # {} always: no port kernel keeps band windows
        self.band_ok: Optional[Dict[str, bool]] = None
        # per level {"cap_L{l}": (n_unique_max, capacity, ok)} on the first
        # embedded batch; n_unique > capacity means the level dropped voxels
        self.capacity_ok: Optional[Dict[str, tuple]] = None

    # ---------- embeddings ----------

    def load_clouds(self, elements, rows: int) -> tuple:
        """(rows, num_points, 3) float32 clouds and (rows, num_points) masks:
        the elements' scans, padded (rows past the elements stay empty)."""
        clouds = np.zeros((rows, self.num_points, 3), np.float32)
        mask = np.zeros((rows, self.num_points), bool)
        for i, e in enumerate(elements):
            pc = self.pc_loader(os.path.join(self.dataset_root, e.rel_scan_filepath))
            clouds[i], mask[i] = pad_cloud(np.asarray(pc, np.float32), self.num_points)
        return clouds, mask

    @torch.no_grad()
    def _check_capacity(self, clouds: torch.Tensor, mask: torch.Tensor) -> None:
        """Per-level voxel-capacity state on one batch, with a warning where a
        level drops voxels; once per evaluator."""
        quantizer, spec = self.built.quantizer, self.built.pyramid_spec
        res = quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
        pyr = build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys,
                            n_unique0=res.n_unique)
        self.band_ok = {}
        self.capacity_ok = capacity_report(pyr, spec, self.group)
        bad = {k: v for k, v in self.capacity_ok.items() if not v[2]}
        if bad:
            detail = ", ".join(f"{k}: {n} > {c}" for k, (n, c, _) in sorted(bad.items()))
            print(f"WARNING: voxel-capacity overflow at eval ({detail}) — the densest voxels"
                  " beyond each capacity were dropped; recall may degrade.  Raise the capacity"
                  " table (PyramidSpec capacities / model cap0) or calibrate it on this"
                  " dataset (sparse/calibrate.py calibrate_capacities)")

    def _maybe_calibrate(self) -> None:
        """With EGONN_AUTO_CAPCALIB=1, refit the capacity table to this
        dataset's occupancy (16 scans of the map set) before the first
        forward.  Capacities are shapes only: the weights do not depend on
        them."""
        if self._calibrated:
            return
        self._calibrated = True
        if os.environ.get("EGONN_AUTO_CAPCALIB", "0") != "1":
            return
        from egonn_tpu_torch.sparse.calibrate import calibrate_capacities

        sample_set = self.eval_set.map_set or self.eval_set.query_set
        stride = max(1, len(sample_set) // 16)
        sample = sample_set[::stride][:16]
        clouds, mask = self.load_clouds(sample, len(sample))
        spec = self.built.pyramid_spec
        fitted = calibrate_capacities(clouds, mask, self.built.quantizer, spec,
                                      device=self.built.device)
        if fitted != spec.capacities:
            print(f"capacity calibration: {spec.capacities} -> {fitted}")
            self.built = dataclasses.replace(
                self.built, pyramid_spec=dataclasses.replace(spec, capacities=fitted))

    def compute_embeddings(self, eval_subset, with_local: bool = False, n_k: int = 256
                           ) -> Dict[str, np.ndarray]:
        """Stacked numpy outputs for the subset: `global`, and with_local the
        n_k selected `keypoints`, `descriptors`, `sigma` and `kp_valid`."""
        self._maybe_calibrate()
        device = self.built.device
        bs = self.batch_size
        rows = row_slice(bs, self.group)
        outs: Dict[str, List[np.ndarray]] = {}
        for start in range(0, len(eval_subset), bs):
            chunk = eval_subset[start : start + bs]
            clouds, mask = self.load_clouds(chunk[rows], rows.stop - rows.start)
            clouds = torch.from_numpy(clouds).to(device)
            mask = torch.from_numpy(mask).to(device)
            if self.capacity_ok is None:
                self._check_capacity(clouds, mask)
            n = len(chunk)
            y = inference.forward(self.built, clouds, mask, with_local)
            y = {k: all_gather_rows(v, self.group)[:n].cpu().numpy() for k, v in y.items()}
            outs.setdefault("global", []).append(y["global"])
            if with_local:
                random_start = start if self.ignore_keypoint_saliency else None
                for k, v in select_keypoints(y, n_k, random_start).items():
                    outs.setdefault(k, []).append(v)
        return {k: np.concatenate(v) for k, v in outs.items()}

    # ---------- retrieval ----------

    def evaluate(self) -> Dict:
        map_e = self.compute_embeddings(self.eval_set.map_set)
        query_e = self.compute_embeddings(self.eval_set.query_set)
        metrics = self.compute_recall(map_e["global"], query_e["global"])
        metrics["band_ok"] = self.band_ok
        metrics["capacity_ok"] = self.capacity_ok
        return metrics

    def compute_recall(self, map_emb: np.ndarray, query_emb: np.ndarray) -> Dict:
        """Recall@N for N in 1..k per radius, Recall@1% and each query's top-1."""
        map_pos = self.eval_set.get_map_positions()
        query_pos = self.eval_set.get_query_positions()
        k = min(self.k, len(map_emb))
        threshold = max(int(round(len(map_emb) / 100.0)), 1)  # 1% of the map

        recall = {r: np.zeros(k) for r in self.radius}
        one_percent_recall = {r: 0.0 for r in self.radius}
        kk = max(k, threshold)
        if len(map_emb) * len(query_emb) > DEVICE_KNN_ENTRIES:
            from egonn_tpu_torch.ops.knn import topk_l2

            nn_ndx = topk_l2(map_emb, query_emb, kk, device=self.built.device)
        else:  # host float64 brute force, as the reference
            dist = np.linalg.norm(query_emb[:, None].astype(np.float64)
                                  - map_emb[None].astype(np.float64), axis=-1)
            nn_ndx = np.argsort(dist, axis=1)[:, :kk]
        top1_ndx = nn_ndx[:, 0]
        for i in range(len(query_emb)):
            geo = np.linalg.norm(map_pos[nn_ndx[i]] - query_pos[i], axis=1)
            for r in self.radius:
                hits = geo <= r
                if hits[:k].any():
                    recall[r][int(np.argmax(hits[:k])):] += 1
                if hits[:threshold].any():
                    one_percent_recall[r] += 1
        nq = len(query_emb)
        return {
            "recall": {r: recall[r] / nq for r in self.radius},
            "one_percent_recall": {r: one_percent_recall[r] / nq for r in self.radius},
            "top1_ndx": top1_ndx,
        }


class GLEvaluator(Evaluator):
    """Global + local (6DoF) evaluator."""

    def __init__(self, *args, n_k=(128, 256), repeat_dist_th: float = 0.5,
                 icp_refine: bool = False, icp_point2plane: bool = False,
                 n_hypotheses: int = 1024, rte_th: float = 2.0, rre_th: float = 5.0,
                 ignore_keypoint_saliency: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_k = list(n_k)
        self.repeat_dist_th = repeat_dist_th
        self.icp_refine = icp_refine
        self.icp_point2plane = icp_point2plane
        self.n_hypotheses = n_hypotheses
        self.rte_th = rte_th
        self.rre_th = rre_th
        # the ablation: n_k random valid keypoints instead of the lowest sigma
        self.ignore_keypoint_saliency = ignore_keypoint_saliency
        self._traced = False

    def _gt_relative_pose(self, query_pose, map_pose):
        t = self.dataset_type.lower()
        if t == "mulran":
            return mulran_relative_pose(query_pose, map_pose)
        if t in ("synthetic", "southbay", "apollo-southbay"):
            return relative_pose(query_pose, map_pose)
        if t == "kitti":
            return kitti_relative_pose(query_pose, map_pose)
        raise NotImplementedError(t)

    def evaluate(self) -> tuple:
        # the first evaluation only is traced (periodic evaluations would
        # fill the trace directory)
        enabled, self._traced = not self._traced, True
        with tracing.capture("gl_eval", enabled=enabled):
            n_k_max = max(self.n_k)
            with tracing.span("egonn.eval_embed"):
                map_e = self.compute_embeddings(self.eval_set.map_set, with_local=True,
                                                n_k=n_k_max)
                query_e = self.compute_embeddings(self.eval_set.query_set, with_local=True,
                                                  n_k=n_k_max)
            global_metrics = self.compute_recall(map_e["global"], query_e["global"])
            global_metrics["band_ok"] = self.band_ok
            global_metrics["capacity_ok"] = self.capacity_ok
            top1 = global_metrics["top1_ndx"]
            map_pos = self.eval_set.get_map_positions()
            query_pos = self.eval_set.get_query_positions()
            # pairs for the local evaluation: ground truth <= 20 m from the top-1
            eligible = [i for i in range(len(self.eval_set.query_set))
                        if np.linalg.norm(query_pos[i] - map_pos[top1[i]]) <= 20.0]
            with tracing.span("egonn.eval_ransac"):
                metrics = {n_k: self._eval_local(eligible, top1, query_e, map_e, n_k)
                           for n_k in self.n_k}
        return global_metrics, metrics

    def _ransac(self, kp1, d1, m1, kp2, d2, m2):
        """`ransac_6dof` over every pair, in chunks of pairs whose (P, H, K)
        residual block fits RANSAC_BLOCK_BYTES; draws from a CPU generator
        seeded 0.  Returns numpy (transform, n_inliers, n_matches)."""
        gen = torch.Generator().manual_seed(0)
        per_pair = self.n_hypotheses * kp1.shape[1] * 4
        step = max(1, RANSAC_BLOCK_BYTES // per_pair)
        outs = []
        for s in range(0, len(kp1), step):
            res = ransac_6dof(kp1[s : s + step], d1[s : s + step], m1[s : s + step],
                              kp2[s : s + step], d2[s : s + step], m2[s : s + step],
                              n_hypotheses=self.n_hypotheses, gen=gen)
            outs.append((res.transform, res.n_inliers, res.n_matches))
        return tuple(torch.cat(x).cpu().numpy() for x in zip(*outs))

    def _eval_local(self, eligible, top1, query_e, map_e, n_k) -> Dict:
        if not eligible:
            return {"n_pairs": 0}
        qi = np.asarray(eligible)
        mi = top1[qi]
        kp1 = query_e["keypoints"][qi][:, :n_k]
        m1 = query_e["kp_valid"][qi][:, :n_k]
        kp2 = map_e["keypoints"][mi][:, :n_k]
        m2 = map_e["kp_valid"][mi][:, :n_k]
        device = self.built.device
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in
                (kp1, query_e["descriptors"][qi][:, :n_k], m1, kp2,
                 map_e["descriptors"][mi][:, :n_k], m2)]
        # a warm-up call, so that t_ransac is the steady-state time
        self._ransac(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        transform, n_inliers, n_matches = self._ransac(*args)  # ends in a copy to the host
        t_ransac = (time.perf_counter() - t0) / len(qi)

        # metrics against the ground truth and, with icp_refine, also against
        # the ICP-refined ground truth (repeatability against both always)
        def pose_errors(t_est, t_ref):
            rte_j = float(np.linalg.norm(t_est[:3, 3] - t_ref[:3, 3]))
            rre_j = float(rotation_error_deg(
                torch.as_tensor(t_est[:3, :3], dtype=torch.float32),
                torch.as_tensor(t_ref[:3, :3], dtype=torch.float32)))
            return rte_j, rre_j

        def repeatability(j, t_ref):
            kp1t = kp1[j] @ t_ref[:3, :3].T + t_ref[:3, 3]
            dmat = np.linalg.norm(kp1t[:, None] - kp2[j][None], axis=-1)
            dmat[~m1[j]] = np.inf
            dmat[:, ~m2[j]] = np.inf
            return (float(np.mean(dmat.min(axis=1)[m1[j]] <= self.repeat_dist_th))
                    if m1[j].any() else 0.0)

        rte, rre, success, repeat = [], [], [], []
        rte_r, rre_r, success_r, repeat_r = [], [], [], []
        for j, (q, m) in enumerate(zip(qi, mi)):
            t_gt = self._gt_relative_pose(self.eval_set.query_set[q].pose,
                                          self.eval_set.map_set[m].pose)
            t_refined = self._icp_refine_gt(q, m, t_gt) if self.icp_refine else t_gt
            rte_j, rre_j = pose_errors(transform[j], t_gt)
            rte.append(rte_j)
            rre.append(rre_j)
            success.append(rte_j <= self.rte_th and rre_j <= self.rre_th)
            repeat.append(repeatability(j, t_gt))
            repeat_r.append(repeatability(j, t_refined))
            if self.icp_refine:
                rte_j, rre_j = pose_errors(transform[j], t_refined)
                rte_r.append(rte_j)
                rre_r.append(rre_j)
                success_r.append(rte_j <= self.rte_th and rre_j <= self.rre_th)

        def summary(rte, rre, success, suffix=""):
            success, rte, rre = np.asarray(success), np.asarray(rte), np.asarray(rre)
            return {
                f"success_rate{suffix}": float(np.mean(success)),
                f"rte{suffix}": float(np.mean(rte[success])) if success.any() else float("nan"),
                f"rre{suffix}": float(np.mean(rre[success])) if success.any() else float("nan"),
                f"rte_all{suffix}": float(np.mean(rte)),
                f"rre_all{suffix}": float(np.mean(rre)),
            }

        out = {
            "n_pairs": len(qi),
            **summary(rte, rre, success),
            "repeatability": float(np.mean(repeat)),
            "repeatability_refined": float(np.mean(repeat_r)),
            "t_ransac": t_ransac,
            "mean_inliers": float(np.mean(n_inliers)),
            "mean_matches": float(np.mean(n_matches)),
        }
        if self.icp_refine:
            out.update(summary(rte_r, rre_r, success_r, suffix="_refined"))
        return out

    def _icp_refine_gt(self, q, m, t_gt):
        from egonn_tpu_torch.ops.icp import icp

        pc1 = self.pc_loader(os.path.join(self.dataset_root,
                                          self.eval_set.query_set[q].rel_scan_filepath))
        pc2 = self.pc_loader(os.path.join(self.dataset_root,
                                          self.eval_set.map_set[m].rel_scan_filepath))
        return icp(pc1, pc2, t_gt, point2plane=self.icp_point2plane)

    def print_results(self, global_metrics, local_metrics):
        for r, rec in global_metrics["recall"].items():
            print(f"Radius: {r} [m] : ", end="")
            print(f"Recall@N: {rec[:5]} ... "
                  f"1%: {global_metrics['one_percent_recall'][r]:.3f}")
        for n_k, s in local_metrics.items():
            if s.get("n_pairs", 0) == 0:
                continue
            print(
                f"n_k={n_k}: success={s['success_rate']:.3f} "
                f"RTE={s['rte']:.3f} m RRE={s['rre']:.3f} deg "
                f"repeat={s['repeatability']:.3f} t_ransac={s['t_ransac'] * 1e3:.1f} ms"
            )
