"""Apollo-SouthBay dataset access (port of `egonn_tpu/data/southbay.py`, host
numpy): recursive MapData / TestData / TrainData indexing with per-traversal
`pcds` + `poses/gt_poses.txt` discovery, quaternion poses (w, x, y, z from the
qr, qx, qy, qz columns), and the PCD loader (NaN points set to 0, and so
dropped as zero points; ground plane at -1.6 m).
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from egonn_tpu_torch.data.base import PointCloudLoader
from egonn_tpu_torch.data.pcd import read_pcd_xyz
from egonn_tpu_torch.ops.geometry import q2r


class GroundTruthPoses:
    """poses/gt_poses.txt reader (reference :13-38): rows of
    `ndx ts x y z qx qy qz qr`."""

    def __init__(self, pose_filepath: str):
        assert os.path.isfile(pose_filepath), f"Cannot access pose file: {pose_filepath}"
        self.pose_filepath = pose_filepath
        self.pose_ndx: Dict[int, tuple] = {}
        self.read_poses()

    def read_poses(self):
        with open(self.pose_filepath) as h:
            for ndx_row, row in enumerate(csv.reader(h, delimiter=" ")):
                assert len(row) == 9, f"Incorrect format of row {ndx_row}: {row}"
                ndx = int(row[0])
                ts = float(row[1])
                x, y, z = (float(row[i]) for i in (2, 3, 4))
                qx, qy, qz, qr = (float(row[i]) for i in (5, 6, 7, 8))
                se3 = np.eye(4, dtype=np.float64)
                se3[0:3, 0:3] = q2r((qr, qx, qy, qz))
                se3[0:3, 3] = np.array([x, y, z])
                self.pose_ndx[ndx] = (se3, ts)


class PointCloud:
    """Indexed scan with a globally unique id (reference :41-53)."""

    id: int = 0

    def __init__(self, rel_scan_filepath: str, pose: np.ndarray, timestamp: float):
        self.rel_scan_filepath = rel_scan_filepath
        self.pose = pose
        self.timestamp = timestamp
        filename = os.path.split(rel_scan_filepath)[1]
        self.rel_id = int(os.path.splitext(filename)[0])
        self.id = PointCloud.id
        PointCloud.id += 1


class SouthBayDataset:
    """Recursive indexer over MapData/TestData/TrainData (reference :56-184)."""

    def __init__(self, dataset_root: str):
        assert os.path.isdir(dataset_root), f"Cannot access directory: {dataset_root}"
        self.dataset_root = dataset_root
        self.splits = ["MapData", "TestData", "TrainData"]
        self.pcd_extension = ".pcd"
        self.location_ndx: Dict[str, Dict[str, List[int]]] = {}
        self.global_ndx: Dict[int, PointCloud] = {}
        for split in self.splits:
            self.location_ndx[split] = {}
            self._index_split(split)

    def _index_split(self, split: str):
        path = os.path.join(self.dataset_root, split)
        assert os.path.isdir(path), f"Missing split: {split}"
        locations = sorted(
            f for f in os.listdir(path) if os.path.isdir(os.path.join(path, f))
        )
        for loc in locations:
            self.location_ndx[split][loc] = []
            self._index_location(split, loc, os.path.join(split, loc))

    def _index_location(self, split: str, loc: str, rel_working_path: str):
        working_path = os.path.join(self.dataset_root, rel_working_path)
        subfolders = os.listdir(working_path)
        if "pcds" in subfolders and "poses" in subfolders:
            rel_pcds_path = os.path.join(rel_working_path, "pcds")
            poses_filepath = os.path.join(working_path, "poses", "gt_poses.txt")
            assert os.path.isfile(poses_filepath), f"Missing poses file: {poses_filepath}"
            tp = GroundTruthPoses(poses_filepath)
            for e in tp.pose_ndx:
                se3, ts = tp.pose_ndx[e]
                rel_pcd_filepath = os.path.join(rel_pcds_path, str(e) + self.pcd_extension)
                if not os.path.exists(os.path.join(self.dataset_root, rel_pcd_filepath)):
                    print(f"Missing pcd file: {rel_pcd_filepath}")
                pc = PointCloud(rel_pcd_filepath, se3, ts)
                self.global_ndx[pc.id] = pc
                self.location_ndx[split][loc].append(pc.id)
        elif "pcds" in subfolders or "poses" in subfolders:
            raise AssertionError("Either pcds or poses folder is missing")

        for sub in subfolders:
            rel_sub = os.path.join(rel_working_path, sub)
            if os.path.isdir(os.path.join(self.dataset_root, rel_sub)):
                self._index_location(split, loc, rel_sub)

    def get_poses(self, split: str, location: str | None = None):
        locations = [location] if location is not None else list(self.location_ndx[split])
        ids = [
            pc_id for loc in locations for pc_id in self.location_ndx[split][loc]
        ]
        pc_ids = np.array(ids, dtype=np.int64)
        pc_poses = np.stack(
            [self.global_ndx[i].pose for i in ids]
        ) if ids else np.zeros((0, 4, 4))
        return pc_ids, pc_poses

    def print_info(self):
        print(f"Dataset root: {self.dataset_root}")
        for split in self.location_ndx:
            for loc, pcs in self.location_ndx[split].items():
                print(f"{len(pcs)} point clouds in location {split} - {loc}")


class SouthbayPointCloudLoader(PointCloudLoader):
    def set_properties(self):
        self.ground_plane_level = -1.6

    def read_pc(self, file_pathname: str) -> np.ndarray:
        pc = read_pcd_xyz(file_pathname).astype(np.float64)
        pc[np.isnan(pc).any(axis=1)] = 0.0
        return pc
