"""Dataset schemas and the point-cloud loader base (port of
`egonn_tpu/data/base.py`).

An evaluation-set pickle holds plain tuples `[query_list, map_list]` of
`(timestamp, rel_scan_filepath, position, pose)`, so the port reads the
pickles written by the JAX package and by the reference without importing
either.  A training-tuple pickle holds `TrainingTuple` objects, pickled
under their class's module path: the port writes its own, and
`load_training_tuples` maps the JAX package's and the reference's class
paths to it, so that reading their pickles imports neither.
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional

import numpy as np


class TrainingTuple:
    """One training element: ids of its positives (sorted, <= 2 m in the
    reference) and non-negatives (<= 10 m), its 4x4 global pose, and the
    relative poses of its positives."""

    def __init__(self, id: int, timestamp: int, rel_scan_filepath: str,
                 positives: np.ndarray, non_negatives: np.ndarray, pose: np.ndarray,
                 positives_poses: Optional[Dict[int, np.ndarray]] = None):
        self.id = id
        self.timestamp = timestamp
        self.rel_scan_filepath = rel_scan_filepath
        self.positives = positives
        self.non_negatives = non_negatives
        self.pose = pose
        self.positives_poses = positives_poses


# the class paths a training-tuple pickle may name, all read as the port's
# TrainingTuple: the JAX package's and the reference's
# (datasets/base_datasets.py)
TUPLE_CLASS_PATHS = (("egonn_tpu.data.base", "TrainingTuple"),
                     ("datasets.base_datasets", "TrainingTuple"))


class _TupleUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in TUPLE_CLASS_PATHS:
            return TrainingTuple
        if module.split(".")[0] == "egonn_tpu":
            raise pickle.UnpicklingError(f"{module}.{name}: not a training tuple")
        return super().find_class(module, name)


def load_training_tuples(path: str) -> Dict[int, TrainingTuple]:
    """A training-tuple pickle {id: TrainingTuple}, written by the port, the
    JAX package or the reference."""
    with open(path, "rb") as f:
        return _TupleUnpickler(f).load()


class EvaluationTuple:
    """One map or query element: (x, y) position and optional 4x4 pose."""

    def __init__(self, timestamp: int, rel_scan_filepath: str, position: np.ndarray,
                 pose: Optional[np.ndarray] = None):
        if position.shape != (2,):
            raise ValueError(f"position must be (2,), got {position.shape}")
        self.timestamp = timestamp
        self.rel_scan_filepath = rel_scan_filepath
        self.position = position
        self.pose = pose

    def to_tuple(self):
        return self.timestamp, self.rel_scan_filepath, self.position, self.pose


class EvaluationSet:
    """Query and map lists of `EvaluationTuple`s, pickled as plain tuples."""

    def __init__(self, query_set: Optional[List[EvaluationTuple]] = None,
                 map_set: Optional[List[EvaluationTuple]] = None):
        self.query_set = query_set
        self.map_set = map_set

    def load(self, pickle_filepath: str):
        with open(pickle_filepath, "rb") as f:
            query_l, map_l = pickle.load(f)
        self.query_set = [EvaluationTuple(e[0], e[1], e[2], e[3]) for e in query_l]
        self.map_set = [EvaluationTuple(e[0], e[1], e[2], e[3]) for e in map_l]

    def save(self, pickle_filepath: str):
        query_l = [e.to_tuple() for e in self.query_set]
        map_l = [e.to_tuple() for e in self.map_set]
        with open(pickle_filepath, "wb") as f:
            pickle.dump([query_l, map_l], f)

    def get_map_positions(self) -> np.ndarray:
        return np.stack([e.position for e in self.map_set])

    def get_query_positions(self) -> np.ndarray:
        return np.stack([e.position for e in self.query_set])


class TrainingDataset:
    """The scans of a training-tuple pickle: item `ndx` is (its raw (N, 3)
    float32 cloud, ndx); augmentation and quantization run on the device."""

    def __init__(self, dataset_path: str, dataset_type: str, query_filename: str):
        if not os.path.exists(dataset_path):
            raise FileNotFoundError(f"Cannot access dataset path: {dataset_path}")
        self.dataset_path = dataset_path
        self.dataset_type = dataset_type
        self.query_filepath = os.path.join(dataset_path, query_filename)
        if not os.path.exists(self.query_filepath):
            raise FileNotFoundError(f"Cannot access query file: {self.query_filepath}")
        self.queries: Dict[int, TrainingTuple] = load_training_tuples(self.query_filepath)
        self.pc_loader = get_pointcloud_loader(self.dataset_type)

    def __len__(self):
        return len(self.queries)

    def __getitem__(self, ndx):
        return self.pc_loader(os.path.join(self.dataset_path,
                                           self.queries[ndx].rel_scan_filepath)), ndx

    def get_positives(self, ndx):
        return self.queries[ndx].positives

    def get_non_negatives(self, ndx):
        return self.queries[ndx].non_negatives


def get_pointcloud_loader(dataset_type: str) -> Callable[[str], np.ndarray]:
    """The loader of a dataset type: mulran, southbay, kitti, oxford or
    synthetic."""
    t = dataset_type.lower()
    if t == "mulran":
        from egonn_tpu_torch.data.mulran import MulranPointCloudLoader

        return MulranPointCloudLoader()
    if t in ("southbay", "apollo-southbay"):
        from egonn_tpu_torch.data.southbay import SouthbayPointCloudLoader

        return SouthbayPointCloudLoader()
    if t == "kitti":
        from egonn_tpu_torch.data.kitti import KittiPointCloudLoader

        return KittiPointCloudLoader()
    if t == "oxford":
        from egonn_tpu_torch.data.oxford import OxfordPointCloudLoader

        return OxfordPointCloudLoader()
    if t == "synthetic":
        from egonn_tpu_torch.data.synthetic import SyntheticPointCloudLoader

        return SyntheticPointCloudLoader()
    raise NotImplementedError(f"Unsupported dataset type: {dataset_type}")


class PointCloudLoader:
    """Reads a raw scan and drops zero points and the ground plane (points
    at or below `ground_plane_level`); returns (N, 3) float32."""

    def __init__(self):
        self.remove_zero_points = True
        self.remove_ground_plane = True
        self.ground_plane_level: Optional[float] = None
        self.set_properties()

    def set_properties(self):
        raise NotImplementedError

    def __call__(self, file_pathname: str) -> np.ndarray:
        if not os.path.exists(file_pathname):
            raise FileNotFoundError(f"Cannot open point cloud: {file_pathname}")
        pc = self.read_pc(file_pathname)
        if pc.ndim != 2 or pc.shape[1] != 3:
            raise ValueError(f"{file_pathname}: (N, 3) points expected, got {pc.shape}")
        if self.remove_zero_points:
            pc = pc[~np.all(np.isclose(pc, 0), axis=1)]
        if self.remove_ground_plane:
            pc = pc[pc[:, 2] > self.ground_plane_level]
        return pc.astype(np.float32)

    def read_pc(self, file_pathname: str) -> np.ndarray:
        raise NotImplementedError


def in_sorted(values: np.ndarray, array: np.ndarray) -> np.ndarray:
    """Whether each value is in the sorted array (one search for all)."""
    array = np.asarray(array)
    if len(array) == 0:
        return np.zeros(len(values), dtype=bool)
    pos = np.searchsorted(array, values)
    return (pos < len(array)) & (array[np.minimum(pos, len(array) - 1)] == values)
