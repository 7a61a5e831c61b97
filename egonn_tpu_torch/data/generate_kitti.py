"""Offline KITTI evaluation-set generation (port of
`egonn_tpu/data/generate_kitti.py`, host numpy;
`python -m egonn_tpu_torch.data.generate_kitti --dataset_root <root>`).

Parity with reference datasets/kitti/generate_evaluation_sets.py (jac99/Egonn):
sequence 00 only; map = scans within the first 170 s, queries = the rest;
position from the cam0-frame pose columns [0, 2] of the translation; 0.1 m
min displacement; 5 m query filter.
"""
from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from egonn_tpu_torch.data.base import EvaluationSet, EvaluationTuple
from egonn_tpu_torch.data.generate_mulran import filter_query_elements
from egonn_tpu_torch.data.kitti import KittiSequence

MAP_TIMERANGE = (0, 170)


def get_scans(sequence: KittiSequence, min_displacement: float = 0.1,
              ts_range: tuple | None = None) -> List[EvaluationTuple]:
    elems = []
    old_pos = None
    count_skipped = 0
    for ndx in range(len(sequence)):
        ts = sequence.rel_lidar_timestamps[ndx]
        if ts_range is not None and not (ts_range[0] <= ts <= ts_range[1]):
            continue
        pose = sequence.lidar_poses[ndx]
        position = pose[[0, 2], 3]  # camera coords: y is up
        if old_pos is not None and np.linalg.norm(old_pos - position) < min_displacement:
            count_skipped += 1
            continue
        elems.append(EvaluationTuple(ts, sequence.rel_scan_filepath[ndx],
                                     position.astype(np.float32), pose))
        old_pos = position
    print(f"{count_skipped} clouds skipped (displacement < {min_displacement})")
    return elems


def generate_evaluation_set(dataset_root: str, map_sequence: str = "00",
                            min_displacement: float = 0.1,
                            dist_threshold: float = 5.0) -> EvaluationSet:
    sequence = KittiSequence(dataset_root, map_sequence)
    map_set = get_scans(sequence, min_displacement, MAP_TIMERANGE)
    query_set = get_scans(sequence, min_displacement,
                          (MAP_TIMERANGE[-1], sequence.rel_lidar_timestamps[-1]))
    query_set = filter_query_elements(query_set, map_set, dist_threshold)
    print(f"{len(map_set)} database elements, {len(query_set)} query elements")
    return EvaluationSet(query_set, map_set)


def main():
    parser = argparse.ArgumentParser(description="Generate KITTI evaluation sets")
    parser.add_argument("--dataset_root", type=str, required=True)
    parser.add_argument("--sequence", type=str, default="00")
    parser.add_argument("--min_displacement", type=float, default=0.1)
    parser.add_argument("--dist_threshold", type=float, default=5.0)
    args = parser.parse_args()
    es = generate_evaluation_set(args.dataset_root, args.sequence,
                                 args.min_displacement, args.dist_threshold)
    es.save(os.path.join(args.dataset_root, f"kitti_{args.sequence}_eval.pickle"))


if __name__ == "__main__":
    main()
