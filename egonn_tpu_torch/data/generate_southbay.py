"""Offline Apollo-SouthBay tuple / evaluation-set generation (port of
`egonn_tpu/data/generate_southbay.py`, host numpy;
`python -m egonn_tpu_torch.data.generate_southbay --dataset_root <root> [--eval_sets]`).

Parity with reference datasets/southbay/generate_training_tuples.py and
generate_evaluation_sets.py (jac99/Egonn):

* training tuples: anchors from TrainData+MapData, positives <= 2 m / non-negatives
  <= 10 m by 3-D pose distance, 1 m grid dedup, ids compacted to consecutive ints,
  positives_poses = None (SouthBay trains the global head only);
* evaluation set: map = MapData, query = TestData, area SunnyvaleBigloop, 1 m grid
  dedup, 5 m query filter.

Determinism note: the reference compacts ids by iterating a Python set (arbitrary
order); we sort the used ids first — same tuples, stable ids.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import List

import numpy as np

from egonn_tpu_torch.data.base import EvaluationSet, EvaluationTuple, TrainingTuple
from egonn_tpu_torch.data.generate_mulran import filter_query_elements
from egonn_tpu_torch.data.southbay import SouthBayDataset


def generate_triplets(ds: SouthBayDataset, map_split: str, query_split: str,
                      positives_th: float = 2, negatives_th: float = 10,
                      min_displacement: float = 0.1):
    assert positives_th < negatives_th
    ids, poses = [], []
    for split in (query_split, map_split):
        for loc in ds.location_ndx[split]:
            for pc_id in ds.location_ndx[split][loc]:
                ids.append(pc_id)
                poses.append(ds.global_ndx[pc_id].pose)
    pc_ids = np.array(ids, dtype=np.int64)
    pc_coords = np.stack(poses)[:, :3, 3]

    grid = np.floor(pc_coords / min_displacement).astype(int)
    _, unique_ndx = np.unique(grid, axis=0, return_index=True)
    pc_ids = pc_ids[unique_ndx]
    pc_coords = pc_coords[unique_ndx]
    print(f"{len(pc_ids)} point clouds after min_displacement={min_displacement} dedup")

    triplets = []
    count_zero_positives = 0
    for i, anchor_id in enumerate(pc_ids):
        anchor_coords = ds.global_ndx[int(anchor_id)].pose[:3, 3]
        dist = np.linalg.norm(pc_coords - anchor_coords, axis=1)
        positives = pc_ids[dist <= positives_th]
        positives = positives[positives != anchor_id]
        non_negatives = pc_ids[dist <= negatives_th]
        if len(positives) == 0:
            count_zero_positives += 1
            continue
        triplets.append((int(anchor_id), positives, non_negatives))
    print(f"{count_zero_positives} filtered out due to no positives")
    print(f"{len(triplets)} training tuples generated")

    anchors_set = set(t[0] for t in triplets)
    triplets = [
        (a, [p for p in pos if p in anchors_set], [n for n in nn if n in anchors_set])
        for a, pos, nn in triplets
    ]
    used = sorted({a for a, _, _ in triplets}
                  | {int(p) for _, pos, _ in triplets for p in pos}
                  | {int(n) for _, _, nn in triplets for n in nn})
    new_ids = {old: ndx for ndx, old in enumerate(used)}

    tuples = {}
    for a, pos, nn in triplets:
        pc = ds.global_ndx[a]
        tuples[new_ids[a]] = TrainingTuple(
            id=new_ids[a],
            timestamp=pc.timestamp,
            rel_scan_filepath=pc.rel_scan_filepath,
            positives=np.sort(np.array([new_ids[int(p)] for p in pos], np.int64)),
            non_negatives=np.sort(np.array([new_ids[int(n)] for n in nn], np.int64)),
            pose=pc.pose,
            positives_poses=None,
        )
    return tuples


def get_scans(ds: SouthBayDataset, split: str, area: str,
              min_displacement: float) -> List[EvaluationTuple]:
    elems = []
    for pc_id in ds.location_ndx[split][area]:
        pc = ds.global_ndx[pc_id]
        elems.append(EvaluationTuple(
            pc.timestamp, pc.rel_scan_filepath,
            position=pc.pose[:2, 3].astype(np.float32), pose=pc.pose))
    grid = np.floor(
        np.stack([e.pose[:3, 3] for e in elems]) / min_displacement
    ).astype(int)
    _, unique_ndx = np.unique(grid, axis=0, return_index=True)
    elems = [elems[i] for i in sorted(unique_ndx)]
    print(f"{len(elems)} filtered elements in {split} (cell {min_displacement})")
    return elems


def generate_evaluation_set(ds: SouthBayDataset, area: str,
                            min_displacement: float = 1.0,
                            dist_threshold: float = 5) -> EvaluationSet:
    map_set = get_scans(ds, "MapData", area, min_displacement)
    query_set = filter_query_elements(
        get_scans(ds, "TestData", area, min_displacement), map_set, dist_threshold)
    print(f"Area: {area} - {len(map_set)} database, {len(query_set)} queries")
    return EvaluationSet(query_set, map_set)


def main():
    parser = argparse.ArgumentParser(description="Generate SouthBay tuples / eval sets")
    parser.add_argument("--dataset_root", type=str, required=True)
    # reference flag names are --pos_th/--neg_th (southbay
    # generate_training_tuples.py); keep both spellings
    parser.add_argument("--pos_threshold", "--pos_th", dest="pos_threshold",
                        type=float, default=2)
    parser.add_argument("--neg_threshold", "--neg_th", dest="neg_threshold",
                        type=float, default=10)
    parser.add_argument("--min_displacement", type=float, default=1.0)
    parser.add_argument("--dist_threshold", type=float, default=5)
    parser.add_argument("--eval_sets", action="store_true")
    args = parser.parse_args()

    ds = SouthBayDataset(args.dataset_root)
    ds.print_info()
    if args.eval_sets:
        area = "SunnyvaleBigloop"
        es = generate_evaluation_set(ds, area, args.min_displacement, args.dist_threshold)
        name = f"test_{area}_{args.min_displacement}_{args.dist_threshold}.pickle"
        es.save(os.path.join(args.dataset_root, name))
        return
    tuples = generate_triplets(ds, "MapData", "TrainData",
                               args.pos_threshold, args.neg_threshold)
    name = f"train_southbay_{args.pos_threshold:g}_{args.neg_threshold:g}.pickle"
    with open(os.path.join(args.dataset_root, name), "wb") as f:
        pickle.dump(tuples, f)


if __name__ == "__main__":
    main()
