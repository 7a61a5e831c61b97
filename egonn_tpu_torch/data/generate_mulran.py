"""Offline MulRan tuple / evaluation-set generation (port of
`egonn_tpu/data/generate_mulran.py`, host numpy).

Parity with reference datasets/mulran/generate_training_tuples.py and
generate_evaluation_sets.py (jac99/Egonn):

* training tuples (train split: Sejong01+Sejong02 geofenced): per anchor,
  positives <= pos_threshold (default 2 m), non-negatives <= neg_threshold
  (default 10 m) by xy distance; per-positive relative pose (MulRan sign fix)
  refined with ICP on bbox-clipped clouds (+/-80 m, ground -0.9 m, reference
  :17-38); val tuples from the test split.
* evaluation set: map = Sejong01, query = Sejong02, test split, queries filtered
  to those with a map element within 20 m.

Run:  python -m egonn_tpu_torch.data.generate_mulran --dataset_root <root>
      python -m egonn_tpu_torch.data.generate_mulran --dataset_root <root> --eval_sets
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from egonn_tpu_torch.data.base import EvaluationSet, EvaluationTuple, TrainingTuple
from egonn_tpu_torch.data.mulran import MulranSequence, MulranSequences, relative_pose
from egonn_tpu_torch.ops.icp import icp_point_to_point


def load_pc_clipped(path: str) -> np.ndarray:
    """Raw scan with bbox clip +/-80 m and ground plane -0.9 m
    (reference generate_training_tuples.py:17-38)."""
    pc = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
    m = (
        (np.abs(pc[:, 0]) <= 80)
        & (np.abs(pc[:, 1]) <= 80)
        & (pc[:, 2] > -0.9)
        & ~np.all(np.isclose(pc, 0), axis=1)
    )
    return pc[m]


def generate_training_tuples(ds: MulranSequences, pos_threshold: float = 2,
                             neg_threshold: float = 10, icp_refine: bool = True):
    tuples = {}
    xy = ds.get_xy()
    for anchor_ndx in range(len(ds)):
        anchor_pos = xy[anchor_ndx]
        positives = ds.find_neighbours_ndx(anchor_pos, pos_threshold)
        non_negatives = ds.find_neighbours_ndx(anchor_pos, neg_threshold)
        positives = np.sort(positives[positives != anchor_ndx])
        non_negatives = np.sort(non_negatives)

        anchor_pose = ds.poses[anchor_ndx]
        positive_poses = {}
        anchor_pc = None
        for positive_ndx in positives:
            transform = relative_pose(anchor_pose, ds.poses[positive_ndx])
            if icp_refine:
                if anchor_pc is None:
                    anchor_pc = load_pc_clipped(
                        os.path.join(ds.dataset_root, ds.rel_scan_filepath[anchor_ndx]))
                positive_pc = load_pc_clipped(
                    os.path.join(ds.dataset_root, ds.rel_scan_filepath[positive_ndx]))
                transform = icp_point_to_point(anchor_pc, positive_pc, transform)
            positive_poses[int(positive_ndx)] = transform

        tuples[anchor_ndx] = TrainingTuple(
            id=anchor_ndx,
            timestamp=int(ds.timestamps[anchor_ndx]),
            rel_scan_filepath=ds.rel_scan_filepath[anchor_ndx],
            positives=positives.astype(np.int64),
            non_negatives=non_negatives.astype(np.int64),
            pose=anchor_pose,
            positives_poses=positive_poses,
        )
    print(f"{len(tuples)} training tuples generated")
    return tuples


def filter_query_elements(query_set, map_set, dist_threshold: float):
    """Reference datasets/dataset_utils.py:210-232."""
    map_pos = np.stack([e.position for e in map_set])
    out = []
    ignored = 0
    for e in query_set:
        if (np.linalg.norm(map_pos - e.position[None], axis=1) <= dist_threshold).any():
            out.append(e)
        else:
            ignored += 1
    print(f"{ignored} query elements ignored - no map element within {dist_threshold} m")
    return out


def generate_evaluation_set(dataset_root: str, map_sequence: str, query_sequence: str,
                            min_displacement: float = 0.2, dist_threshold: float = 20
                            ) -> EvaluationSet:
    split = "test"
    map_seq = MulranSequence(dataset_root, map_sequence, split, min_displacement)
    query_seq = MulranSequence(dataset_root, query_sequence, split, min_displacement)

    def scans(seq):
        return [
            EvaluationTuple(int(seq.timestamps[i]), seq.rel_scan_filepath[i],
                            position=seq.poses[i][:2, 3].astype(np.float32),
                            pose=seq.poses[i])
            for i in range(len(seq))
        ]

    map_set = scans(map_seq)
    query_set = filter_query_elements(scans(query_seq), map_set, dist_threshold)
    print(f"{len(map_set)} database elements, {len(query_set)} query elements")
    return EvaluationSet(query_set, map_set)


def main():
    parser = argparse.ArgumentParser(description="Generate MulRan tuples / eval sets")
    parser.add_argument("--dataset_root", type=str, required=True)
    parser.add_argument("--pos_threshold", type=float, default=2)
    parser.add_argument("--neg_threshold", type=float, default=10)
    parser.add_argument("--min_displacement", type=float, default=0.2)
    parser.add_argument("--dist_threshold", type=float, default=20)
    parser.add_argument("--no_icp", action="store_true")
    parser.add_argument("--eval_sets", action="store_true",
                        help="Generate evaluation sets instead of training tuples")
    args = parser.parse_args()

    if args.eval_sets:
        for map_seq, query_seq in [("Sejong01", "Sejong02")]:
            es = generate_evaluation_set(args.dataset_root, map_seq, query_seq,
                                         args.min_displacement, args.dist_threshold)
            es.save(os.path.join(args.dataset_root, f"test_{map_seq}_{query_seq}.pickle"))
        return

    sequences = ["Sejong01", "Sejong02"]
    pt, nt = args.pos_threshold, args.neg_threshold
    for split, prefix in (("train", "train"), ("test", "val")):
        ds = MulranSequences(args.dataset_root, sequences, split=split,
                             min_displacement=args.min_displacement)
        tuples = generate_training_tuples(ds, pt, nt, icp_refine=not args.no_icp)
        name = f"{prefix}_{sequences[0]}_{sequences[1]}_{pt:g}_{nt:g}.pickle"
        with open(os.path.join(args.dataset_root, name), "wb") as f:
            pickle.dump(tuples, f)


if __name__ == "__main__":
    main()
