"""Evaluate the classical ScanContext baseline on an evaluation-set pickle
(the port's counterpart of the repository's `evaluate_scan_context.py`, host
numpy): `python -m egonn_tpu_torch.evaluate_scan_context --dataset_root <root>
--dataset_type <type> --eval_set <pickle>`.

CLI-parity with reference third_party/scan_context/evaluate_scan_context.py:
builds the ScanContext database from the map set, queries with optional
column-shift reranking, and reports Recall@N for the standard radii.
"""
import argparse
import os

import numpy as np

from egonn_tpu_torch.data.base import EvaluationSet, get_pointcloud_loader
from egonn_tpu_torch.eval.scan_context import ScanContextManager


def main(argv=None):
    parser = argparse.ArgumentParser(description="ScanContext baseline evaluation")
    parser.add_argument("--dataset_root", type=str, required=True)
    parser.add_argument("--dataset_type", type=str, required=True,
                        choices=["mulran", "southbay", "kitti", "synthetic"])
    parser.add_argument("--eval_set_pickle", "--eval_set", dest="eval_set_pickle",
                        type=str, required=True)
    parser.add_argument("--k", "--nn", dest="k", type=int, default=20,
                        help="Maximum number of nearest neighbours to "
                             "consider (reference flag name: --nn)")
    parser.add_argument("--n_samples", type=int, default=None,
                        help="Number of elements sampled from the query "
                             "sequence (deterministic stride sampling)")
    parser.add_argument("--radius", nargs="+", type=float, default=[5, 20])
    parser.add_argument("--num_sector", type=int, default=60)
    parser.add_argument("--num_ring", type=int, default=20)
    parser.add_argument("--max_length", type=float, default=80)
    parser.add_argument("--no_reranking", action="store_true")
    parser.add_argument("--debug", action="store_true")
    args = parser.parse_args(argv)

    es = EvaluationSet()
    es.load(os.path.join(args.dataset_root, args.eval_set_pickle))
    if args.debug:
        es.map_set = es.map_set[:10]
        es.query_set = es.query_set[:10]
    if args.n_samples is not None and len(es.query_set) > args.n_samples:
        # deterministic stride sampling (the reference random.samples —
        # third_party/scan_context/evaluate_scan_context.py:59)
        step = len(es.query_set) / args.n_samples
        es.query_set = [es.query_set[int(i * step)] for i in range(args.n_samples)]
    loader = get_pointcloud_loader(args.dataset_type)

    mgr = ScanContextManager(num_sector=args.num_sector, num_ring=args.num_ring,
                             max_length=args.max_length)
    for e in es.map_set:
        mgr.add_node(loader(os.path.join(args.dataset_root, e.rel_scan_filepath)))
    print(f"Database built: {len(es.map_set)} scans")

    map_pos = es.get_map_positions()
    k = min(args.k, len(es.map_set))
    recall = {r: np.zeros(k) for r in args.radius}
    for e in es.query_set:
        pc = loader(os.path.join(args.dataset_root, e.rel_scan_filepath))
        nn_ndx, _, _ = mgr.query(pc, k=k, reranking=not args.no_reranking)
        geo = np.linalg.norm(map_pos[nn_ndx] - e.position[None], axis=1)
        for r in args.radius:
            hits = geo <= r
            if hits.any():
                recall[r][int(np.argmax(hits)):] += 1
    nq = len(es.query_set)
    for r in args.radius:
        rec = recall[r] / nq
        print(f"Radius {r} m: Recall@1 {rec[0]:.4f}  Recall@5 {rec[min(4, k - 1)]:.4f}  "
              f"Recall@{k} {rec[-1]:.4f}")


if __name__ == "__main__":
    main()
