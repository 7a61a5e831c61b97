"""Rotation-robustness evaluation with the port (the counterpart of the
repository's `evaluate_with_rotations.py`): every query cloud rotated about
+z by 0 ... max_deg in steps of step_deg, Recall@N per rotation, the
results pickled next to the evaluation set (or to --out):

    python -m egonn_tpu_torch.evaluate_with_rotations --dataset_root <root> \
        --dataset_type mulran --eval_set <pickle> --model_config <config> \
        --weights <dir or .pth> [--step_deg 10] [--max_deg 180] [--device cpu] [--dp [N]]

`--dp` shards the embedding batches over data-parallel ranks, as in
`evaluate.py`; rank 0 prints and writes the results.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from egonn_tpu_torch.evaluate import (
    WEIGHTS_HELP,
    add_common_args,
    load_weights,
    resolve_device,
    run_sharded,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Rotation-robustness evaluation")
    add_common_args(parser)
    parser.add_argument("--weights", type=str, required=True, help=WEIGHTS_HELP)
    parser.add_argument("--step_deg", type=float, default=10.0)
    parser.add_argument("--max_deg", type=float, default=180.0)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)
    run_sharded(_evaluate, args, resolve_device(args))


def _evaluate(group, args, device) -> None:
    from egonn_tpu_torch.config import ModelParams
    from egonn_tpu_torch.eval.rotations import RotationEvaluator
    from egonn_tpu_torch.models.factory import model_factory
    from egonn_tpu_torch.parallel.mesh import rank_of

    model_params = ModelParams(args.model_config)
    built = model_factory(model_params, device=device)
    load_weights(built, args.weights, model_params.model)

    thetas = list(np.arange(0.0, args.max_deg + 1e-6, args.step_deg))
    ev = RotationEvaluator(args.dataset_root, args.dataset_type, args.eval_set_pickle, built,
                           num_points=model_params.num_points, thetas_deg=thetas,
                           radius=args.radius, n_samples=args.n_samples, debug=args.debug,
                           group=group)
    results = ev.evaluate()
    for theta, m in results.items():
        parts = "  ".join(f"r={rad}m R@1={rec[0]:.3f}" for rad, rec in m["recall"].items())
        print(f"theta={theta:5.1f} deg: {parts}")

    if rank_of(group) != 0:
        return
    out = args.out or os.path.join(
        args.dataset_root, f"rotations_{os.path.basename(args.eval_set_pickle)}")
    with open(out, "wb") as f:
        pickle.dump(results, f)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
