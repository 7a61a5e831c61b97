"""Evaluate EgoNN / MinkLoc models with the port (the counterpart of the
repository's `evaluate.py`, with its flags):

    python -m egonn_tpu_torch.evaluate --dataset_root <root> --dataset_type mulran \
        --eval_set test_Sejong01_Sejong02.pickle --model_config model_configs/egonn.txt \
        [--weights <dir or .pth>] [--radius 5 20] [--n_k 128 256] [--icp_refine] \
        [--device cpu]

Runs on the CUDA card unless `--device cpu` is given; without a card it
stops.  `--dp` (data parallel) is not ported yet (ROADMAP A.9).
"""
from __future__ import annotations

import argparse
import os

import torch

WEIGHTS_HELP = ("a port checkpoint directory (step_N.pt files of train/state.py) or a "
                "reference .pth / .pt; none: seeded random weights.  The orbax directories "
                "of the JAX package cannot be read without JAX")


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--dataset_root", type=str, required=True)
    parser.add_argument("--dataset_type", type=str, required=True,
                        choices=["mulran", "southbay", "kitti", "synthetic"])
    parser.add_argument("--eval_set_pickle", "--eval_set", dest="eval_set_pickle", type=str,
                        required=True)
    parser.add_argument("--model_config", type=str, required=True)
    parser.add_argument("--radius", nargs="+", type=float, default=[5, 20],
                        help="True positive thresholds in metres")
    parser.add_argument("--n_samples", type=int, default=None,
                        help="Number of elements sampled from the query sequence "
                             "(an even stride)")
    parser.add_argument("--dp", action="store_true",
                        help="Data-parallel evaluation: not ported yet (ROADMAP A.9)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--debug", action="store_true")


def resolve_device(args) -> torch.device:
    """The device asked for; stops on --dp (where the CLI has it) and on cuda
    without a card."""
    if getattr(args, "dp", False):
        raise SystemExit("--dp: data-parallel evaluation is not ported yet (ROADMAP A.9)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to run on the CPU")
    return device


def load_weights(built, weights, model_name: str) -> None:
    """Fill the built model from `weights` (see WEIGHTS_HELP), in place."""
    if weights and weights.endswith((".pth", ".pt")):
        from egonn_tpu_torch.utils.checkpoint_convert import load_reference_checkpoint
        from egonn_tpu_torch.utils.weights import load_flax_variables

        load_flax_variables(built.model, load_reference_checkpoint(weights, model=model_name))
        print(f"Converted reference torch checkpoint {weights} ({model_name} layout)")
    elif weights:
        from egonn_tpu_torch.train.state import load_model_weights

        if not os.path.isdir(weights) or not any(
                f.startswith("step_") and f.endswith(".pt") for f in os.listdir(weights)):
            raise SystemExit(f"{weights}: not a port checkpoint directory (step_N.pt); "
                             "orbax checkpoints of the JAX package cannot be read without JAX")
        step = load_model_weights(weights, built.model)
        print(f"Loaded checkpoint step {step} from {weights}")
    else:
        print("WARNING: evaluating a randomly initialized model (no --weights)")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate model on a dataset")
    add_common_args(parser)
    parser.add_argument("--weights", type=str, default=None, help=WEIGHTS_HELP)
    parser.add_argument("--n_k", nargs="+", type=int, default=[128])
    parser.add_argument("--icp_refine", action="store_true")
    parser.add_argument("--icp_point2plane", action="store_true",
                        help="Use point-to-plane ICP for the ground-truth refinement")
    parser.add_argument("--ransac_hypotheses", type=int, default=1024,
                        help="Parallel RANSAC hypotheses; 10240 matches the reference's "
                             "10k-iteration Open3D budget")
    parser.add_argument("--ignore_keypoint_regressor", action="store_true",
                        help="Ablation: keypoints at the supervoxel centres")
    parser.add_argument("--ignore_keypoint_saliency", action="store_true",
                        help="Ablation: n_k random keypoints instead of the lowest sigma")
    parser.add_argument("--global_only", action="store_true",
                        help="Skip the 6DoF local evaluation")
    args = parser.parse_args(argv)
    device = resolve_device(args)

    from egonn_tpu_torch.config import ModelParams
    from egonn_tpu_torch.data.pipeline import resolve_num_points
    from egonn_tpu_torch.eval.evaluator import Evaluator, GLEvaluator
    from egonn_tpu_torch.models.factory import model_factory

    model_params = ModelParams(args.model_config)
    model_params.num_points = resolve_num_points(model_params, args.dataset_type)
    model_params.num_points_explicit = True  # resolved; used as is below
    model_params.print()
    built = model_factory(model_params, device=device)
    if args.ignore_keypoint_regressor:
        built.model.ignore_keypoint_regressor = True
        print("Ignore keypoints regressor: True")
    load_weights(built, args.weights, model_params.model)

    common = dict(num_points=model_params.num_points, radius=args.radius,
                  n_samples=args.n_samples, debug=args.debug)
    if args.global_only or built.model_type != "egonn":
        ev = Evaluator(args.dataset_root, args.dataset_type, args.eval_set_pickle, built,
                       **common)
        metrics = ev.evaluate()
        for r, rec in metrics["recall"].items():
            print(f"Radius {r} m  Recall@1: {rec[0]:.4f}  "
                  f"Recall@5: {rec[min(4, len(rec) - 1)]:.4f}  "
                  f"1%: {metrics['one_percent_recall'][r]:.4f}")
    else:
        ev = GLEvaluator(args.dataset_root, args.dataset_type, args.eval_set_pickle, built,
                         n_k=args.n_k, icp_refine=args.icp_refine,
                         icp_point2plane=args.icp_point2plane,
                         n_hypotheses=args.ransac_hypotheses,
                         ignore_keypoint_saliency=args.ignore_keypoint_saliency, **common)
        global_metrics, local_metrics = ev.evaluate()
        ev.print_results(global_metrics, local_metrics)


if __name__ == "__main__":
    main()
