"""Train EgoNN with the port (the counterpart of the repository's `train.py`,
with its flags):

    python -m egonn_tpu_torch.train --config config/config_egonn.txt \
        --model_config model_configs/egonn.txt [--epochs N] [--weights_path DIR] \
        [--resume DIR] [--debug] [--device cpu]

Trains on the CUDA card unless `--device cpu` is given; without a card it
stops.  The config's `[TRAIN] mesh` (N, or auto: every visible card) trains
on N data-parallel ranks (`train/trainer.py::do_train`): NCCL ranks on
the cards, gloo ranks with `--device cpu`.  `--debug` runs 2 steps per phase with autograd's anomaly detection
on (the counterpart of `jax_debug_nans`).
"""
from __future__ import annotations

import argparse

import torch

from egonn_tpu_torch.evaluate import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train EgoNN model")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to configuration file")
    parser.add_argument("--model_config", type=str, required=True,
                        help="Path to the model-specific configuration file")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--visualize", action="store_true",
                        help="Accepted for the reference CLI's sake; its trainer never "
                             "reads it")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override the number of epochs")
    parser.add_argument("--weights_path", type=str, default="weights")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint directory (weights_path/model_name) of an earlier "
                             "run: restores the model, optimizer, epoch and the expanded "
                             "batch size and continues training into that directory")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args)
    if args.debug:
        torch.autograd.set_detect_anomaly(True)

    from egonn_tpu_torch.config import TrainingParams
    from egonn_tpu_torch.train.trainer import do_train

    print(f"Training config path: {args.config}")
    print(f"Model config path: {args.model_config}")
    print(f"Debug mode: {args.debug}")
    print(f"Visualize: {args.visualize}")
    params = TrainingParams(args.config, args.model_config)
    if args.epochs is not None:
        params.epochs = args.epochs
    params.print()
    do_train(params, debug=args.debug, weights_path=args.weights_path,
             resume_from=args.resume, device=device)
