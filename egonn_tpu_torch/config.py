"""INI configuration (port of `egonn_tpu/config.py`, whose module imports the
JAX quantizers): `ModelParams` and `TrainingParams` parse the same files
with the same defaults and quirks, and build the port's quantizers.

Quirks kept from the reference (misc/utils.py): `trans_max` falls back to
the `rot_max` key; the scheduler defaults to MultiStepLR; `l_gammas` becomes
`loss_gammas`; a `mink_quantization_size` key means cartesian coordinates.
The optional [TPU] section carries the point budget and the level-0
capacity.
"""
from __future__ import annotations

import configparser
import os
import time
from typing import List, Optional

import numpy as np

from egonn_tpu_torch.ops.quantization import CartesianQuantizer, PolarQuantizer


def get_datetime() -> str:
    return time.strftime("%Y%m%d_%H%M")


class ModelParams:
    def __init__(self, model_params_path: str):
        config = configparser.ConfigParser()
        config.read(model_params_path)
        params = config["MODEL"]

        self.model_params_path = model_params_path
        self.model = params.get("model")
        self.output_dim = params.getint("output_dim", 256)

        self.coordinates = params.get("coordinates", "polar")
        if self.coordinates not in ("polar", "cartesian"):
            raise ValueError(f"Unsupported coordinates: {self.coordinates}")

        if "quantization_step" not in params and "mink_quantization_size" in params:
            # the reference's minkloc3d_mulran.txt: cartesian semantics
            self.coordinates = "cartesian"
            self.quantization_step = params.getfloat("mink_quantization_size")
            self.quantizer = CartesianQuantizer(quant_step=self.quantization_step)
        elif "polar" in self.coordinates:
            self.quantization_step = [float(e) for e in params["quantization_step"].split(",")]
            if len(self.quantization_step) != 3:
                raise ValueError("polar quantization_step needs 3 values")
            self.quantizer = PolarQuantizer(quant_step=self.quantization_step)
        else:
            self.quantization_step = params.getfloat("quantization_step")
            self.quantizer = CartesianQuantizer(quant_step=self.quantization_step)

        if "MinkLoc" in (self.model or "") or "MinkFPN" in (self.model or ""):
            self.feature_size = params.getint("feature_size", 256)
            if "planes" in params:
                self.planes = [int(e) for e in params["planes"].split(",")]
            else:
                self.planes = [32, 64, 64]
            if "layers" in params:
                self.layers = [int(e) for e in params["layers"].split(",")]
            else:
                self.layers = [1, 1, 1]
            self.num_top_down = params.getint("num_top_down", 1)
            self.conv0_kernel_size = params.getint("conv0_kernel_size", 5)
            self.block = params.get("block", "BasicBlock")
            self.pooling = params.get("pooling", "GeM")

        tpu = config["TPU"] if config.has_section("TPU") else {}
        self.num_points = int(tpu.get("num_points", 65536))  # padded raw points per cloud
        self.num_points_explicit = "num_points" in tpu
        self.cap0 = int(tpu.get("cap0", 16384))              # level-0 voxel capacity

    def print(self):
        print("Model parameters:")
        for e, v in vars(self).items():
            print(f"{e}: {v}")
        print("")


class TrainingParams:
    """Training parameters (reference misc/utils.py:80-188)."""

    def __init__(self, params_path: str, model_params_path: str,
                 require_dataset: bool = True):
        if not os.path.exists(params_path):
            raise FileNotFoundError(f"Cannot find configuration file: {params_path}")
        if not os.path.exists(model_params_path):
            raise FileNotFoundError(
                f"Cannot find model-specific configuration file: {model_params_path}")
        self.params_path = params_path
        self.model_params_path = model_params_path

        config = configparser.ConfigParser()
        config.read(self.params_path)
        params = config["DEFAULT"]
        self.dataset = params.get("dataset", "mulran").lower()
        self.dataset_folder = params.get("dataset_folder")
        self.secondary_dataset = params.get("secondary_dataset", None)
        if self.secondary_dataset is not None:
            self.secondary_dataset = self.secondary_dataset.lower()
        self.secondary_dataset_folder = params.get("secondary_dataset_folder", None)

        # reference quirk: trans_max reads the rot_max key (misc/utils.py:110)
        self.rot_max = params.getfloat("rot_max", np.pi)
        self.trans_max = params.getfloat("trans_max", params.getfloat("rot_max", 5.0))

        params = config["TRAIN"]
        self.save_freq = params.getint("save_freq", 20)
        self.num_workers = params.getint("num_workers", 4)
        self.batch_size = params.getint("batch_size", 64)
        self.local_batch_size = params.getint("local_batch_size", 2)

        self.batch_expansion_th = params.getfloat("batch_expansion_th", None)
        if self.batch_expansion_th is not None:
            if not 0.0 < self.batch_expansion_th < 1.0:
                raise ValueError("batch_expansion_th must lie in (0, 1)")
            self.batch_size_limit = params.getint("batch_size_limit", 256)
            self.batch_expansion_rate = params.getfloat("batch_expansion_rate", 1.5)
            if not self.batch_expansion_rate > 1.0:
                raise ValueError("batch_expansion_rate must exceed 1")
        else:
            self.batch_size_limit = self.batch_size
            self.batch_expansion_rate = None

        if "secondary_batch_size_limit" in params:
            self.secondary_batch_size_limit = params.getint("secondary_batch_size_limit")
        else:
            self.secondary_batch_size_limit = self.batch_size_limit

        self.loss_gammas: Optional[List[float]] = None
        g = params.get("l_gammas", None)
        if g is not None:
            self.loss_gammas = [float(e) for e in g.split(",")]
        self.lr = params.getfloat("lr", 1e-3)

        self.scheduler = params.get("scheduler", "MultiStepLR")
        if self.scheduler is not None:
            if self.scheduler == "CosineAnnealingLR":
                self.min_lr = params.getfloat("min_lr")
            elif self.scheduler == "MultiStepLR":
                milestones = params.get("scheduler_milestones")
                self.scheduler_milestones = [int(e) for e in milestones.split(",")]
            else:
                raise NotImplementedError(f"Unsupported LR scheduler: {self.scheduler}")

        self.epochs = params.getint("epochs", 20)
        self.weight_decay = params.getfloat("weight_decay", None)
        self.loss = params.get("loss")

        if "Contrastive" in self.loss:
            self.pos_margin = params.getfloat("pos_margin", 0.2)
            self.neg_margin = params.getfloat("neg_margin", 0.65)
        elif "Triplet" in self.loss:
            self.margin = params.getfloat("margin", 0.4)
        else:
            raise NotImplementedError(f"Unsupported loss function: {self.loss}")

        self.aug_mode = params.getint("aug_mode", 1)
        # data-parallel ranks of do_train (parallel/mesh.py::resolve_mesh)
        self.mesh = params.get("mesh", "auto")

        self.train_file = params.get("train_file")
        self.val_file = params.get("val_file", None)
        self.secondary_train_file = params.get("secondary_train_file", None)
        self.test_file = params.get("test_file", None)

        self.model_params = ModelParams(self.model_params_path)

        if require_dataset and not os.path.exists(self.dataset_folder):
            raise FileNotFoundError(f"Cannot access dataset: {self.dataset_folder}")

    def print(self):
        print("Parameters:")
        for e, v in vars(self).items():
            if e != "model_params":
                print(f"{e}: {v}")
        self.model_params.print()
        print("")
