"""INI configuration (port of `egonn_tpu/config.py`, whose module imports the
JAX quantizers): `ModelParams` and `TrainingParams` parse the same files
with the same defaults and quirks, and build the port's quantizers.

Quirks kept from the reference (misc/utils.py): `trans_max` falls back to
the `rot_max` key; the scheduler defaults to MultiStepLR; `l_gammas` becomes
`loss_gammas`; a `mink_quantization_size` key means cartesian coordinates.
The optional [TPU] section carries the point budget and the level-0
capacity, and for MinkLoc and MinkUNet optionally a per-level capacity
table (`capacities`, one entry per level 0..len(planes), MinkUNet's 0..4),
which replaces the cap0 >> l rule.

MinkUNet (`MinkUNet34C`, `models/minkunet.py`) reads `in_channels` (the
per-point features: 4 for x, y, z, intensity), `num_classes`, and the key
pack `pack_bits` with `pack_offsets` (x, y, z; `sparse/packing.py::PackSpec`,
default `DEFAULT_PACK`), which the quantizer and the pyramid both use.

MinkLoc3Dv2's training keys (Komorowski, ICPR 2022): `batch_split_size`
(multistaged backpropagation in chunks of that many clouds,
`train/trainer.py::StagedTrainStep`), `set_aug_mode` (the batch's
TrainSetTransform: the port's follows aug_mode, so only that value is
taken), and with `loss = TruncatedSmoothAP`
`tau1`, `positives_per_query` and `similarity` (cosine | euclidean).  The
augmentation's amplitudes follow `dataset` (`data/augmentation.py::amplitudes`:
Oxford's submaps are normalized).  The JAX package knows
none of these keys: each becomes an attribute only when the file gives it
(read with getattr and a default), so a file without them parses to the
JAX package's fields.
"""
from __future__ import annotations

import configparser
import os
import time
from typing import List, Optional

import numpy as np

from egonn_tpu_torch.ops.quantization import CartesianQuantizer, PolarQuantizer
from egonn_tpu_torch.sparse.packing import DEFAULT_PACK, PackSpec


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
            if params.getboolean("normalize_embeddings", False):
                raise NotImplementedError("normalize_embeddings = True is not ported")
        if "MinkUNet" in (self.model or ""):
            self.in_channels = params.getint("in_channels", 4)
            self.num_classes = params.getint("num_classes", 19)
            self.pack = DEFAULT_PACK
            if "pack_bits" in params:
                self.pack = PackSpec(tuple(int(e) for e in params["pack_bits"].split(",")),
                                     tuple(int(e) for e in params["pack_offsets"].split(",")))

        tpu = config["TPU"] if config.has_section("TPU") else {}
        self.num_points = int(tpu.get("num_points", 65536))  # padded raw points per cloud
        self.num_points_explicit = "num_points" in tpu
        self.cap0 = int(tpu.get("cap0", 16384))              # level-0 voxel capacity
        if "capacities" in tpu:
            if hasattr(self, "planes"):
                n_levels = len(self.planes)
            elif hasattr(self, "num_classes"):
                n_levels = 4  # MinkUNet's
            else:
                raise ValueError("a capacity table is read for MinkLoc and MinkUNet models only")
            self.capacities = [int(e) for e in tpu["capacities"].split(",")]
            if len(self.capacities) != n_levels + 1 or min(self.capacities) <= 0:
                raise ValueError(f"capacities needs {n_levels + 1} positive entries "
                                 f"(levels 0..{n_levels})")

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
        if "batch_split_size" in params:
            self.batch_split_size = params.getint("batch_split_size")
            if self.batch_split_size <= 0:
                raise ValueError("batch_split_size must be positive")

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
        elif self.loss == "TruncatedSmoothAP":
            self.tau1 = params.getfloat("tau1", 0.01)
            self.positives_per_query = params.getint("positives_per_query", 4)
            self.similarity = params.get("similarity", "euclidean")
            if self.similarity not in ("cosine", "euclidean"):
                raise NotImplementedError(f"Unsupported similarity: {self.similarity}")
            if not self.tau1 > 0.0 or self.positives_per_query <= 0:
                raise ValueError("tau1 and positives_per_query must be positive")
        else:
            raise NotImplementedError(f"Unsupported loss function: {self.loss}")

        self.aug_mode = params.getint("aug_mode", 1)
        if params.getint("set_aug_mode", self.aug_mode) != self.aug_mode:
            raise NotImplementedError("a set_aug_mode other than aug_mode is not ported")
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
