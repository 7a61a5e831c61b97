"""Training (port of `egonn_tpu/train/trainer.py`): the EgoNN training step,
MinkLoc3Dv2's staged step, and `do_train`, the epoch loop around them.

One step processes one global batch (batch-hard triplet loss on the global
descriptors) and one local batch of cloud pairs (keypoint + correspondence
losses) and makes one optimizer update for the summed loss, as the
reference does (training/trainer.py:160-193).  Three train-mode forwards run
in order, global (augmented), anchor, positive, so the BatchNorm running
statistics advance through all three as the JAX step threads them.  The
validation form runs the same forwards in eval mode under no_grad, without
augmentation, and changes nothing.

`StagedTrainStep` trains a MinkLoc model as MinkLoc3Dv2 does (Komorowski,
ICPR 2022): multistaged backpropagation of a global-only batch in chunks of
`batch_split_size` clouds around a loss over the whole batch (Truncated
Smooth AP).  `make_train_step` returns it for a MinkLoc model with
`batch_split_size` set; `do_train` then reads global batches alone.

`do_train` keeps the JAX loop's semantics: an epoch zips the sampler's
global batches with the shuffled local batches (the shorter ends it),
skips batches without positives or negatives, averages each phase's stats,
takes the LR from the epoch schedule, expands the batch when the share of
active triplets falls below `batch_expansion_th` (decided before the
checkpoint, so the saved `sampler_batch_size` is the next epoch's),
checkpoints every `save_freq` epochs and at the end, audits the voxel
capacities on each epoch's last train batch, and evaluates on `test_file`
every EVAL_EVERY epochs.  `resume_from` restores a checkpoint directory
and continues the schedule into it.

Every draw derives from (epoch, phase, step): the sampler and the local
shuffle as in the JAX package, and the global batch's augmentation from a
`torch.Generator` on the model's device seeded from (0, epoch, phase, step)
(JAX's `fold_in` chain cannot be reproduced in torch).  So a run resumed at
an epoch boundary repeats the uninterrupted one.

Data parallel (`params.mesh`, `parallel/mesh.py`): with a mesh of N > 1
`do_train` runs the calling process as rank 0 and spawns N - 1 ranks (NCCL,
one card each; gloo on the CPU, or on one card when `backend="gloo"` is
named).  Each rank reads and steps on its rows of every global and local
batch (buckets and the local batch size rounded up to multiples of N); the
miner sees the gathered embeddings, BatchNorm the global batch's
statistics, the local loss the global mean, and one all-reduce sums the
gradients, so a step computes the single-process step's function and every
rank keeps the same parameters.  Rank 0 alone prints, logs and writes
checkpoints; every rank reads a resumed checkpoint.

Not ported: the band auto-calibration, which the JAX loop runs only for its
banded engine: no port kernel keeps band windows, so there is nothing to
calibrate.
"""
from __future__ import annotations

import itertools
import os
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from egonn_tpu_torch.config import get_datetime
from egonn_tpu_torch.data.base import TrainingDataset
from egonn_tpu_torch.data.local_dataset import Training6DOFDataset, make_local_batch
from egonn_tpu_torch.data.pipeline import (
    GlobalBatch,
    Prefetcher,
    augment_global,
    device_preprocess_global,
    make_global_batch,
    resolve_num_points,
)
from egonn_tpu_torch.data.samplers import BatchSampler
from egonn_tpu_torch.losses.keypoint import make_losses
from egonn_tpu_torch.models.factory import BuiltModel, model_factory
from egonn_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_grads,
    broadcast_module,
    quiet_unless_rank0,
    rank_device,
    rank_of,
    resolve_mesh,
    row_slice,
    run_ranks,
    set_process_group,
    world_size,
)
from egonn_tpu_torch.sparse.pyramid import capacity_report
from egonn_tpu_torch.sparse.types import Pyramid
from egonn_tpu_torch.train.state import (
    TrainState,
    load_checkpoint,
    load_checkpoint_meta,
    make_lr_schedule,
    make_optimizer,
    save_checkpoint,
    set_lr,
)
from egonn_tpu_torch.utils import tracing

# the in-training evaluation's cadence in epochs (reference :258-265)
EVAL_EVERY = 10


def expansion_buckets(batch_size: int, limit: int, rate: Optional[float],
                      multiple_of: int = 1) -> List[int]:
    """The batch sizes dynamic batch expansion can produce (reference
    datasets/samplers.py:79-90), each rounded up to `multiple_of`."""
    sizes = [batch_size]
    if rate:
        b = batch_size
        while b < limit:
            b = min(int(b * rate), limit)
            sizes.append(b)
    if multiple_of > 1:
        sizes = sorted({-(-b // multiple_of) * multiple_of for b in sizes})
    return sizes


class TrainStep:
    """`step(g, l, gen, lr, train)` -> stats.

    g: {"clouds" (B, N, 3), "point_mask" (B, N), "positives_mask" (B, B),
    "negatives_mask" (B, B)}; l: {"anc_clouds", "anc_mask", "pos_clouds",
    "pos_mask" (as g's clouds), "t_gt" (B_l, 4, 4)}; all on the model's
    device.  gen: the `torch.Generator` the global batch's augmentation draws
    from (train only; None skips augmentation).  lr: this epoch's learning
    rate.  Returns the JAX step's stats as detached 0-d tensors: the global
    and local losses' stats, `global_loss`, `local_loss` and `loss` (their
    sum, what the update steps on).  `state` holds the model, the optimizer
    and the epoch (for checkpoints).

    With a data-parallel `group` the clouds, point masks, pairs and t_gt are
    this rank's rows (the (B, B) masks whole) and gen is the generator every
    rank shares; the stats are the global batch's, equal on every rank.
    The model takes rank 0's weights at construction.

    With EGONN_BF16_ACTS=1 on the card the activations and their cotangents
    are bf16 (`sparse/conv.py`); the outputs, the losses, the parameters,
    their gradients and Adam's state stay f32, as in the JAX package."""

    def __init__(self, built: BuiltModel, params, group=None):
        self.built = built
        self.aug_mode = params.aug_mode
        self.group = group
        self.gl_loss_fn, self.loc_loss_fn = make_losses(params)
        set_process_group(built.model, group)
        broadcast_module(built.model, group)
        self.state = TrainState(built.model, make_optimizer(built.model.parameters(), params))

    def _forward(self, clouds, mask, gen, train: bool):
        b = self.built
        for name, t in (("clouds", clouds), ("mask", mask)):
            if t.device != b.device:
                raise ValueError(f"{name} on {t.device}, the model on {b.device}")
        with tracing.span("egonn.step.forward"):
            pyr = device_preprocess_global(clouds, mask, b.quantizer, b.pyramid_spec, gen=gen,
                                           aug_mode=self.aug_mode, with_kmap_down=train,
                                           group=self.group)
            return b.model(pyr, b.quantizer)

    def _losses(self, g: Dict, l: Dict, gen, train: bool):
        """(this rank's share of the loss, the global stats)."""
        yg = self._forward(g["clouds"], g["point_mask"], gen, train)
        with tracing.span("egonn.step.loss"):
            # every rank mines the whole batch: its share is 1 / world of the loss
            gl_loss, gl_stats = self.gl_loss_fn(all_gather_rows(yg["global"], self.group),
                                                g["positives_mask"], g["negatives_mask"])
        y1 = self._forward(l["anc_clouds"], l["anc_mask"], None, train)
        y2 = self._forward(l["pos_clouds"], l["pos_mask"], None, train)
        with tracing.span("egonn.step.loss"):
            loc_share, loc_stats = self.loc_loss_fn(
                l["anc_clouds"], l["anc_mask"],
                y1["keypoints"], y1["sigma"], y1["descriptors"], y1["kp_mask"],
                l["pos_clouds"], l["pos_mask"],
                y2["keypoints"], y2["sigma"], y2["descriptors"], y2["kp_mask"],
                l["t_gt"], group=self.group)
            share = gl_loss / world_size(self.group) + loc_share
            stats = {k: v for k, v in gl_stats.items() if k != "loss"}
            stats.update({k: v for k, v in loc_stats.items() if k != "loss"})
            local_loss = loc_stats["loss"]
            stats.update(global_loss=gl_loss.detach(), local_loss=local_loss,
                         loss=gl_loss.detach() + local_loss)
        return share, stats

    def __call__(self, g: Dict, l: Dict, gen: Optional[torch.Generator], lr: float,
                 train: bool) -> Dict[str, torch.Tensor]:
        model, optimizer = self.state.model, self.state.optimizer
        was_training = model.training
        try:
            with tracing.span("egonn.train_step"):
                if train:
                    model.train()
                    set_lr(optimizer, lr)
                    optimizer.zero_grad(set_to_none=True)
                    share, stats = self._losses(g, l, gen, train=True)
                    with tracing.span("egonn.step.backward"):
                        share.backward()
                    with tracing.span("egonn.step.optimizer"):
                        all_reduce_grads(model.parameters(), self.group)
                        optimizer.step()
                else:
                    # the reference's validation sets have no transform
                    model.eval()
                    with torch.no_grad():
                        _, stats = self._losses(g, l, None, train=False)
        finally:
            model.train(was_training)
        return stats


class StagedTrainStep:
    """`step(g, None, gen, lr, train)` -> stats: MinkLoc3Dv2's multistaged
    backpropagation (its training/trainer.py::multistaged_training_step).

    g: {"clouds" (B, N, 3), "point_mask" (B, N), "positives_mask" (B, B),
    "negatives_mask" (B, B)} on the model's device.  The batch's
    augmentation is drawn once from gen (each cloud's TrainTransform, one
    TrainSetTransform for the batch; None skips it), then:

    1. embed every chunk of `batch_split_size` clouds, in order, in train
       mode with gradients off (`egonn.step.embed`);
    2. the loss over the whole batch and its gradient with respect to the
       (B, D) embeddings (`egonn.step.loss`);
    3. each chunk forward again with gradients on (`egonn.step.forward`)
       and its slice of the embedding gradient backpropagated through it
       (`egonn.step.backward`), the parameter gradients accumulating;

    then one optimizer step (`egonn.step.optimizer`).  Both stages run the
    same augmented clouds in the same chunks, so BatchNorm's batch
    statistics, and the embeddings, are the same in both; the running
    statistics advance in both, twice a chunk, as in the published step.
    Stage 3 reuses each chunk's pyramid from stage 1 (it depends only on the
    chunk's augmented coordinates): no map is built twice, for ~0.2-0.4 GB
    of maps a 128-cloud chunk of 4,096-point submaps kept through the step.
    The validation form runs stages 1-2 in eval mode under no_grad and
    changes nothing.  Returns the loss's stats as detached 0-d tensors; the
    step makes no host-blocking call.  `state` holds the model, the
    optimizer and the epoch; `embeddings` the last call's stage-1
    embeddings (B, D), detached.  No data-parallel form."""

    def __init__(self, built: BuiltModel, params, group=None):
        if world_size(group) > 1:
            raise NotImplementedError("the staged step runs in one process")
        self.built = built
        self.split = params.batch_split_size
        self.aug_mode = params.aug_mode
        self.dataset = params.dataset
        self.loss_fn, _ = make_losses(params)
        self.state = TrainState(built.model, make_optimizer(built.model.parameters(), params))
        self.embeddings: Optional[torch.Tensor] = None

    def _embed(self, clouds: torch.Tensor, mask: torch.Tensor, train: bool) -> tuple:
        """Stage 1: (the batch's embeddings (B, D), each chunk's pyramid
        when training)."""
        b = self.built
        embeddings, pyramids = [], []
        with torch.no_grad():
            for at in range(0, clouds.shape[0], self.split):
                rows = slice(at, at + self.split)
                pyr = device_preprocess_global(clouds[rows], mask[rows], b.quantizer,
                                               b.pyramid_spec, with_kmap_down=train)
                embeddings.append(b.model(pyr, b.quantizer)["global"])
                if train:
                    pyramids.append(pyr)
        return torch.cat(embeddings), pyramids

    def _backprop(self, pyramids: List[Pyramid], grad: torch.Tensor) -> None:
        """Stage 3: each chunk's forward again, and its slice of the
        embedding gradient backpropagated."""
        b, at = self.built, 0
        for pyr in pyramids:
            with tracing.span("egonn.step.forward"):
                emb = b.model(pyr, b.quantizer)["global"]
            with tracing.span("egonn.step.backward"):
                emb.backward(gradient=grad[at:at + emb.shape[0]])
            at += emb.shape[0]

    def __call__(self, g: Dict, l: None, gen: Optional[torch.Generator], lr: float,
                 train: bool) -> Dict[str, torch.Tensor]:
        if l is not None:
            raise ValueError("the staged step takes a global batch alone")
        model, optimizer = self.state.model, self.state.optimizer
        clouds, mask = g["clouds"], g["point_mask"]
        if clouds.device != self.built.device:
            raise ValueError(f"clouds on {clouds.device}, the model on {self.built.device}")
        was_training = model.training
        try:
            with tracing.span("egonn.train_step"):
                model.train(train)
                with tracing.span("egonn.step.embed"):
                    if train and gen is not None:
                        clouds = augment_global(clouds, mask, gen, self.aug_mode,
                                                dataset=self.dataset)
                    embeddings, pyramids = self._embed(clouds, mask, train)
                self.embeddings = embeddings.detach()
                if not train:
                    with tracing.span("egonn.step.loss"), torch.no_grad():
                        return self.loss_fn(embeddings, g["positives_mask"],
                                            g["negatives_mask"])[1]
                set_lr(optimizer, lr)
                with tracing.span("egonn.step.loss"):
                    embeddings.requires_grad_(True)
                    loss, stats = self.loss_fn(embeddings, g["positives_mask"],
                                               g["negatives_mask"])
                    grad, = torch.autograd.grad(loss, embeddings)
                optimizer.zero_grad(set_to_none=True)
                self._backprop(pyramids, grad)
                with tracing.span("egonn.step.optimizer"):
                    optimizer.step()
        finally:
            model.train(was_training)
        return stats


def make_train_step(built: BuiltModel, params, group=None):
    """The combined (global + local) train / validation step (on this
    rank's rows, given a data-parallel group); for a MinkLoc model with
    `batch_split_size` set, the staged global-only step."""
    if built.model_type == "minkloc":
        if getattr(params, "batch_split_size", None) is None:
            raise NotImplementedError("a MinkLoc model trains through the staged step: "
                                      "set batch_split_size")
        return StagedTrainStep(built, params, group)
    return TrainStep(built, params, group)


def print_stats(stats: Dict[str, float], phase: str) -> None:
    """Reference training/trainer.py:18-43."""
    if "num_triplets" in stats:
        print(f"{phase} - Global loss: {stats['global_loss']:.6f}    "
              f"Embedding norm: {stats['avg_embedding_norm']:.4f}   "
              f"Triplets (all/active): {stats['num_triplets']:.1f}/"
              f"{stats['num_non_zero_triplets']:.1f}")
    if "mean_pos_pair_dist" in stats:
        print("Pos dist (min/mean/max): {:.4f}/{:.4f}/{:.4f}   "
              "Neg dist (min/mean/max): {:.4f}/{:.4f}/{:.4f}".format(
                  stats["min_pos_pair_dist"], stats["mean_pos_pair_dist"],
                  stats["max_pos_pair_dist"], stats["min_neg_pair_dist"],
                  stats["mean_neg_pair_dist"], stats["max_neg_pair_dist"]))
    if "best_positive_ranking" in stats:
        print(f"{phase} - Loss: {stats['loss']:.6f}   Positives per query: "
              f"{stats['positives_per_query']:.1f}   Best positive ranking: "
              f"{stats['best_positive_ranking']:.2f}   Recall@1: {stats['recall@1']:.3f}")
    if "local_loss" in stats:
        print(f"Local loss: {stats['local_loss']:.4f}   "
              f"loss chamfer: {stats['loss_chamfer']:.4f}   "
              f"loss p2p: {stats['loss_p2p']:.4f}  "
              f"desc. loss: {stats['correspondence_loss']:.4f}")
        print(f"repeat.: {stats['repeatability']:0.3f}   "
              f"match. descriptors: {stats['matching_descriptors']:0.3f}")


def step_generator(device: torch.device, *words: int) -> torch.Generator:
    """A generator on `device` seeded from the words (epoch, phase, step, ...)."""
    seed = int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _to_device(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batches onto the device; to the card through pinned memory, so
    that the copy queues behind the previous step instead of waiting."""
    if device.type != "cuda":
        return {k: torch.from_numpy(v) for k, v in arrays.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in arrays.items()}


def capacity_audit(built: BuiltModel, g: GlobalBatch, aug_mode: int, epoch: int,
                   group=None, split: Optional[int] = None, dataset: Optional[str] = None
                   ) -> dict:
    """The voxel-capacity report of one global batch's pyramid, augmented as
    in training (from a generator seeded (1, epoch)), with a warning where a
    level dropped voxels.  With a data-parallel group, g holds the rank's
    rows and the report is the global batch's (the same on every rank);
    with `split`, the pyramids are built a chunk of that many clouds at a
    time, as the staged step builds them, and the report is their worst."""
    device = built.device
    clouds = _to_device({"c": g.clouds, "m": g.point_mask}, device)
    with torch.no_grad():
        m = clouds["m"]
        c = augment_global(clouds["c"], m, step_generator(device, 1, epoch), aug_mode, group,
                           dataset)
        chunk = split or c.shape[0]
        caps = {}
        for at in range(0, c.shape[0], chunk):
            pyr = device_preprocess_global(c[at:at + chunk], m[at:at + chunk], built.quantizer,
                                           built.pyramid_spec, group=group)
            for k, (n, cap, _) in capacity_report(pyr, built.pyramid_spec, group).items():
                n = max(n, caps.get(k, (0,))[0])
                caps[k] = (n, cap, n <= cap)
    bad = {k: (n, c) for k, (n, c, ok) in caps.items() if not ok}
    if bad:
        detail = ", ".join(f"{k}: {n} > {c}" for k, (n, c) in sorted(bad.items()))
        print(f"WARNING: voxel-capacity overflow ({detail}) — densest voxels beyond each "
              "capacity dropped; raise PyramidSpec capacities / model cap0 or calibrate "
              "them (sparse/calibrate.py calibrate_capacities)")
    return caps


def do_train(params, debug: bool = False, weights_path: str = "weights", log_fn=None,
             dataset_type: Optional[str] = None, resume_from: Optional[str] = None,
             device="cuda", backend: Optional[str] = None):
    """Train `params` (a `config.TrainingParams`) on `device` for
    params.epochs epochs; returns (TrainState, {"train": [...], "val": [...]}
    per-epoch stats, model name).

    Checkpoints go to weights_path/<model name>/step_<epoch>.pt.  log_fn
    (default: a `MetricsLogger` at weights_path/<model name>.metrics.jsonl)
    takes one record per epoch: epoch, lr, the train and val stats, and per
    phase its steps, its seconds (host clock, ending in a read of the
    stats), the seconds it waited for the Prefetcher (`input_wait_s`) and
    spent copying batches to the device (`copy_s`); and a `test` record
    (recall@1, local metrics at n_k 128, seconds) after each in-training
    evaluation.  resume_from: a checkpoint directory of an earlier run;
    training restores the model, the optimizer, the epoch and the
    sampler's batch size from its latest step and continues into that
    directory.  debug: 2 steps per phase.

    A MinkLoc config (with `batch_split_size`) trains through the staged
    step on global batches alone: no local pairs are read, and batch
    expansion, which reads the triplet miner's stats, stays off.

    params.mesh (`parallel/mesh.py::resolve_mesh`): N > 1 trains on N ranks,
    this process rank 0 (whose state and stats are returned); `backend`
    overrides the device's default (NCCL on CUDA, gloo on the CPU)."""
    device = torch.device(device)
    world = resolve_mesh(getattr(params, "mesh", "auto"), device)
    dataset_type = dataset_type or params.dataset
    if resume_from is not None:
        resume_from = resume_from.rstrip("/")
        model_name = os.path.basename(resume_from)
        weights_path = os.path.dirname(resume_from) or "."
    else:
        model_name = f"model_{params.model_params.model}_{get_datetime()}"
    os.makedirs(weights_path, exist_ok=True)
    print(f"Model name: {model_name}")
    args = (params, debug, weights_path, dataset_type, resume_from, device, model_name)
    if world == 1:
        return _train_rank(None, *args, log_fn=log_fn)
    if device.type == "cuda":
        from egonn_tpu_torch.sparse import cuda_lib

        cuda_lib.build_all()  # once, before the ranks load the libraries
    print(f"Data-parallel mesh over {world} ranks; batch buckets rounded to multiples "
          f"of {world}")
    return run_ranks(_train_rank, world, args, device=device, backend=backend,
                     rank0_kwargs={"log_fn": log_fn})[0]


def _train_rank(group, params, debug: bool, weights_path: str, dataset_type: str,
                resume_from: Optional[str], device, model_name: str, log_fn=None):
    """One rank of `do_train` (group None: the single process).  Rank 0
    returns do_train's result and alone prints, logs and checkpoints; the
    other ranks return None."""
    main_rank = rank_of(group) == 0
    device = rank_device(device, group)
    logger = None
    with quiet_unless_rank0(group):
        built = model_factory(params.model_params, device=device)
        if not main_rank:
            log_fn = _no_log
        elif log_fn is None:
            from egonn_tpu_torch.utils.logging import MetricsLogger

            logger = MetricsLogger(weights_path, model_name,
                                   config={k: v for k, v in vars(params).items()
                                           if k != "model_params"})
            log_fn = logger.log
        try:
            out = _train_epochs(params, built, debug, log_fn, dataset_type, resume_from,
                                os.path.join(weights_path, model_name), model_name, group)
        finally:
            if logger is not None:
                logger.close()
    return out if main_rank else None


def _no_log(record: dict) -> None:
    """The metrics log of ranks other than 0."""


def _train_epochs(params, built: BuiltModel, debug: bool, log_fn, dataset_type: str,
                  resume_from: Optional[str], ckpt_dir: str, model_name: str, group=None):
    device = built.device
    world, main_rank = world_size(group), rank_of(group) == 0
    num_points = resolve_num_points(params.model_params, dataset_type)
    quantizer = built.quantizer
    # a MinkLoc model trains on global batches alone (the staged step)
    global_only = built.model_type == "minkloc"
    train_ds = TrainingDataset(params.dataset_folder, dataset_type, params.train_file)
    local_train_ds = val_ds = local_val_ds = None
    if not global_only:
        local_train_ds = Training6DOFDataset(params.dataset_folder, dataset_type,
                                             params.train_file, quantizer,
                                             rot_max=params.rot_max, trans_max=params.trans_max)
    if params.val_file:
        val_ds = TrainingDataset(params.dataset_folder, dataset_type, params.val_file)
        if not global_only:
            local_val_ds = Training6DOFDataset(params.dataset_folder, dataset_type,
                                               params.val_file, quantizer,
                                               rot_max=params.rot_max, trans_max=params.trans_max)
    sampler = BatchSampler(train_ds, batch_size=params.batch_size,
                           batch_size_limit=params.batch_size_limit,
                           batch_expansion_rate=params.batch_expansion_rate, seed=0)
    val_sampler = (BatchSampler(val_ds, batch_size=params.batch_size_limit, seed=0)
                   if val_ds else None)
    buckets = expansion_buckets(params.batch_size, params.batch_size_limit,
                                params.batch_expansion_rate, multiple_of=world)
    # local batches hold real pairs only, split evenly over the ranks
    lbs = -(-params.local_batch_size // world) * world
    if lbs != params.local_batch_size and not global_only:
        print(f"local_batch_size {params.local_batch_size} -> {lbs} "
              f"(multiple of {world} mesh devices)")
    lr_sched = make_lr_schedule(params)
    step = make_train_step(built, params, group)
    state = step.state
    start_epoch = 1
    if resume_from is not None:
        ck_step = load_checkpoint(resume_from, state)
        meta = load_checkpoint_meta(resume_from, ck_step)
        if "sampler_batch_size" in meta:
            sampler.batch_size = int(meta["sampler_batch_size"])
        start_epoch = state.epoch + 1
        print(f"Resumed from {resume_from} step {ck_step}: epoch {start_epoch}, "
              f"batch_size {sampler.batch_size}")

    all_stats: Dict[str, List[Dict[str, float]]] = {"train": [], "val": []}
    test_evaluator = None  # built once: its caches live across evaluations
    last_global = None     # the last train batch, for the capacity audit
    for epoch in range(start_epoch, params.epochs + 1):
        t_epoch = time.perf_counter()
        lr = lr_sched(epoch - 1)
        sampler.set_epoch(epoch)
        if local_train_ds is not None:
            local_train_ds.set_epoch(epoch)
        if val_ds is not None:
            val_sampler.set_epoch(epoch)
        if local_val_ds is not None:
            local_val_ds.set_epoch(epoch)
        record = {"epoch": epoch, "lr": lr, "steps": {}, "seconds": {}, "input_wait_s": {},
                  "copy_s": {}}
        phases = ["train"] + (["val"] if val_ds else [])
        with tracing.capture(f"train_epoch{epoch}",
                             enabled=epoch == min(tracing.trace_epoch(), params.epochs)):
            for phase_idx, phase in enumerate(phases):
                t_phase = time.perf_counter()
                train = phase == "train"
                ds, lds, smp = ((train_ds, local_train_ds, sampler) if train
                                else (val_ds, local_val_ds, val_sampler))
                if global_only:
                    local_batches = itertools.repeat(None)
                else:
                    local_ids = list(lds.valid_ids)
                    np.random.default_rng([0, epoch, phase_idx]).shuffle(local_ids)
                    rows = row_slice(lbs, group)
                    local_batches = [local_ids[i : i + lbs][rows]
                                     for i in range(0, len(local_ids) - lbs + 1, lbs)]

                def batches(ds=ds, lds=lds, smp=smp, local_batches=local_batches):
                    for gids, lids in zip(smp, local_batches):
                        with tracing.span("egonn.batch_prep"):
                            yield (make_global_batch(ds, gids, num_points, buckets, group),
                                   None if lids is None else
                                   make_local_batch(lds, lids, num_points))

                keys, running, copy_s = None, [], 0.0
                prefetcher = Prefetcher(batches)
                for count, (g, l) in enumerate(prefetcher):
                    if train:
                        last_global = g
                    if debug and count >= 2:
                        break
                    if g.positives_mask.sum() == 0 or g.negatives_mask.sum() == 0:
                        print("WARNING: Skipping batch without positive or negative examples")
                        continue
                    t_copy = time.perf_counter()
                    gdict = _to_device({"clouds": g.clouds, "point_mask": g.point_mask,
                                        "positives_mask": g.positives_mask,
                                        "negatives_mask": g.negatives_mask}, device)
                    ldict = None if l is None else _to_device(
                        {"anc_clouds": l.anc_clouds, "anc_mask": l.anc_mask,
                         "pos_clouds": l.pos_clouds, "pos_mask": l.pos_mask, "t_gt": l.t_gt},
                        device)
                    copy_s += time.perf_counter() - t_copy
                    gen = step_generator(device, 0, epoch, phase_idx, count) if train else None
                    stats = step(gdict, ldict, gen, lr, train)
                    keys = keys or list(stats)
                    # the step's stats stay on the device; one copy per phase
                    running.append(torch.stack([stats[k].float() for k in keys]))

                record["steps"][phase] = len(running)
                record["input_wait_s"][phase] = prefetcher.wait_s
                record["copy_s"][phase] = copy_s
                if running:
                    vals = torch.stack(running).cpu().double().numpy()
                    epoch_stats = {k: float(np.mean(vals[:, i])) for i, k in enumerate(keys)}
                    all_stats[phase].append(epoch_stats)
                    record[phase] = epoch_stats
                    print_stats(epoch_stats, phase)
                else:
                    print(f"WARNING: {phase} epoch produced ZERO steps — check that tuples "
                          "have positives and both loaders are non-empty")
                record["seconds"][phase] = time.perf_counter() - t_phase
        state.epoch += 1

        if last_global is not None:
            capacity_audit(built, last_global, params.aug_mode, epoch, group,
                           split=getattr(step, "split", None), dataset=params.dataset)

        if params.test_file and epoch % EVAL_EVERY == 0:
            test_evaluator = _evaluate(params, built, dataset_type, num_points, test_evaluator,
                                       epoch, log_fn, group)

        if all_stats["train"]:
            log_fn(record)

        # decided before the checkpoint, whose sampler_batch_size is then
        # the batch size of the next epoch
        if params.batch_expansion_th is not None and all_stats["train"]:
            es = all_stats["train"][-1]
            if "num_non_zero_triplets" in es and es["num_triplets"] > 0:
                if es["num_non_zero_triplets"] / es["num_triplets"] < params.batch_expansion_th:
                    sampler.expand_batch()

        if epoch % params.save_freq == 0 and main_rank:
            save_checkpoint(ckpt_dir, state, epoch,
                            extra_meta={"sampler_batch_size": sampler.batch_size})
        print(f"epoch {epoch} took {time.perf_counter() - t_epoch:.1f}s (lr {lr:.2e})")

    if main_rank:
        save_checkpoint(ckpt_dir, state, params.epochs,
                        extra_meta={"sampler_batch_size": sampler.batch_size})
    return state, all_stats, model_name


def _evaluate(params, built: BuiltModel, dataset_type: str, num_points: int, evaluator,
              epoch: int, log_fn, group=None):
    """The in-training evaluation on params.test_file, in eval mode (the
    model's mode restored after), sharded over a data-parallel group's
    ranks; returns the evaluator for the next one.  A failure is printed,
    not raised: it must not end the training."""
    from egonn_tpu_torch.eval.evaluator import GLEvaluator

    model = built.model
    was_training = model.training
    try:
        if evaluator is None:
            evaluator = GLEvaluator(params.dataset_folder, dataset_type, params.test_file,
                                    built, num_points=num_points, k=20, n_samples=100,
                                    n_k=(128,), group=group)
        model.eval()
        t0 = time.perf_counter()
        gm, lm = evaluator.evaluate()
        seconds = time.perf_counter() - t0
        evaluator.print_results(gm, lm)
        log_fn({"epoch": epoch, "seconds": seconds, "test": {
            "recall@1": {r: float(v[0]) for r, v in gm["recall"].items()},
            **{f"local_{k}": v for k, v in lm.get(128, {}).items()}}})
    except Exception as e:
        traceback.print_exc()
        print(f"WARNING: in-training eval failed: {e!r}")
    finally:
        model.train(was_training)
    return evaluator
