"""Training (port of `egonn_tpu/train/trainer.py`): the EgoNN training step
and `do_train`, the epoch loop around it.

One step processes one global batch (batch-hard triplet loss on the global
descriptors) and one local batch of cloud pairs (keypoint + correspondence
losses) and makes one optimizer update for the summed loss, as the
reference does (training/trainer.py:160-193).  Three train-mode forwards run
in order, global (augmented), anchor, positive, so the BatchNorm running
statistics advance through all three as the JAX step threads them.  The
validation form runs the same forwards in eval mode under no_grad, without
augmentation, and changes nothing.

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

Not ported: the data-parallel mesh (`params.mesh` "auto" or 1 is one
device; more raises, ROADMAP A.9), and the band auto-calibration, which the
JAX loop runs only for its banded engine: no port kernel keeps band
windows, so there is nothing to calibrate.
"""
from __future__ import annotations

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
    device_preprocess_global,
    make_global_batch,
    resolve_num_points,
)
from egonn_tpu_torch.data.samplers import BatchSampler
from egonn_tpu_torch.losses.keypoint import make_losses
from egonn_tpu_torch.models.factory import BuiltModel, model_factory
from egonn_tpu_torch.sparse.pyramid import capacity_report
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
    and the epoch (for checkpoints)."""

    def __init__(self, built: BuiltModel, params):
        self.built = built
        self.aug_mode = params.aug_mode
        self.gl_loss_fn, self.loc_loss_fn = make_losses(params)
        self.state = TrainState(built.model, make_optimizer(built.model.parameters(), params))

    def _forward(self, clouds, mask, gen, train: bool):
        b = self.built
        for name, t in (("clouds", clouds), ("mask", mask)):
            if t.device != b.device:
                raise ValueError(f"{name} on {t.device}, the model on {b.device}")
        pyr = device_preprocess_global(clouds, mask, b.quantizer, b.pyramid_spec, gen=gen,
                                       aug_mode=self.aug_mode, with_kmap_down=train)
        return b.model(pyr, b.quantizer)

    def _losses(self, g: Dict, l: Dict, gen, train: bool):
        yg = self._forward(g["clouds"], g["point_mask"], gen, train)
        gl_loss, gl_stats = self.gl_loss_fn(yg["global"], g["positives_mask"],
                                            g["negatives_mask"])
        y1 = self._forward(l["anc_clouds"], l["anc_mask"], None, train)
        y2 = self._forward(l["pos_clouds"], l["pos_mask"], None, train)
        loc_loss, loc_stats = self.loc_loss_fn(
            l["anc_clouds"], l["anc_mask"],
            y1["keypoints"], y1["sigma"], y1["descriptors"], y1["kp_mask"],
            l["pos_clouds"], l["pos_mask"],
            y2["keypoints"], y2["sigma"], y2["descriptors"], y2["kp_mask"],
            l["t_gt"])
        total = gl_loss + loc_loss
        stats = {k: v for k, v in gl_stats.items() if k != "loss"}
        stats.update({k: v for k, v in loc_stats.items() if k != "loss"})
        stats.update(global_loss=gl_loss.detach(), local_loss=loc_loss.detach(),
                     loss=total.detach())
        return total, stats

    def __call__(self, g: Dict, l: Dict, gen: Optional[torch.Generator], lr: float,
                 train: bool) -> Dict[str, torch.Tensor]:
        model, optimizer = self.state.model, self.state.optimizer
        was_training = model.training
        try:
            if train:
                model.train()
                set_lr(optimizer, lr)
                optimizer.zero_grad(set_to_none=True)
                total, stats = self._losses(g, l, gen, train=True)
                total.backward()
                optimizer.step()
            else:
                # the reference's validation sets have no transform
                model.eval()
                with torch.no_grad():
                    _, stats = self._losses(g, l, None, train=False)
        finally:
            model.train(was_training)
        return stats


def make_train_step(built: BuiltModel, params) -> TrainStep:
    """The combined (global + local) train / validation step."""
    return TrainStep(built, params)


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
    if "local_loss" in stats:
        print(f"Local loss: {stats['local_loss']:.4f}   "
              f"loss chamfer: {stats['loss_chamfer']:.4f}   "
              f"loss p2p: {stats['loss_p2p']:.4f}  "
              f"desc. loss: {stats['correspondence_loss']:.4f}")
        print(f"repeat.: {stats['repeatability']:0.3f}   "
              f"match. descriptors: {stats['matching_descriptors']:0.3f}")


def check_mesh(mesh_opt) -> None:
    """The [TRAIN] mesh option: "auto", "off", 0 or 1 train on one device;
    a larger mesh is refused (data parallel is not ported yet)."""
    if mesh_opt in (None, "off", "auto", "0", "1", 0, 1):
        return
    raise NotImplementedError(f"mesh {mesh_opt!r}: data-parallel training is not ported yet "
                              "(ROADMAP A.9); set mesh = auto or 1 to train on one device")


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


def capacity_audit(built: BuiltModel, g: GlobalBatch, aug_mode: int, epoch: int) -> dict:
    """The voxel-capacity report of one global batch's pyramid, augmented as
    in training (from a generator seeded (1, epoch)), with a warning where a
    level dropped voxels."""
    device = built.device
    clouds = _to_device({"c": g.clouds, "m": g.point_mask}, device)
    with torch.no_grad():
        pyr = device_preprocess_global(clouds["c"], clouds["m"], built.quantizer,
                                       built.pyramid_spec, gen=step_generator(device, 1, epoch),
                                       aug_mode=aug_mode)
        caps = capacity_report(pyr, built.pyramid_spec)
    bad = {k: (n, c) for k, (n, c, ok) in caps.items() if not ok}
    if bad:
        detail = ", ".join(f"{k}: {n} > {c}" for k, (n, c) in sorted(bad.items()))
        print(f"WARNING: voxel-capacity overflow ({detail}) — densest voxels beyond each "
              "capacity dropped; raise PyramidSpec capacities / model cap0 or calibrate "
              "them (sparse/calibrate.py calibrate_capacities)")
    return caps


def do_train(params, debug: bool = False, weights_path: str = "weights", log_fn=None,
             dataset_type: Optional[str] = None, resume_from: Optional[str] = None,
             device="cuda"):
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
    directory.  debug: 2 steps per phase."""
    device = torch.device(device)
    check_mesh(getattr(params, "mesh", "auto"))
    dataset_type = dataset_type or params.dataset
    built = model_factory(params.model_params, device=device)
    if resume_from is not None:
        resume_from = resume_from.rstrip("/")
        model_name = os.path.basename(resume_from)
        weights_path = os.path.dirname(resume_from) or "."
    else:
        model_name = f"model_{params.model_params.model}_{get_datetime()}"
    os.makedirs(weights_path, exist_ok=True)
    ckpt_dir = os.path.join(weights_path, model_name)
    print(f"Model name: {model_name}")
    logger = None
    if log_fn is None:
        from egonn_tpu_torch.utils.logging import MetricsLogger

        logger = MetricsLogger(weights_path, model_name,
                               config={k: v for k, v in vars(params).items()
                                       if k != "model_params"})
        log_fn = logger.log
    try:
        return _train_epochs(params, built, debug, log_fn, dataset_type, resume_from,
                             ckpt_dir, model_name)
    finally:
        if logger is not None:
            logger.close()


def _train_epochs(params, built: BuiltModel, debug: bool, log_fn, dataset_type: str,
                  resume_from: Optional[str], ckpt_dir: str, model_name: str):
    device = built.device
    num_points = resolve_num_points(params.model_params, dataset_type)
    quantizer = built.quantizer
    train_ds = TrainingDataset(params.dataset_folder, dataset_type, params.train_file)
    local_train_ds = Training6DOFDataset(params.dataset_folder, dataset_type, params.train_file,
                                         quantizer, rot_max=params.rot_max,
                                         trans_max=params.trans_max)
    val_ds = local_val_ds = None
    if params.val_file:
        val_ds = TrainingDataset(params.dataset_folder, dataset_type, params.val_file)
        local_val_ds = Training6DOFDataset(params.dataset_folder, dataset_type,
                                           params.val_file, quantizer, rot_max=params.rot_max,
                                           trans_max=params.trans_max)
    sampler = BatchSampler(train_ds, batch_size=params.batch_size,
                           batch_size_limit=params.batch_size_limit,
                           batch_expansion_rate=params.batch_expansion_rate, seed=0)
    val_sampler = (BatchSampler(val_ds, batch_size=params.batch_size_limit, seed=0)
                   if val_ds else None)
    buckets = expansion_buckets(params.batch_size, params.batch_size_limit,
                                params.batch_expansion_rate)
    lr_sched = make_lr_schedule(params)
    step = make_train_step(built, params)
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
        local_train_ds.set_epoch(epoch)
        if val_ds is not None:
            val_sampler.set_epoch(epoch)
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
                local_ids = list(lds.valid_ids)
                np.random.default_rng([0, epoch, phase_idx]).shuffle(local_ids)
                lbs = params.local_batch_size
                local_batches = [local_ids[i : i + lbs]
                                 for i in range(0, len(local_ids) - lbs + 1, lbs)]

                def batches(ds=ds, lds=lds, smp=smp, local_batches=local_batches):
                    for gids, lids in zip(smp, local_batches):
                        with tracing.annotate("batch_prep"):
                            yield (make_global_batch(ds, gids, num_points, buckets),
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
                    ldict = _to_device({"anc_clouds": l.anc_clouds, "anc_mask": l.anc_mask,
                                        "pos_clouds": l.pos_clouds, "pos_mask": l.pos_mask,
                                        "t_gt": l.t_gt}, device)
                    copy_s += time.perf_counter() - t_copy
                    gen = step_generator(device, 0, epoch, phase_idx, count) if train else None
                    with tracing.step_annotation(f"{phase}_step", count):
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
            capacity_audit(built, last_global, params.aug_mode, epoch)

        if params.test_file and epoch % EVAL_EVERY == 0:
            test_evaluator = _evaluate(params, built, dataset_type, num_points, test_evaluator,
                                       epoch, log_fn)

        if all_stats["train"]:
            log_fn(record)

        # decided before the checkpoint, whose sampler_batch_size is then
        # the batch size of the next epoch
        if params.batch_expansion_th is not None and all_stats["train"]:
            es = all_stats["train"][-1]
            if "num_non_zero_triplets" in es and es["num_triplets"] > 0:
                if es["num_non_zero_triplets"] / es["num_triplets"] < params.batch_expansion_th:
                    sampler.expand_batch()

        if epoch % params.save_freq == 0:
            save_checkpoint(ckpt_dir, state, epoch,
                            extra_meta={"sampler_batch_size": sampler.batch_size})
        print(f"epoch {epoch} took {time.perf_counter() - t_epoch:.1f}s (lr {lr:.2e})")

    save_checkpoint(ckpt_dir, state, params.epochs,
                    extra_meta={"sampler_batch_size": sampler.batch_size})
    return state, all_stats, model_name


def _evaluate(params, built: BuiltModel, dataset_type: str, num_points: int, evaluator,
              epoch: int, log_fn):
    """The in-training evaluation on params.test_file, in eval mode (the
    model's mode restored after); returns the evaluator for the next one.
    A failure is printed, not raised: it must not end the training."""
    from egonn_tpu_torch.eval.evaluator import GLEvaluator

    model = built.model
    was_training = model.training
    try:
        if evaluator is None:
            evaluator = GLEvaluator(params.dataset_folder, dataset_type, params.test_file,
                                    built, num_points=num_points, k=20, n_samples=100,
                                    n_k=(128,))
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
