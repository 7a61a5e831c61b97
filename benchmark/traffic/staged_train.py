"""Closed-loop staged training (MinkLoc3Dv2's multistaged backpropagation):
the program's `make_train_step(...)`, a `StagedTrainStep`, called as
`step(g, None, gen, lr, True)` on batches of `places` x `scans_per_place`
normalized submaps (`core/submaps.py`), a pool of distinct batches made in
set-up cycled in order, the step's augmentation drawing from a generator
seeded per pool entry.

As in `traffic/train.py`: set-up builds one step object and drives it
through its first three steps (one per pool entry); the window runs that
object; once the window has closed the object is put back to the seeded
start in place and runs the same three steps again.  The reference
(`reference/staged.py`) follows the three steps once, from the same
weights, batches and draws, and each number compared is the worse of the
two runs': step 1's stage-1 embeddings (`embed_gap`, the widest gap of
any cloud), the first gradient as Adam took it (`grad_gap`, by its worst
leaf), the change of the BatchNorm running
statistics over step 1 (`stats1_gap`, by its worst leaf: computed from the
seeded weights alone, it shows whether both stages advanced them, which
three steps of 32 momentum updates each all but wash out) and the change of
the parameters and BatchNorm statistics over the three steps (`change_gap`,
by its worst leaf).  `dropped_voxels` counts the voxels beyond a level's capacity in
the pool's augmented chunks (the program's `capacity_report`).  Each step's
loss (`loss_gap`) is read and logged but held to no limit: at tau1 0.01 the
sound program's rounding moves it as far as TF32 or any planted fault does.

Parameters (`traffic_params`): places, scans_per_place, points, pool (3:
the steps the reference follows), trace_after / trace_steps (the traced
stretch, in steps of the window).  The chunk size is the configuration's
`batch_split_size`.

End to end: `train_clouds_per_s`, the clouds of every step started in the
window over the window's time.
"""
from __future__ import annotations

import time

import torch

from benchmark.core import compare
from benchmark.core.cell import Outcome
from benchmark.core.submaps import make_batch
from benchmark.reference import staged as ref_staged
from benchmark.reference.train import Adam
from benchmark.traffic.train import BETA1, reset

STEPS_COMPARED = 3


def make_batches(cell, _quantizer=None) -> list:
    """The pool's global batches of raw submaps (the quantizer that
    `control.py` hands every training traffic is not needed: the staged
    step quantizes on the device)."""
    p = cell.traffic
    if p["pool"] != STEPS_COMPARED:
        raise ValueError(f"the pool holds the {STEPS_COMPARED} steps the reference follows")
    return [make_batch(cell.generator(4, i), p["places"], p["scans_per_place"], p["points"])
            for i in range(STEPS_COMPARED)]


def first_steps(cell, step, batches) -> tuple:
    """The program's first three steps: (losses, the first gradient as Adam
    took it, the state after them, step 1's stage-1 embeddings, the
    BatchNorm statistics after step 1)."""
    model, opt = step.state.model, step.state.optimizer
    losses = []
    for i, g in enumerate(batches):
        stats = step(g, None, cell.generator(5, i), cell.cfg["train"]["lr"], True)
        losses.append(stats["loss"])
        if i == 0:
            embeddings = step.embeddings.clone()
            stats1 = {k: v.clone() for k, v in model.named_buffers()}
            # an optimizer that kept no moment took no gradient
            grad1 = {n: opt.state.get(q, {}).get("exp_avg", torch.zeros_like(q)) / (1 - BETA1)
                     for n, q in model.named_parameters()}
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return [float(x) for x in losses], grad1, after, embeddings, stats1


def reference_steps(cell, batches) -> tuple:
    """The reference's three steps from the seeded weights on the same
    batches and draws: (losses, first gradient, state after, step 1's
    stage-1 embeddings, the BatchNorm statistics after step 1, each step's
    work records)."""
    t = cell.cfg["train"]
    ref, quantizer, spec = cell.reference()
    adam = Adam(dict(ref.named_parameters()), t["lr"], t["weight_decay"])
    logs, losses = [], []
    for i, g in enumerate(batches):
        log: list = []
        loss, taken, embeddings, _ = ref_staged.staged_step(ref, quantizer, spec, adam, g,
                                                            cell.generator(5, i), t, log)
        logs.append(log)
        losses.append(float(loss))
        if i == 0:
            grad1, emb1 = taken, embeddings
            stats1 = {k: v.clone() for k, v in ref.named_buffers()}
    return losses, grad1, ref.state_dict(), emb1, stats1, logs


def gaps(cell, prog: tuple, ref: tuple) -> tuple:
    """(readings, the worst leaves) of the program's three steps against the
    reference's."""
    losses, grad1, after, emb, stats1 = prog
    ref_losses, ref_grad1, ref_after, ref_emb, ref_stats1 = ref[:5]
    before = cell.state()
    moved1 = compare.leaf_gaps({k: v - before[k] for k, v in stats1.items()},
                               {k: v - before[k] for k, v in ref_stats1.items()}, ref_stats1)
    buffers = [k for k in ref_after if k not in ref_grad1]
    leaves = compare.moved_leaves(ref_grad1, buffers)
    grad = compare.leaf_gaps(grad1, ref_grad1, ref_grad1)
    change = compare.leaf_gaps({k: after[k] - before[k] for k in leaves},
                               {k: ref_after[k] - before[k] for k in leaves}, leaves)
    readings = {
        "embed_gap": compare.output_gaps({"global": emb}, {"global": ref_emb},
                                         ["global"])["global_gap"],
        "loss_gap": max(compare.relative(a, b) for a, b in zip(losses, ref_losses)),
        "grad_gap": max(grad.values()),
        "stats1_gap": max(moved1.values()),
        "change_gap": max(change.values()),
    }
    return readings, (max(grad, key=grad.get), max(change, key=change.get))


def dropped_voxels(cell, built, batches) -> tuple:
    """(voxels beyond a level's capacity, summed over the levels of every
    chunk of the pool's batches augmented as the steps draw them, and the
    worst count of each level)."""
    from egonn_tpu_torch.data.pipeline import augment_global, device_preprocess_global
    from egonn_tpu_torch.sparse.pyramid import capacity_report

    t = cell.cfg["train"]
    split = t["batch_split_size"]
    dropped, worst = 0, {}
    with torch.no_grad():
        for i, g in enumerate(batches):
            clouds = augment_global(g["clouds"], g["point_mask"], cell.generator(5, i),
                                    t["aug_mode"], dataset=t["dataset"])
            for at in range(0, clouds.shape[0], split):
                rows = slice(at, at + split)
                pyr = device_preprocess_global(clouds[rows], g["point_mask"][rows],
                                               built.quantizer, built.pyramid_spec)
                for level, (n, cap, _) in capacity_report(pyr, built.pyramid_spec).items():
                    dropped += max(0, n - cap)
                    worst[level] = max(worst.get(level, 0), n)
    return dropped, worst


def run(cell) -> Outcome:
    from egonn_tpu_torch.train.trainer import StagedTrainStep, make_train_step

    p, t = cell.traffic, cell.cfg["train"]
    built = cell.program()
    step = make_train_step(built, cell.adapter.train_params(cell.cfg))
    if not isinstance(step, StagedTrainStep):
        raise TypeError(f"make_train_step built a {type(step).__name__}, not the staged step")
    batches = make_batches(cell)
    cell.phase("inputs")
    prog = first_steps(cell, step, batches)
    tracer = cell.tracer
    if tracer:
        tracer.warm()
    lr = t["lr"]
    t0 = cell.window_started()
    end = t0 + cell.seconds
    i = STEPS_COMPARED
    first_traced = STEPS_COMPARED + p["trace_after"]
    while True:
        if tracer and i == first_traced:
            tracer.start()
        step(batches[i % STEPS_COMPARED], None, cell.generator(5, i % STEPS_COMPARED), lr, True)
        i += 1
        if tracer and tracer.active and i == first_traced + p["trace_steps"]:
            tracer.stop()
        if time.perf_counter() >= end:
            break
    cell.sync()
    window_s = time.perf_counter() - t0
    if tracer and tracer.active:
        tracer.stop()
    window_steps = range(STEPS_COMPARED, i)
    traced = range(first_traced, min(i, first_traced + p["trace_steps"]))
    cell.read_peak()
    reset(step, cell.state())
    replay = first_steps(cell, step, batches)
    dropped, worst = dropped_voxels(cell, built, batches)
    cell.log(f"voxels a level, worst chunk: {worst} against {built.pyramid_spec.capacities}; "
             f"dropped {dropped}")
    del step, built
    cell.free()

    ref = reference_steps(cell, batches)
    readings = {"dropped_voxels": float(dropped)}
    for name, run_ in (("set-up", prog), ("after the window", replay)):
        got, worst_leaves = gaps(cell, run_, ref)
        compare.merge_worst(readings, got)
        cell.log(f"{name}: losses {run_[0]} against {ref[0]}; readings {got}; worst grad "
                 f"leaf {worst_leaves[0]}, worst change leaf {worst_leaves[1]}")
    cell.log(f"{len(window_steps)} steps in {window_s:.3f} s; readings {readings}")
    checks = {k: readings[k] for k in cell.workload["limits"]}
    logs = ref[5]
    return Outcome(
        e2e={"train_clouds_per_s": len(window_steps) * p["places"] * p["scans_per_place"]
             / window_s},
        attempted=len(window_steps), failed=0, checks=checks,
        traced_calls=len(traced) if tracer else 0,
        traced_records=[r for s in traced for r in logs[s % STEPS_COMPARED]])
