"""Closed-loop training: the program's `make_train_step(...)` called as
`step(g, l, gen, lr, True)` on the configuration's full-width batch, a pool
of distinct batches made in set-up (`core/train_batch.py`) cycled in order,
the step's augmentation drawing from a generator seeded per pool entry.

Set-up builds one step object, drives it through its first three steps (one
per pool entry, so their rows all differ) and hands that same object to the
window.  Once the window has closed, that object is put back in place to
the seeded start (`reset`: its tensors stay the ones the window used) and
runs the same three steps again, so whatever the object does only after
many steps is compared too.  The reference follows the three steps once,
from the same weights, batches and draws, and each number compared is the
worse of the two runs': each step's loss, the first gradient as Adam took
it (the program's worked out from its first moment after one step) and the
change of the parameters and BatchNorm statistics over the three steps,
each by its worst leaf (`compare.leaf_gaps`).

Parameters (`traffic_params`): places (global clouds come two a place),
pairs (local pairs), points, pool (3: the steps the reference follows),
trace_after / trace_steps (the traced stretch, in steps of the window).

End to end: `train_clouds_per_s`, the clouds of every step started in the
window (global plus both clouds of each pair) over the window's time.
"""
from __future__ import annotations

import statistics
import time

import torch

from benchmark.core import compare
from benchmark.core.cell import Outcome
from benchmark.core.train_batch import make_train_batch
from benchmark.reference import models as ref_models
from benchmark.reference import train as ref_train

BETA1 = 0.9
STEPS_COMPARED = 3


def make_batches(cell, quantizer) -> list:
    p, t = cell.traffic, cell.cfg["train"]
    if p["pool"] != STEPS_COMPARED:
        raise ValueError(f"the pool holds the {STEPS_COMPARED} steps the reference follows")
    return [make_train_batch(quantizer, cell.generator(4, i), p["places"], p["pairs"],
                             p["points"], t["rot_max"], t["trans_max"])
            for i in range(STEPS_COMPARED)]


def first_steps(cell, step, batches) -> tuple:
    """The program's first three steps: (losses, the first gradient as
    Adam took it, the state after them, the first step's stats)."""
    model, opt = step.state.model, step.state.optimizer
    losses = []
    for i, (g, l) in enumerate(batches):
        stats = step(g, l, cell.generator(5, i), cell.cfg["train"]["lr"], True)
        losses.append(stats["loss"])
        if i == 0:
            stats1 = stats
            # an optimizer that kept no moment took no gradient
            grad1 = {n: opt.state.get(q, {}).get("exp_avg", torch.zeros_like(q)) / (1 - BETA1)
                     for n, q in model.named_parameters()}
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return [float(x) for x in losses], grad1, after, {k: float(v) for k, v in stats1.items()}


def reset(step, state) -> None:
    """Put the step object's model and optimizer back to the seeded start in
    place: the weights and statistics copied into the tensors it holds,
    Adam's moments and step counts zeroed (a fresh Adam's first step)."""
    step.state.model.load_state_dict(state)
    for slots in step.state.optimizer.state.values():
        for k, v in slots.items():
            if torch.is_tensor(v):
                v.zero_()
            else:
                slots[k] = type(v)(0)


def reference_steps(cell, batches) -> tuple:
    """The reference's three steps from the seeded weights on the same
    batches and draws: (losses, first gradient, state after, work logs, the
    first step's loss parts)."""
    t = cell.cfg["train"]
    ref, quantizer, spec = cell.reference()
    adam = ref_train.Adam(dict(ref.named_parameters()), t["lr"], t["weight_decay"])
    logs, losses = [], []
    for i, (g, l) in enumerate(batches):
        with ref_models.record_work([]) as log:
            loss, taken, step_parts = ref_train.train_step(ref, quantizer, spec, adam, g, l,
                                                           cell.generator(5, i), t)
        logs.append(log)
        losses.append(float(loss))
        if i == 0:
            grad1, parts1 = taken, step_parts
    return losses, grad1, ref.state_dict(), logs, parts1


def gaps(cell, prog: tuple, ref: tuple) -> tuple:
    """(readings, the worst leaves) of the program's three steps against the
    reference's: the first step's loss, its global (triplet) part and its
    keypoint (chamfer + point-to-point) part, every step's loss, the first
    gradient by the worst and the median leaf, the change by the worst and
    the median leaf.  The workload's `limits` name the ones compared."""
    losses, grad1, after = prog[:3]
    ref_losses, ref_grad1, ref_after = ref[:3]
    before = cell.state()
    buffers = [k for k in ref_after if k not in ref_grad1]
    leaves = compare.moved_leaves(ref_grad1, buffers)
    grad = compare.leaf_gaps(grad1, ref_grad1, ref_grad1)
    change = compare.leaf_gaps({k: after[k] - before[k] for k in leaves},
                               {k: ref_after[k] - before[k] for k in leaves}, leaves)
    parts, ref_parts = prog[-1], ref[-1]  # the first step's loss parts
    readings = {
        "loss1_gap": compare.relative(losses[0], ref_losses[0]),
        "global_loss1_gap": compare.relative(parts["global_loss"], ref_parts["global_loss"]),
        "chamfer_p2p1_gap": compare.relative(parts["loss_chamfer"] + parts["loss_p2p"],
                                             ref_parts["loss_chamfer"] + ref_parts["loss_p2p"]),
        "loss_gap": max(compare.relative(a, b) for a, b in zip(losses, ref_losses)),
        "grad_gap": max(grad.values()), "grad_gap_median": statistics.median(grad.values()),
        "change_gap": max(change.values()),
        "change_gap_median": statistics.median(change.values()),
    }
    return readings, (max(grad, key=grad.get), max(change, key=change.get))


def run(cell) -> Outcome:
    from egonn_tpu_torch.train.trainer import make_train_step

    p = cell.traffic
    built = cell.program()
    step = make_train_step(built, cell.adapter.train_params(cell.cfg))
    batches = make_batches(cell, cell.adapter.reference(cell.cfg)[1])
    cell.phase("inputs")
    prog = first_steps(cell, step, batches)
    tracer = cell.tracer
    if tracer:
        tracer.warm()
    lr = cell.cfg["train"]["lr"]
    t0 = cell.window_started()
    end = t0 + cell.seconds
    i = STEPS_COMPARED
    first_traced = STEPS_COMPARED + p["trace_after"]
    while True:
        if tracer and i == first_traced:
            tracer.start()
        g, l = batches[i % STEPS_COMPARED]
        step(g, l, cell.generator(5, i % STEPS_COMPARED), lr, True)
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
    del step, built
    cell.free()

    ref = reference_steps(cell, batches)
    readings = {}
    for name, run_ in (("set-up", prog), ("after the window", replay)):
        got, worst = gaps(cell, run_, ref)
        compare.merge_worst(readings, got)
        cell.log(f"{name}: losses {run_[0]} against {ref[0]}; readings {got}; worst grad "
                 f"leaf {worst[0]}, worst change leaf {worst[1]}")
    cell.log(f"{len(window_steps)} steps in {window_s:.3f} s; readings {readings}")
    checks = {k: readings[k] for k in cell.workload["limits"]}
    logs = ref[3]
    return Outcome(
        e2e={"train_clouds_per_s": len(window_steps) * (2 * p["places"] + 2 * p["pairs"])
             / window_s},
        attempted=len(window_steps), failed=0, checks=checks,
        traced_calls=len(traced) if tracer else 0,
        traced_records=[r for s in traced for r in logs[s % STEPS_COMPARED]])
