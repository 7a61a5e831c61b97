"""Closed-loop embedding: one client, each call `inference.forward(built,
clouds, mask, with_local)` on a batch of `lidar_sim` scans already on the
device, a pool of distinct batches cycled in order.

Parameters (`traffic_params`): batch, points, pool (distinct batches),
scene_seed (the scans' library), with_local, warmup_calls, trace_after /
trace_calls (the traced stretch, in calls of the window), kept_calls
(outputs kept for the comparison: the first call of each batch, then calls
drawn from the seed).

End to end: `clouds_per_s`, every cloud of every call started in the window
over the window's time (closed by a synchronize).  Compared: every kept
call's outputs against the reference's on its batch (`compare.output_gaps`).
"""
from __future__ import annotations

import random
import time

import torch

from benchmark.core import compare, scans
from benchmark.core.cell import Outcome
from benchmark.reference import models as ref_models
from benchmark.reference.train import forward as ref_forward


def make_inputs(cell) -> tuple:
    """(the pool's batches of scans, their point mask), on the device: one
    library of pool x batch scans made from the workload's `scene_seed`,
    dealt into batches in an order drawn from the run's seed, so that every
    seed gives the device the same work."""
    p = cell.traffic
    n_scans = p["pool"] * p["batch"]
    library = scans.lidar_scans(n_scans, p["points"],
                          scans.generator(cell.device, p["scene_seed"], 2))
    order = torch.randperm(n_scans, generator=cell.generator(2), device=cell.device)
    batches = list(library[order].reshape(p["pool"], p["batch"], p["points"], 3))
    return batches, torch.ones(batches[0].shape[:2], dtype=torch.bool, device=cell.device)


def control_inputs(cell) -> list:
    batches, mask = make_inputs(cell)
    cell.phase("inputs")
    return [(clouds, mask) for clouds in batches]


def program_outputs(cell, built, clouds, mask) -> dict:
    from egonn_tpu_torch import inference

    return inference.forward(built, clouds, mask, with_local=cell.traffic["with_local"])


def run(cell) -> Outcome:
    from egonn_tpu_torch import inference

    p = cell.traffic
    b, pool, with_local = p["batch"], p["pool"], p["with_local"]
    built = cell.program()
    batches, mask = make_inputs(cell)
    rng = random.Random(cell.seed)
    tracer = cell.tracer
    kept = []
    with torch.no_grad():
        for i in range(p["warmup_calls"]):
            inference.forward(built, batches[i % pool], mask, with_local=with_local)
        if tracer:
            tracer.warm()
        t0 = cell.window_started()
        end = t0 + cell.seconds
        calls = 0
        while True:
            if tracer and calls == p["trace_after"]:
                tracer.start()
            out = inference.forward(built, batches[calls % pool], mask, with_local=with_local)
            if calls < pool or (len(kept) < p["kept_calls"] and rng.random() < 0.05):
                kept.append((calls % pool, out))
            calls += 1
            if tracer and tracer.active and calls == p["trace_after"] + p["trace_calls"]:
                tracer.stop()
            if time.perf_counter() >= end:
                break
        cell.sync()
        window_s = time.perf_counter() - t0
        if tracer and tracer.active:
            tracer.stop()
    traced = range(p["trace_after"], min(calls, p["trace_after"] + p["trace_calls"]))
    cell.read_peak()
    del built, out
    cell.free()

    model, quantizer, spec = cell.reference()
    logs, gaps = [], {}
    with torch.no_grad():
        for j in range(pool):
            with ref_models.record_work([]) as log:
                ref = ref_forward(model, quantizer, spec, batches[j], mask)
            logs.append(log)
            for k, out in kept:
                if k == j:
                    keys = [x for x in cell.adapter.OUTPUTS if x in out]
                    compare.merge_worst(gaps, compare.output_gaps(out, ref, keys))
    cell.log(f"{calls} calls of {b} clouds in {window_s:.3f} s; {len(kept)} compared")
    return Outcome(
        e2e={"clouds_per_s": calls * b / window_s}, attempted=calls * b, failed=0,
        checks=gaps, traced_calls=len(traced) if tracer else 0,
        traced_records=[r for i in traced for r in logs[i % pool]])
