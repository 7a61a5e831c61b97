"""Closed-loop segmentation: one client, each call `inference.forward(built,
clouds, mask, feats=feats)` on a batch of `lidar_sim` scans already on the
device, with per-point features x, y, z, intensity, a pool of distinct
batches cycled in order; the program returns per-point logits.

Parameters (`traffic_params`): batch, points, pool (distinct batches),
scene_seed (the scans' library and their intensities), warmup_calls,
trace_after / trace_calls (the traced stretch, in calls of the window),
kept_calls (outputs kept for the comparison: the first call of each batch,
then calls drawn from the seed).

End to end: `clouds_per_s`, every cloud of every call started in the window
over the window's time (closed by a synchronize).  Compared: every kept
call's outputs against the reference's on its batch, computed one cloud at
a time (`gaps`): `logits_gap`, the widest gap of any cloud (max |prog -
ref| over the cloud's max |ref|; a point without a voxel is zero on both
sides), and `point_mask_mismatches`, the points whose mask differs; and
`dropped_voxels`, the voxels beyond a level's capacity in the program's
pyramids of the pool's batches (the batch's worst cloud a level, summed).
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from benchmark.core import compare, scans
from benchmark.core.cell import Outcome
from benchmark.reference import minkunet as ref_minkunet
from benchmark.reference import models as ref_models


def make_inputs(cell) -> tuple:
    """([(clouds (B, N, 3), feats (B, N, 4))] of the pool's batches, their
    point mask), on the device: one library of pool x batch scans and their
    intensities made from the workload's `scene_seed`, dealt into batches
    in an order drawn from the run's seed, so that every seed gives the
    device the same work."""
    p = cell.traffic
    n_scans, shape = p["pool"] * p["batch"], (p["pool"], p["batch"], p["points"])
    gen = scans.generator(cell.device, p["scene_seed"], 2)
    library = scans.lidar_scans(n_scans, p["points"], gen)
    intensity = torch.rand((n_scans, p["points"], 1), generator=gen, device=cell.device)
    feats = torch.cat([library, intensity], -1)
    order = torch.randperm(n_scans, generator=cell.generator(2), device=cell.device)
    batches = list(zip(library[order].reshape(*shape, 3), feats[order].reshape(*shape, 4)))
    return batches, torch.ones(shape[1:], dtype=torch.bool, device=cell.device)


def program_outputs(built, clouds, mask, feats) -> dict:
    from egonn_tpu_torch import inference

    return inference.forward(built, clouds, mask, feats=feats)


def merged(logs: List[List[dict]]) -> List[dict]:
    """The work records of one batch from its clouds' (the same products in
    the same order): the batch and the valid entries summed."""
    if any(len(log) != len(logs[0]) for log in logs):
        raise ValueError("the clouds' work records differ in number")
    return [dict(rs[0], b=sum(r["b"] for r in rs), nnz=sum(r["nnz"] for r in rs))
            for rs in zip(*logs)]


def reference_outputs(model, quantizer, spec, clouds, mask, feats) -> tuple:
    """(the reference's outputs on a batch, computed one cloud at a time,
    and the batch's work records)."""
    outs, logs = [], []
    with torch.no_grad():
        for i in range(clouds.shape[0]):
            rows = slice(i, i + 1)
            with ref_models.record_work([]) as log:
                outs.append(ref_minkunet.forward(model, quantizer, spec, clouds[rows],
                                                 mask[rows], feats[rows]))
            logs.append(log)
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}, merged(logs)


def gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    out = compare.output_gaps(prog, ref, ["logits"])
    out["point_mask_mismatches"] = float(
        (prog["point_mask"].to(ref["point_mask"].device) != ref["point_mask"]).sum())
    return out


def dropped_voxels(built, batches, mask) -> tuple:
    """(voxels beyond a level's capacity, the worst cloud of each level of
    each batch, summed; the worst count of each level)."""
    from egonn_tpu_torch.sparse.pyramid import build_pyramid, capacity_report

    spec = built.pyramid_spec
    dropped, worst = 0, {}
    with torch.no_grad():
        for clouds, _ in batches:
            res = built.quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False,
                                           pack=spec.pack)
            pyr = build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys,
                                n_unique0=res.n_unique)
            for level, (n, cap, _) in capacity_report(pyr, spec).items():
                dropped += max(0, n - cap)
                worst[level] = max(worst.get(level, 0), n)
    return dropped, worst


def run(cell) -> Outcome:
    p = cell.traffic
    b, pool = p["batch"], p["pool"]
    built = cell.program()
    batches, mask = make_inputs(cell)
    cell.phase("inputs")
    rng = random.Random(cell.seed)
    tracer = cell.tracer
    kept = []
    with torch.no_grad():
        for i in range(p["warmup_calls"]):
            clouds, feats = batches[i % pool]
            program_outputs(built, clouds, mask, feats)
        if tracer:
            tracer.warm()
        t0 = cell.window_started()
        end = t0 + cell.seconds
        calls = 0
        while True:
            if tracer and calls == p["trace_after"]:
                tracer.start()
            clouds, feats = batches[calls % pool]
            out = program_outputs(built, clouds, mask, feats)
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
    dropped, worst = dropped_voxels(built, batches, mask)
    del built, out
    cell.free()

    model, quantizer, spec = cell.reference()
    logs, checks = [], {}
    for j, (clouds, feats) in enumerate(batches):
        ref, log = reference_outputs(model, quantizer, spec, clouds, mask, feats)
        logs.append(log)
        for k, out in kept:
            if k == j:
                compare.merge_worst(checks, gaps(out, ref))
    checks["dropped_voxels"] = float(dropped)
    cell.log(f"{calls} calls of {b} clouds in {window_s:.3f} s; {len(kept)} compared; "
             f"worst voxels a level {worst}")
    return Outcome(
        e2e={"clouds_per_s": calls * b / window_s}, attempted=calls * b, failed=0,
        checks=checks, traced_calls=len(traced) if tracer else 0,
        traced_records=[r for i in traced for r in logs[i % pool]])
