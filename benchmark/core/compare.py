"""The numbers that decide `correct`: gaps between what the program produced
and what the reference computes from the same inputs."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable

import torch


def output_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                keys: Iterable[str]) -> Dict[str, float]:
    """Per output: the widest gap of any cloud, max |prog - ref| over the
    cloud's max |ref|; for `kp_mask` the count of rows that differ."""
    out = {}
    for key in keys:
        p, r = prog[key].to(ref[key].device), ref[key]
        if key == "kp_mask":
            out["kp_mask_mismatches"] = float((p != r).sum())
            continue
        p, r = p.float().flatten(1), r.float().flatten(1)
        scale = r.abs().amax(1).clamp_min(1e-30)
        out[f"{key}_gap"] = float(((p - r).abs().amax(1) / scale).max())
    return out


def merge_worst(into: Dict[str, float], new: Dict[str, float]) -> Dict[str, float]:
    for k, v in new.items():
        into[k] = max(into.get(k, v), v)
    return into


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Iterable[str]) -> Dict[str, float]:
    """Per leaf: |norm(prog) - norm(ref)| over the larger of the leaf's
    reference norm and the median leaf's."""
    names = list(names)
    ref_n = {n: float(torch.linalg.vector_norm(ref[n].float())) for n in names}
    prog_n = {n: float(torch.linalg.vector_norm(prog[n].float())) for n in names}
    median = statistics.median(ref_n.values())
    return {n: abs(prog_n[n] - ref_n[n]) / max(ref_n[n], median, 1e-30) for n in names}


def moved_leaves(ref_grads: Dict[str, torch.Tensor], buffers: Iterable[str]) -> list:
    """The leaves whose change is compared: parameters whose reference
    gradient is at least a thousandth of the median leaf's (smaller ones
    move under Adam by round-off alone), and the BatchNorm statistics."""
    norms = {n: float(torch.linalg.vector_norm(g.float())) for n, g in ref_grads.items()}
    floor = 1e-3 * statistics.median(norms.values())
    return sorted([n for n, v in norms.items() if v >= floor] + list(buffers))


def relative(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)
