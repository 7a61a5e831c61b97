#!/usr/bin/env python3
"""The controls of a cell's comparison, on the card (the benchmark's runs do
not run them):

* `tf32`: the reference put in the program's place, computed in the next
  precision below the configurations' f32 (TF32 matmuls);
* `program_bf16`: the program with its own lower precision switched on
  (`EGONN_BF16_ACTS=1`: bf16 activations);
* `half_batch` (training): the reference on half of the global batch and
  of the pairs, the means taken over the rest;
* `dw_doubled`, `dw_negated` (training): the program with every weight
  gradient of its gather convs (`kernels.gather_dw`) doubled, or negated;
* `program`: the sound program, the lower reading; `look` (training):
  its first step's stats beside the reference's loss parts.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

prints one JSON line per seed and control with each compared number.  A
control is read at the cell's own sizes, on the cell's own inputs.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.core import compare, runner  # noqa: E402
from benchmark.core.cell import Cell, scratch_dir  # noqa: E402
from benchmark.reference.train import forward as ref_forward  # noqa: E402


@contextlib.contextmanager
def tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def weight_gradients_scaled(factor: float):
    from egonn_tpu_torch.sparse import kernels

    real = kernels.gather_dw
    kernels.gather_dw = lambda *args, **kwargs: factor * real(*args, **kwargs)
    try:
        yield
    finally:
        kernels.gather_dw = real


@contextlib.contextmanager
def bf16_activations():
    prev = os.environ.get("EGONN_BF16_ACTS")
    os.environ["EGONN_BF16_ACTS"] = "1"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["EGONN_BF16_ACTS"]
        else:
            os.environ["EGONN_BF16_ACTS"] = prev


def make_cell(bench_dir: Path, name: str, seed: int, device) -> tuple:
    workload, cfg, adapter, traffic = runner.load_cell(bench_dir, name)
    seconds = runner.load_json(bench_dir.parent / "BENCHMARK.json")["run_seconds"]
    cell = Cell(name, workload, cfg, adapter, seed, seconds, False, device, time.perf_counter(),
                scratch_dir(str(bench_dir.parent)))
    return cell, traffic


def forward_readings(cell, traffic) -> dict:
    inputs = traffic.control_inputs(cell)
    model, quantizer, spec = cell.reference()
    out = {"program": {}, "tf32": {}, "program_bf16": {}}
    refs = []
    with torch.no_grad():
        for clouds, mask in inputs:
            ref = ref_forward(model, quantizer, spec, clouds, mask)
            with tf32():
                low = ref_forward(model, quantizer, spec, clouds, mask)
            keys = [k for k in cell.adapter.OUTPUTS if k in ref]
            compare.merge_worst(out["tf32"], compare.output_gaps(low, ref, keys))
            refs.append((ref, keys))
        del model
        built = cell.program()
        for (clouds, mask), (ref, keys) in zip(inputs, refs):
            prog = traffic.program_outputs(cell, built, clouds, mask)
            keys = [k for k in keys if k in prog]
            compare.merge_worst(out["program"], compare.output_gaps(prog, ref, keys))
            with bf16_activations():
                low = traffic.program_outputs(cell, built, clouds, mask)
            compare.merge_worst(out["program_bf16"], compare.output_gaps(low, ref, keys))
    return out


def _halved(batches):
    out = []
    for g, l in batches:
        hg, hl = g["clouds"].shape[0] // 2, l["anc_clouds"].shape[0] // 2
        out.append(({k: (v[:hg, :hg] if k.endswith("s_mask") else v[:hg]) for k, v in g.items()},
                    {k: v[:hl] for k, v in l.items()}))
    return out


def train_readings(cell, traffic) -> dict:
    from egonn_tpu_torch.train.trainer import make_train_step

    batches = traffic.make_batches(cell, cell.adapter.reference(cell.cfg)[1])
    ref = traffic.reference_steps(cell, batches)
    out = {}
    with tf32():
        out["tf32"] = traffic.gaps(cell, traffic.reference_steps(cell, batches), ref)[0]
    out["half_batch"] = traffic.gaps(cell, traffic.reference_steps(cell, _halved(batches)), ref)[0]
    cell.free()
    for name, ctx in (("program", contextlib.nullcontext()), ("program_bf16", bf16_activations()),
                      ("dw_doubled", weight_gradients_scaled(2.0)),
                      ("dw_negated", weight_gradients_scaled(-1.0))):
        with ctx:
            built = cell.program()
            step = make_train_step(built, cell.adapter.train_params(cell.cfg))
            prog = traffic.first_steps(cell, step, batches)
            out[name] = traffic.gaps(cell, prog, ref)[0]
        if name == "program":  # the first step's loss, part by part
            out["look"] = {k: [prog[3][k], v] for k, v in ref[4].items()}
        del built, step
        cell.free()
    return out


def readings(bench_dir: Path, name: str, seed: int, device) -> dict:
    cell, traffic = make_cell(bench_dir, name, seed, device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if hasattr(traffic, "reference_steps"):
        return train_readings(cell, traffic)
    return forward_readings(cell, traffic)


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the controls are read on a CUDA card", file=sys.stderr)
        return 3
    bench_dir = Path(__file__).resolve().parent
    limits = runner.load_json(bench_dir / "workloads" / f"{args.workload}.json")["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        for control, values in readings(bench_dir, args.workload, seed,
                                        torch.device("cuda", 0)).items():
            failed = sorted(k for k, v in values.items()
                            if k in limits and not isinstance(v, list) and v > limits[k])
            print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                              "values": values, "over_limit": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
