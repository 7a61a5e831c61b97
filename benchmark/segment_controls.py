#!/usr/bin/env python3
"""The readings behind `minkunet34c.segment-b8`'s limits, on the card (the
benchmark's runs do not run them).  Per seed, the cell's compared numbers
(`traffic/segment.py::gaps`) over the pool's batches for:

* `program`: the sound program, the lower reading;
* `tf32`: the reference put in the program's place, computed in the next
  precision below the configuration's f32 (TF32 matmuls);
* faults planted in the program (`FAULTS`): `concat_swapped` (the
  decoder's concatenation with the encoder's features first),
  `first_27_offsets` (level 0's 3^3 map taken as the first 27 columns of
  the 5^3 map instead of its centre cube), `inverse_shifted` (each point
  takes the voxel after its own).

    python3 benchmark/segment_controls.py --seeds 1,2,3 [--only program,tf32]
    python3 benchmark/segment_controls.py --seeds 1 --capacities [--fit 0,1,2,3]

prints one JSON line per seed and reading.  `--capacities` prints instead
each level's worst voxel count over the cell's library, and with `--fit`
the capacity table `sparse/calibrate.py` fits on the libraries of those
scene seeds.
"""
from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.control import make_cell, tf32  # noqa: E402

CELL = "minkunet34c.segment-b8"


@contextlib.contextmanager
def _patched(module, name: str, replacement):
    real = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, real)


def concat_swapped():
    """The decoder concatenates the encoder's features first."""
    from egonn_tpu_torch.models import minkunet

    return _patched(minkunet, "skip_concat", lambda up, skip: torch.cat([skip, up], dim=-1))


def first_27_offsets():
    """Level 0's 3^3 map is the first 27 columns of the stem's 5^3 map."""
    from egonn_tpu_torch.sparse import pyramid

    return _patched(pyramid, "_block_map",
                    lambda kmap, k_stem, k_block: kmap[:, :k_block ** 3].contiguous())


def inverse_shifted():
    """Each point with a voxel takes the next voxel row (the last keeps its
    own)."""
    from egonn_tpu_torch.ops import quantization

    real = quantization.sorted_unique

    def sorted_unique(*args, **kwargs):
        res = real(*args, **kwargs)
        if not hasattr(res, "inverse"):
            return res
        cap = res.keys.shape[-1]
        inv = res.inverse
        return res._replace(inverse=torch.where(inv < cap, (inv + 1).clamp(max=cap - 1), inv))

    return _patched(quantization, "sorted_unique", sorted_unique)


FAULTS = {"concat_swapped": concat_swapped, "first_27_offsets": first_27_offsets,
          "inverse_shifted": inverse_shifted}


def readings(bench_dir: Path, seed: int, device, only=None) -> dict:
    """{reading: {compared number: value}} of one seed: the worst over the
    pool's batches."""
    from benchmark.core import compare

    cell, traffic = make_cell(bench_dir, CELL, seed, device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    batches, mask = traffic.make_inputs(cell)
    wanted = only or ["program", "tf32", *FAULTS]
    prog = {}
    built = cell.program()
    for name in wanted:
        if name == "tf32":
            continue
        with FAULTS[name]() if name in FAULTS else contextlib.nullcontext():
            prog[name] = [traffic.program_outputs(built, c, mask, f) for c, f in batches]
    del built
    cell.free()
    model, quantizer, spec = cell.reference()
    out = {}
    for j, (clouds, feats) in enumerate(batches):
        ref, _ = traffic.reference_outputs(model, quantizer, spec, clouds, mask, feats)
        for name, outs in prog.items():
            compare.merge_worst(out.setdefault(name, {}), traffic.gaps(outs[j], ref))
        if "tf32" in wanted:
            with tf32():
                low, _ = traffic.reference_outputs(model, quantizer, spec, clouds, mask, feats)
            compare.merge_worst(out.setdefault("tf32", {}), traffic.gaps(low, ref))
    cell.free()
    return out


def capacities(bench_dir: Path, seed: int, device, fit) -> None:
    from benchmark.core import scans
    from egonn_tpu_torch.sparse.calibrate import calibrate_capacities

    cell, traffic = make_cell(bench_dir, CELL, seed, device)
    batches, mask = traffic.make_inputs(cell)
    built = cell.program()
    dropped, worst = traffic.dropped_voxels(built, batches, mask)
    print(json.dumps({"seed": seed, "worst": worst, "dropped": dropped,
                      "capacities": list(built.pyramid_spec.capacities)}), flush=True)
    if fit:
        p = cell.traffic
        clouds = torch.cat([scans.lidar_scans(p["pool"] * p["batch"], p["points"],
                                              scans.generator(device, s, 2)) for s in fit])
        spec = built.pyramid_spec
        table = calibrate_capacities(clouds, torch.ones(clouds.shape[:2], dtype=torch.bool),
                                     built.quantizer, spec, batch=p["batch"], device=device)
        print(json.dumps({"fit_on_scene_seeds": fit, "clouds": clouds.shape[0],
                          "table": list(table)}), flush=True)


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--only", default="")
    ap.add_argument("--capacities", action="store_true")
    ap.add_argument("--fit", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card", file=sys.stderr)
        return 3
    bench_dir = Path(__file__).resolve().parent
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.capacities:
        capacities(bench_dir, seeds[0], device, [int(s) for s in args.fit.split(",") if s])
        return 0
    limits = json.loads((bench_dir / "workloads" / f"{CELL}.json").read_text())["limits"]
    only = [s for s in args.only.split(",") if s] or None
    for seed in seeds:
        for name, values in readings(bench_dir, seed, device, only).items():
            over = sorted(k for k, v in values.items() if k in limits and v > limits[k])
            print(json.dumps({"seed": seed, "reading": name, "values": values,
                              "over_limit": over}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
