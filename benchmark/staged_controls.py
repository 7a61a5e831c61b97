#!/usr/bin/env python3
"""The readings behind `minkloc3dv2.train-b2048`'s limits, on the card (the
benchmark's runs do not run them).  Per seed, each of the cell's compared
numbers (`traffic/staged_train.py::gaps`) for:

* `program`: the sound program, the lower reading;
* `tf32`: the reference put in the program's place, computed in the next
  precision below the configuration's f32 (TF32 matmuls);
* `half_batch`: the reference on the first half of each global batch (its
  masks cut to those clouds), the means taken over the rest; its
  embeddings are held against the full batch's first half;
* faults planted in the program (`FAULTS`): `bn_stage3_only` (BatchNorm's
  running statistics left unmoved by stage 1), `fresh_draw` (stage 3 on
  another augmentation draw than stage 1), `rotated_grad` (each chunk
  backpropagates the next chunk's slice of the embedding gradient),
  `tau_doubled` (the loss at twice tau1), `dw_doubled` and `dw_negated`
  (every weight gradient of the gather convs doubled or negated, as
  `control.py` plants them in the other training cell).

`control.py`, which reads every other cell's controls, does not know this
traffic (it halves local batches the staged step has none of, and reads
the train step's stats); these are this cell's.

    python3 benchmark/staged_controls.py --seeds 1,2,3 [--only program,tf32]
    python3 benchmark/staged_controls.py --seeds 1,2,3 --capacities [--fit 8]

prints one JSON line per seed and reading.  `--capacities` prints instead
each level's worst voxel count over the pool's augmented chunks of each
seed, and with `--fit N` the capacity table `sparse/calibrate.py` fits on
the first N seeds' submaps.
"""
from __future__ import annotations

import contextlib
import json
import sys
from functools import partial
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.control import make_cell, tf32, weight_gradients_scaled  # noqa: E402

CELL = "minkloc3dv2.train-b2048"


@contextlib.contextmanager
def _patched(name: str, make):
    """StagedTrainStep.<name> replaced by make(the real one) for the block."""
    from egonn_tpu_torch.train.trainer import StagedTrainStep

    real = getattr(StagedTrainStep, name)
    setattr(StagedTrainStep, name, make(real))
    try:
        yield
    finally:
        setattr(StagedTrainStep, name, real)


def bn_stage3_only():
    """Stage 1 leaves BatchNorm's running statistics where they were."""
    def make(real):
        def _embed(self, clouds, mask, train):
            bufs = dict(self.state.model.named_buffers())
            saved = {k: v.clone() for k, v in bufs.items()}
            out = real(self, clouds, mask, train)
            for k, v in saved.items():
                bufs[k].copy_(v)
            return out
        return _embed
    return _patched("_embed", make)


def fresh_draw():
    """Stage 3 runs the clouds under another augmentation draw than stage 1."""
    from egonn_tpu_torch.data.pipeline import augment_global, device_preprocess_global

    seen = {}

    def make_call(real):
        def call(self, g, l, gen, lr, train):
            seen["g"] = g
            return real(self, g, l, gen, lr, train)
        return call

    def make_backprop(real):
        def _backprop(self, pyramids, grad):
            g, b = seen["g"], self.built
            gen = torch.Generator(device=b.device).manual_seed(987654321)
            clouds = augment_global(g["clouds"], g["point_mask"], gen, self.aug_mode,
                                    dataset=self.dataset)
            pyramids = [device_preprocess_global(clouds[at:at + self.split],
                                                 g["point_mask"][at:at + self.split],
                                                 b.quantizer, b.pyramid_spec,
                                                 with_kmap_down=True)
                        for at in range(0, clouds.shape[0], self.split)]
            return real(self, pyramids, grad)
        return _backprop

    stack = contextlib.ExitStack()
    stack.enter_context(_patched("__call__", make_call))
    stack.enter_context(_patched("_backprop", make_backprop))
    return stack


def rotated_grad():
    """Each chunk backpropagates the next chunk's slice of the embedding
    gradient."""
    def make(real):
        def _backprop(self, pyramids, grad):
            return real(self, pyramids, torch.roll(grad, -self.split, 0))
        return _backprop
    return _patched("_backprop", make)


def tau_doubled():
    """The loss at twice tau1."""
    from egonn_tpu_torch.losses.smoothap import truncated_smooth_ap

    def make(real):
        def init(self, built, params, group=None):
            real(self, built, params, group)
            self.loss_fn = partial(truncated_smooth_ap, tau1=2 * params.tau1,
                                   k=params.positives_per_query, similarity=params.similarity)
        return init
    return _patched("__init__", make)


FAULTS = {"bn_stage3_only": bn_stage3_only, "fresh_draw": fresh_draw,
          "rotated_grad": rotated_grad, "tau_doubled": tau_doubled,
          "dw_doubled": partial(weight_gradients_scaled, 2.0),
          "dw_negated": partial(weight_gradients_scaled, -1.0)}
REFERENCE_CONTROLS = ("tf32", "half_batch")


def halved(batches) -> list:
    """Each global batch cut to its first half of clouds."""
    out = []
    for g in batches:
        h = g["clouds"].shape[0] // 2
        out.append({k: (v[:h, :h] if k.endswith("s_mask") else v[:h]) for k, v in g.items()})
    return out


def program_run(cell, traffic, batches) -> tuple:
    from egonn_tpu_torch.train.trainer import make_train_step

    built = cell.program()
    step = make_train_step(built, cell.adapter.train_params(cell.cfg))
    out = traffic.first_steps(cell, step, batches)
    del step, built
    cell.free()
    return out


def readings(bench_dir: Path, seed: int, device, only=None) -> dict:
    """{reading: {compared number: value}} of one seed."""
    cell, traffic = make_cell(bench_dir, CELL, seed, device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    batches = traffic.make_batches(cell)
    wanted = only or ["program", *REFERENCE_CONTROLS, *FAULTS]
    prog = {}
    for name in wanted:
        if name in REFERENCE_CONTROLS:
            continue
        with FAULTS[name]() if name in FAULTS else contextlib.nullcontext():
            prog[name] = program_run(cell, traffic, batches)
    ref = traffic.reference_steps(cell, batches)
    out = {name: traffic.gaps(cell, p, ref)[0] for name, p in prog.items()}
    if "tf32" in wanted:
        with tf32():
            low = traffic.reference_steps(cell, batches)
        out["tf32"] = traffic.gaps(cell, low[:5], ref)[0]
    if "half_batch" in wanted:
        low = traffic.reference_steps(cell, halved(batches))
        first_half = (*ref[:3], ref[3][:low[3].shape[0]], *ref[4:])
        out["half_batch"] = traffic.gaps(cell, low[:5], first_half)[0]
    cell.free()
    return out


def capacities(bench_dir: Path, seeds, device, fit: int = 0) -> None:
    from egonn_tpu_torch.sparse.calibrate import calibrate_capacities

    library = []
    for seed in seeds:
        cell, traffic = make_cell(bench_dir, CELL, seed, device)
        batches = traffic.make_batches(cell)
        built = cell.program()
        dropped, worst = traffic.dropped_voxels(cell, built, batches)
        print(json.dumps({"seed": seed, "worst": worst, "dropped": dropped,
                          "capacities": list(built.pyramid_spec.capacities)}), flush=True)
        if len(library) < fit:
            library.append(torch.cat([g["clouds"] for g in batches]))
    if fit:
        clouds = torch.cat(library)
        table = calibrate_capacities(clouds, torch.ones(clouds.shape[:2], dtype=torch.bool),
                                     built.quantizer, built.pyramid_spec, batch=128,
                                     device=device)
        print(json.dumps({"fit_on_seeds": list(seeds)[:fit], "clouds": clouds.shape[0],
                          "table": list(table)}), flush=True)


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--only", default="")
    ap.add_argument("--capacities", action="store_true")
    ap.add_argument("--fit", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card", file=sys.stderr)
        return 3
    bench_dir = Path(__file__).resolve().parent
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.capacities:
        capacities(bench_dir, seeds, device, args.fit)
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
