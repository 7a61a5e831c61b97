"""Data-parallel dry run (the counterpart of `__graft_entry__.dryrun_multichip`):
one combined train step (global triplet + local 6DoF halves) of EgoNN on
tiny shapes across N ranks, held against the single-process step on the
same batch and the same initial weights.

    python -m egonn_tpu_torch.parallel.dryrun N [--device cpu|cuda] [--backend gloo|nccl]

The batch: 2 clouds of 1,024 points per rank (places of two scans) and one
cloud pair per rank (`data/train_batch.py`), cap0 512, the training
parameters of config/config_egonn.txt, augmentation on (the ranks take
their rows of the global draws).  It prints the loss, global and local, of
both runs and exits non-zero unless every stat agrees within rel 1e-4, every
gradient within 1e-3 of its leaf's max |grad|, and the ranks' parameters,
BatchNorm statistics and Adam state are bit-equal after the step.  On the
CPU it runs gloo ranks; `--device cuda` defaults to NCCL (one card per
rank); `--device cuda --backend gloo` shares one card between the ranks.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CAP0, N_POINTS, LR = 512, 1024, 1e-3
STAT_REL_TOL, GRAD_REL_TOL = 1e-4, 1e-3


def rows_of(batch: Dict[str, np.ndarray], keys, group) -> Dict[str, np.ndarray]:
    """The rank's rows of the batch's `keys` (the others whole)."""
    from egonn_tpu_torch.parallel.mesh import row_slice

    return {k: np.ascontiguousarray(v[row_slice(len(v), group)]) if k in keys else v
            for k, v in batch.items()}


def rank_step(group, params, cap0: int, model_seed: int, g: Dict[str, np.ndarray],
              l: Dict[str, np.ndarray], gen_seed: Optional[int], lr: float, device="cpu"
              ) -> dict:
    """One train step of a fresh EgoNN (seeded weights) on
    this rank's rows of the global batch g and the pairs l (numpy, whole),
    augmentation drawn from a generator seeded gen_seed (None: off).
    Returns numpy: `stats`, `grads`, `state` (parameters and BatchNorm
    statistics after the step), `adam` (each parameter's moments) and the
    step's kernel `launches`."""
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.parallel.mesh import rank_device
    from egonn_tpu_torch.sparse import kernels
    from egonn_tpu_torch.train.trainer import make_train_step

    device = rank_device(device, group)
    built = create_egonn_model(params.model_params, cap0=cap0, device=device, seed=model_seed)
    step = make_train_step(built, params, group)
    to = lambda d: {k: torch.from_numpy(v).to(device) for k, v in d.items()}  # noqa: E731
    gd = to(rows_of(g, ("clouds", "point_mask"), group))
    ld = to(rows_of(l, tuple(l), group))
    gen = (torch.Generator(device=device).manual_seed(gen_seed)
           if gen_seed is not None else None)
    kernels.reset_launches()
    stats = step(gd, ld, gen, lr, True)
    model = built.model
    adam = step.state.optimizer.state
    return dict(
        stats={k: float(v) for k, v in stats.items()},
        grads={n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()
               if p.grad is not None},
        state={k: v.detach().cpu().numpy() for k, v in model.state_dict().items()},
        adam={n: [adam[p][k].detach().cpu().numpy() for k in ("exp_avg", "exp_avg_sq")]
              for n, p in model.named_parameters() if p in adam},
        launches=kernels.launch_counts())


def compare(single: dict, ranks: list, stat_rel: float = STAT_REL_TOL,
            grad_rel: float = GRAD_REL_TOL) -> dict:
    """The ranks' step against the single-process step: the worst stat's
    relative difference, the worst gradient leaf's max abs difference over
    its max |grad| (rank 0's gradients: every rank holds the summed ones),
    and whether every rank's state and Adam moments equal rank 0's bit for
    bit.  `ok` when all hold."""
    stats = max(abs(ranks[0]["stats"][k] - v) / max(abs(v), 1e-12)
                for k, v in single["stats"].items())
    grads = max(float(np.abs(ranks[0]["grads"][n] - w).max() / max(np.abs(w).max(), 1e-30))
                for n, w in single["grads"].items())
    same = all(set(r["stats"]) == set(single["stats"]) and set(r["grads"]) == set(single["grads"])
               for r in ranks)
    equal = all(all(np.array_equal(r["state"][k], v) for k, v in ranks[0]["state"].items())
                and all(all(np.array_equal(a, b) for a, b in zip(r["adam"][n], m))
                        for n, m in ranks[0]["adam"].items())
                for r in ranks[1:])
    return dict(stats_rel=stats, grads_rel=grads, ranks_bit_equal=equal,
                ok=same and equal and stats <= stat_rel and grads <= grad_rel)


def dryrun(n: int, device="cpu", backend: Optional[str] = None, timeout_s: float = 600.0
           ) -> dict:
    """The dry run on n ranks: (single, ranks, compare's verdict)."""
    from egonn_tpu_torch.config import TrainingParams
    from egonn_tpu_torch.data.train_batch import make_train_batch
    from egonn_tpu_torch.parallel import dryrun as this  # pickles by module name
    from egonn_tpu_torch.parallel.mesh import run_ranks

    params = TrainingParams(os.path.join(ROOT, "config", "config_egonn.txt"),
                            os.path.join(ROOT, "model_configs", "egonn.txt"),
                            require_dataset=False)
    params.model_params.cap0 = CAP0
    params.local_batch_size = n
    built_q = params.model_params.quantizer
    g, l = make_train_batch(params, built_q, "cpu", n_places=n, n_points=N_POINTS, seed=0)
    g = {k: v.numpy() for k, v in g.items()}
    l = {k: v.numpy() for k, v in l.items()}
    args = (params, CAP0, 1, g, l, 3, LR, device)
    t0 = time.perf_counter()
    single = this.rank_step(None, *args)
    t1 = time.perf_counter()
    ranks = run_ranks(this.rank_step, n, args, device=device, backend=backend,
                      timeout_s=timeout_s)
    t2 = time.perf_counter()
    verdict = compare(single, ranks)
    verdict.update(single_s=t1 - t0, ranks_s=t2 - t1)
    return dict(single=single, ranks=ranks, verdict=verdict)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Data-parallel dry run of one EgoNN train step")
    parser.add_argument("n", type=int, nargs="?", default=2, help="ranks (default 2)")
    parser.add_argument("--device", default="cpu", help="cpu (default) or cuda")
    parser.add_argument("--backend", default=None, help="gloo or nccl (default: the device's)")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="seconds a rank may wait in a collective or to end")
    args = parser.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("dryrun: CUDA is not available", file=sys.stderr)
        return 1
    out = dryrun(args.n, args.device, args.backend, args.timeout)
    s, r, v = out["single"]["stats"], out["ranks"][0]["stats"], out["verdict"]
    print(f"single process: loss={s['loss']:.6f} global={s['global_loss']:.6f} "
          f"local={s['local_loss']:.6f} ({v['single_s']:.1f} s)")
    print(f"dryrun({args.n} ranks, {args.device}) loss={r['loss']:.6f} "
          f"global={r['global_loss']:.6f} local={r['local_loss']:.6f} ({v['ranks_s']:.1f} s)")
    print(f"stats rel {v['stats_rel']:.3g} (<= {STAT_REL_TOL}), gradients max abs err / leaf "
          f"max {v['grads_rel']:.3g} (<= {GRAD_REL_TOL}), ranks bit-equal after the step "
          f"{v['ranks_bit_equal']}; launches per rank {out['ranks'][0]['launches']}")
    print("OK" if v["ok"] else "FAILED")
    return 0 if v["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
