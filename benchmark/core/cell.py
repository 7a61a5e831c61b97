"""One run of one cell: what a traffic module (`traffic/<kind>.py`) is handed,
and what it hands back.

A traffic module's `run(cell) -> Outcome` builds the program's model through
the configuration's adapter (`models/<config>.py`) with `cell.program()`,
makes its inputs from `cell.generator(...)`, warms up every shape it will
use, calls `cell.window_started()` and measures for `cell.seconds`; with
`cell.trace` it profiles a short stretch of the window (`cell.tracer`).
Once the window has closed it calls `cell.read_peak()`, frees the
program's state, runs the reference on what it compared (`cell.reference()`)
and returns the numbers compared, which the workload's `limits` judge.
"""
from __future__ import annotations

import gc
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from benchmark.core import scans, weights
from benchmark.core.trace import Tracer
from benchmark.reference import models as ref_models


@dataclass
class Outcome:
    e2e: Dict[str, float]                 # end-to-end metrics of the window (not setup_s)
    attempted: int
    failed: int
    checks: Dict[str, float]              # numbers compared, by name
    traced_calls: int = 0
    traced_records: List[dict] = field(default_factory=list)


class Cell:
    def __init__(self, name: str, workload: dict, cfg: dict, adapter, seed: int,
                 seconds: float, trace: bool, device: torch.device, t_start: float,
                 scratch: str):
        self.name, self.workload, self.cfg, self.adapter = name, workload, cfg, adapter
        self.traffic = workload["traffic_params"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.setup_s: Optional[float] = None
        self.peak_bytes = 0
        self.tracer = Tracer(device, scratch) if trace else None
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._phases: List[tuple] = [("start", t_start), ("imports", time.perf_counter())]

    def phase(self, name: str) -> None:
        """Mark the end of a phase of set-up (logged when the window starts)."""
        self._phases.append((name, time.perf_counter()))

    # -- inputs -------------------------------------------------------------
    def generator(self, *words: int) -> torch.Generator:
        return scans.generator(self.device, self.seed, *words)

    def state(self) -> Dict[str, torch.Tensor]:
        """The seeded weights of the configuration, made once."""
        if self._state is None:
            model, _, _ = self.adapter.reference(self.cfg)
            shapes = {k: v.shape for k, v in model.state_dict().items()}
            self._state = weights.seeded_state(shapes, ref_models.param_kinds(model),
                                               self.seed, self.device)
        return self._state

    def program(self):
        """The program's model (eval mode) with the seeded weights."""
        built = self.adapter.program(self.cfg, self.device)
        built.model.load_state_dict(self.state())
        self.phase("model")
        return built

    def reference(self):
        """(model, quantizer, pyramid spec) of the reference on the device,
        with the same weights, in eval mode."""
        model, quantizer, spec = self.adapter.reference(self.cfg)
        model.load_state_dict(self.state())
        return model.to(self.device).eval(), quantizer, spec

    # -- the window ---------------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_started(self) -> float:
        """Marks the end of set-up; returns the window's start on the host
        clock."""
        self.sync()
        gc.collect()
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        self._phases.append(("warm-up", now))
        self.log("set-up s: " + ", ".join(f"{name} {t - prev:.3f}" for (_, prev), (name, t)
                                          in zip(self._phases, self._phases[1:])))
        return now

    def read_peak(self) -> None:
        if self.device.type == "cuda":
            self.sync()
            self.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def scratch_dir(root: str) -> str:
    return os.path.join(root, "build", "portbench")
