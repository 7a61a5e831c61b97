"""Metrics log of training (port of `egonn_tpu/utils/logging.py`): an
append-only JSONL file, one metrics dict per line with a wall-clock `_ts`,
mirrored to Weights & Biases (the reference's sink, training/trainer.py,
project EgoNN_GL) when WANDB_API_KEY is set and `wandb` imports.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, out_dir: str, run_name: str, config: Optional[Dict] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{run_name}.metrics.jsonl")
        self._fh = open(self.path, "a")
        self._wandb = None
        if os.environ.get("WANDB_API_KEY"):
            try:
                import wandb  # type: ignore

                wandb.init(project="EgoNN_GL", name=run_name, config=config or {})
                self._wandb = wandb
            except Exception as e:  # the JSONL file stays the record
                print(f"WARNING: wandb unavailable ({e!r}); metrics go to {self.path} only")
        if config:
            self.log({"_config": _jsonable(config)})

    def log(self, metrics: Dict):
        rec = {"_ts": time.time(), **_jsonable(metrics)}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            try:
                self._wandb.log(metrics)
            except Exception as e:  # a failing mirror must not stop training
                print(f"WARNING: wandb.log failed ({e!r}); metrics go to {self.path} only")
                self._wandb = None

    def close(self):
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "tolist"):  # numpy arrays and scalars, tensors
        return x.tolist()
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return str(x)
