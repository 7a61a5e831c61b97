"""Where the time of one EgoNN inference forward, one training step, or one
MinkLoc forward goes on the card.

    python -m egonn_tpu_torch.profile_forward            # EgoNN inference forward
    python -m egonn_tpu_torch.profile_forward --train    # EgoNN training step
    python -m egonn_tpu_torch.profile_forward --minkloc  # MinkLoc inference forward
    python -m egonn_tpu_torch.profile_forward --minkloc-lookup  # ... lookup-built down maps

Runs the forward at full EgoNN width on 8 `lidar_sim` clouds (65,536 points
each, cap0 16384, seeded random weights), the training step of
config/config_egonn.txt on a full-width synthetic batch (32 global clouds +
8 pairs, `data/train_batch.py`), or the MinkFPN model of
model_configs/minkloc3d_mulran.txt on the same 8 clouds at cap0 40960 (with
`--minkloc-lookup` on a pyramid that records level 2's up map only, so the
L1 and L2 down maps come from the lookup kernel), 3 times under
`torch.profiler`, and prints the device kernels with the most
time, the summed kernel time (the port's own kernels apart), the wall time
per iteration and the card's busy share over the profiled window.  The
Chrome trace goes to build/<mode>_trace.json.  Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys
import time
import types

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from egonn_tpu_torch import inference
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.models.factory import create_egonn_model, model_factory
from egonn_tpu_torch.ops.quantization import PolarQuantizer

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    raise AttributeError("profiler event has no device time")


BATCH, ITERS, TOP = 8, 3, 30


def _forward_fn(mode: str):
    if mode.startswith("minkloc"):
        from egonn_tpu_torch.config import ModelParams

        mp = ModelParams(str(ROOT / "model_configs" / "minkloc3d_mulran.txt"))
        built = model_factory(mp, cap0=40960, device="cuda", seed=0)
        if mode == "minkloc-lookup":
            built = dataclasses.replace(built, pyramid_spec=dataclasses.replace(
                built.pyramid_spec, up_levels=(2,)))
    else:
        mp = types.SimpleNamespace(model="egonn", quantizer=PolarQuantizer([1.0, 0.3, 0.2]),
                                   cap0=16384)
        built = create_egonn_model(mp, device="cuda", seed=0)
    clouds = torch.from_numpy(lidar_scan_clouds(BATCH, 65536, seed=0)).to(built.device)
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool, device=built.device)
    return (lambda: inference.forward(built, clouds, mask),
            f"{mp.model} forward of {BATCH} x 65536 points")


def _train_fn():
    from egonn_tpu_torch.config import TrainingParams
    from egonn_tpu_torch.data.train_batch import make_train_batch
    from egonn_tpu_torch.train.state import make_lr_schedule
    from egonn_tpu_torch.train.trainer import make_train_step

    tp = TrainingParams(str(ROOT / "config" / "config_egonn.txt"),
                        str(ROOT / "model_configs" / "egonn.txt"), require_dataset=False)
    built = create_egonn_model(tp.model_params, device="cuda", seed=1)
    step = make_train_step(built, tp)
    g, l = make_train_batch(tp, built.quantizer, built.device, n_places=tp.batch_size // 2)
    lr = make_lr_schedule(tp)(0)
    gen = torch.Generator(device=built.device).manual_seed(0)
    n = g["clouds"].shape[0] + 2 * l["anc_clouds"].shape[0]
    return lambda: step(g, l, gen, lr, True), f"train step of {n} clouds x 65536 points"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward: CUDA is not available", file=sys.stderr)
        return 1
    flags = [a[2:] for a in sys.argv[1:] if a in ("--train", "--minkloc", "--minkloc-lookup")]
    mode = flags[0] if flags else "forward"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, what = _train_fn() if mode == "train" else _forward_fn(mode)
    for _ in range(2):  # build the kernels, warm the allocator
        run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    # device-side kernel events only: an aten op's own row repeats its kernels' time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device kernels")
    events.sort(key=_device_us, reverse=True)
    total_ms = sum(_device_us(e) for e in events) / 1e3 / ITERS
    own_ms = sum(_device_us(e) for e in events if "egonn::" in e.key) / 1e3 / ITERS
    n_ops = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CPU and e.key.startswith("aten::")) / ITERS
    print(f"{what} ({mode}): {n_ops:.0f} aten ops, wall {wall_ms:.3f} ms, kernels "
          f"{total_ms:.3f} ms per iteration ({own_ms:.3f} ms in the port's CUDA kernels, "
          f"{sum(e.count for e in events) / ITERS:.0f} launches), busy share "
          f"{total_ms / wall_ms:.3f} (kernel time / wall, profiler on)")
    print(f"{'kernel':100s} {'ms/iter':>11s} {'share':>7s} {'calls/iter':>14s}")
    for e in events[:TOP]:
        ms = _device_us(e) / 1e3 / ITERS
        print(f"{e.key[:100]:100s} {ms:11.4f} {ms / total_ms:7.3f} {e.count / ITERS:14.1f}")
    out = pathlib.Path("build")
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / f"{mode}_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
