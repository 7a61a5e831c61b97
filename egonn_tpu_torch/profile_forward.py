"""Where the time of one EgoNN inference forward goes on the card.

    python -m egonn_tpu_torch.profile_forward

Runs the forward at full EgoNN width on 8 `lidar_sim` clouds (65,536 points
each, cap0 16384, seeded random weights), 3 times under `torch.profiler`,
and prints
the device kernels with the most time, the summed kernel time (the port's own
kernels apart), the wall time per forward and the card's busy share over the
profiled window.  The Chrome trace goes to build/forward_trace.json.
Needs a CUDA card.
"""
from __future__ import annotations

import pathlib
import sys
import time
import types

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from egonn_tpu_torch import inference
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.models.factory import create_egonn_model
from egonn_tpu_torch.ops.quantization import PolarQuantizer


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    raise AttributeError("profiler event has no device time")


BATCH, ITERS, TOP = 8, 3, 30


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mp = types.SimpleNamespace(model="egonn", quantizer=PolarQuantizer([1.0, 0.3, 0.2]),
                               cap0=16384)
    built = create_egonn_model(mp, device="cuda", seed=0)
    clouds = torch.from_numpy(lidar_scan_clouds(BATCH, 65536, seed=0)).to(built.device)
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool, device=built.device)
    for _ in range(2):  # build the kernels, warm the allocator
        inference.forward(built, clouds, mask)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            inference.forward(built, clouds, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    # device-side kernel events only: an aten op's own row repeats its kernels' time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device kernels")
    events.sort(key=_device_us, reverse=True)
    total_ms = sum(_device_us(e) for e in events) / 1e3 / ITERS
    own_ms = sum(_device_us(e) for e in events if "egonn::" in e.key) / 1e3 / ITERS
    print(f"forward of {BATCH} x 65536 points: wall {wall_ms:.3f} ms, kernels "
          f"{total_ms:.3f} ms per forward ({own_ms:.3f} ms in the port's CUDA kernels, "
          f"{sum(e.count for e in events) / ITERS:.0f} launches), busy share "
          f"{total_ms / wall_ms:.3f} (kernel time / wall, profiler on)")
    print(f"{'kernel':60s} {'ms/forward':>11s} {'share':>7s} {'calls/forward':>14s}")
    for e in events[:TOP]:
        ms = _device_us(e) / 1e3 / ITERS
        print(f"{e.key[:60]:60s} {ms:11.4f} {ms / total_ms:7.3f} {e.count / ITERS:14.1f}")
    out = pathlib.Path("build")
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / "forward_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
