"""Where the time of one EgoNN inference forward, one training step, one
MinkLoc forward, one ResNet14 forward, one GL evaluation or one epoch of
the training loop goes on the card.

    python -m egonn_tpu_torch.profile_forward            # EgoNN inference forward
    python -m egonn_tpu_torch.profile_forward --train    # EgoNN training step
    python -m egonn_tpu_torch.profile_forward --minkloc  # MinkLoc inference forward
    python -m egonn_tpu_torch.profile_forward --minkloc-lookup  # ... lookup-built down maps
    python -m egonn_tpu_torch.profile_forward --resnet   # ResNet14, lookup-built down maps
    python -m egonn_tpu_torch.profile_forward --eval     # GLEvaluator.evaluate
    python -m egonn_tpu_torch.profile_forward --loop     # do_train, one epoch

Runs the forward at full EgoNN width on 8 `lidar_sim` clouds (65,536 points
each, cap0 16384, seeded random weights), the training step of
config/config_egonn.txt on a full-width synthetic batch (32 global clouds +
8 pairs, `data/train_batch.py`), or the MinkFPN model of
model_configs/minkloc3d_mulran.txt on the same 8 clouds at cap0 40960 (with
`--minkloc-lookup` on a pyramid that records level 2's up map only, so the
L1 and L2 down maps come from the lookup kernel), or ResNet14 at torchvision
widths (in_channels 1, the voxel centre's z as its feature) on the same
clouds through the MinkLoc config's quantizer (`chip_smoke.py` phase 8's
workload: quantization, the pyramid with L1-L4's down maps from one lookup
launch, the model), or one evaluation of `GLEvaluator` (n_k 128 and 256,
1,024 hypotheses) on `chip_smoke.py` phase 9's synthetic set (64 scans, seed
0, written into build/eval_synth when absent) with EgoNN from
model_configs/egonn.txt, or `do_train` for one epoch (config_egonn.txt at
full width, loading, checkpoint and capacity audit included) on
`chip_smoke.py` phase 10's synthetic set (192 scans, seed 0, written into
build/train_synth when absent), 3 times under `torch.profiler`, and prints the device kernels with the most
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


def _resnet_fn():
    """ResNet14 at torchvision widths on the 8 clouds: capacities
    max(256, 40960 >> min(l, 4)), no up maps, the stem over each voxel's
    centre z / 4 m."""
    from egonn_tpu_torch.config import ModelParams
    from egonn_tpu_torch.models.resnet import ResNetBase
    from egonn_tpu_torch.sparse.pyramid import PyramidSpec, build_pyramid

    quantizer = ModelParams(str(ROOT / "model_configs" / "minkloc3d_mulran.txt")).quantizer
    spec = PyramidSpec(capacities=(40960, 20480, 10240, 5120, 2560), conv0_kernel_size=5,
                       block_kernel_size=3, self_levels=(1, 2, 3, 4), up_levels=(),
                       conv0_ones=False, need_source_index=False)
    model = ResNetBase(1, torch.Generator().manual_seed(0)).eval().to("cuda")
    clouds = torch.from_numpy(lidar_scan_clouds(BATCH, 65536, seed=0)).to("cuda")
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool, device=clouds.device)

    def run():
        res = quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
        pyr = build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)
        z = quantizer.dequantize(res.coords_t.transpose(-1, -2))[..., 2:3] * 0.25
        with torch.no_grad():
            return model(pyr, torch.where(res.mask[..., None], z, 0.0).contiguous())
    return run, f"ResNet14 forward of {BATCH} x 65536 points"


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


def _eval_fn():
    from egonn_tpu_torch.config import ModelParams
    from egonn_tpu_torch.data.synthetic import generate_synthetic_dataset
    from egonn_tpu_torch.eval.evaluator import GLEvaluator

    root = pathlib.Path("build") / "eval_synth"
    if not (root / "test_synthetic.pickle").exists():
        generate_synthetic_dataset(str(root), seed=0)
    mp = ModelParams(str(ROOT / "model_configs" / "egonn.txt"))
    built = create_egonn_model(mp, device="cuda", seed=0)
    ev = GLEvaluator(str(root), "synthetic", "test_synthetic.pickle", built,
                     num_points=mp.num_points)
    n = len(ev.eval_set.map_set) + len(ev.eval_set.query_set)
    return ev.evaluate, f"GL evaluation of {n} scans x {mp.num_points} points"


def _loop_fn():
    from egonn_tpu_torch.config import TrainingParams
    from egonn_tpu_torch.data.synthetic import generate_synthetic_dataset
    from egonn_tpu_torch.train.trainer import do_train

    root = pathlib.Path("build") / "train_synth"
    names = ("train_synthetic.pickle", "val_synthetic.pickle", "test_synthetic.pickle")
    if not (root / names[0]).exists():
        names = generate_synthetic_dataset(str(root), n_scans=192, seed=0)
    tp = TrainingParams(str(ROOT / "config" / "config_egonn.txt"),
                        str(ROOT / "model_configs" / "egonn.txt"), require_dataset=False)
    tp.dataset, tp.dataset_folder, tp.epochs = "synthetic", str(root), 1
    tp.train_file, tp.val_file, tp.test_file = names[0], names[1], None
    weights = str(pathlib.Path("build") / "loop_profile")
    return (lambda: do_train(tp, weights_path=weights, log_fn=lambda m: None),
            f"training epoch ({tp.batch_size} global clouds + {tp.local_batch_size} pairs a "
            "step, from the entry point)")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward: CUDA is not available", file=sys.stderr)
        return 1
    flags = [a[2:] for a in sys.argv[1:]
             if a in ("--train", "--minkloc", "--minkloc-lookup", "--resnet", "--eval", "--loop")]
    mode = flags[0] if flags else "forward"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, what = {"train": _train_fn, "resnet": _resnet_fn, "eval": _eval_fn,
                 "loop": _loop_fn}.get(
        mode, lambda: _forward_fn(mode))()
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
