#!/usr/bin/env python3
"""Runs the PyTorch / CUDA port of EgoNN inference on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc

Phases, each printing its lines:

1. environment: the card (nvidia-smi name and power limit) and the build of
   the CUDA kernels from `egonn_tpu_torch/csrc`.
2. kernels: one EgoNN forward at full width (8 LiDAR clouds x 65,536 points,
   cap0 16384, weights from a seeded generator) records every kernel call's
   inputs; each call is then held against the kernel's plain PyTorch version
   on the card (integers bit-equal, floats within rel 1e-5: the kernels
   multiply in f32 FMA) and timed with CUDA events (median of 20 runs, each
   queued behind a sleep kernel so host overhead is not counted), beside its
   bound (bytes over 3.35 TB/s or operations over the type's peak rate,
   whichever is larger) and one PyTorch library call where one computes the
   same function.
3. slice: the same forward with every launch counter zeroed just before and
   read just after (zrun_presence 1, zrun_rank 7, gather_conv 14, tdown 7
   expected); output shapes, finiteness, capacity report.  Then 2 clouds on
   the card and on the CPU with the same weights: from one shared
   quantization every pyramid map must be bit-equal and the outputs within
   the tolerances of tests/test_torch_model.py; from independent
   quantizations the voxel mismatch rate (atan2 may differ by an ulp) is
   reported.  Last, clouds/s over 10 forwards on varied inputs (host clock;
   `python -m egonn_tpu_torch.profile_forward` splits a forward's device time).

The last three lines are the card's name and power limit, one JSON object
with every kernel's numbers, and `{"ok": true, "device": {...}}`.  Details
(every call's shapes and times) go to build/chip_smoke.json.  Any failure exits non-zero before the
last line; without CUDA the script exits non-zero at once.
"""
from __future__ import annotations

import copy
import dataclasses
import inspect
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import types

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # f32 FMA pipes, outside the tensor cores (data sheet)
INT32_OPS_PER_S = 33.5e12   # 64 INT32 lanes per SM against 128 FP32 lanes
B, N_POINTS, CAP0, SEED = 8, 65536, 16384, 0
EXPECTED_LAUNCHES = {"zrun_presence": 1, "zrun_rank": 7, "gather_conv": 14, "tdown": 7}
REPLACES = {
    "zrun_presence": ("egonn_tpu_torch/csrc/zrun.cu", "egonn_tpu/sparse/banded.py:970"),
    "zrun_rank": ("egonn_tpu_torch/csrc/zrun.cu", "egonn_tpu/sparse/banded.py:1095"),
    "gather_conv": ("egonn_tpu_torch/csrc/gather_conv.cu", "egonn_tpu/sparse/banded.py:207"),
    "tdown": ("egonn_tpu_torch/csrc/tdown.cu", "egonn_tpu/sparse/banded.py:506"),
}
FLOAT_REL_TOL = 1e-5
OUT_DIR = pathlib.Path("build")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _sleep_cycles_per_ms() -> float:
    torch.cuda._sleep(1000)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(10_000_000)
    e.record()
    e.synchronize()
    return 10_000_000 / s.elapsed_time(e)


def _sleep(ms: float, cycles_per_ms: float) -> None:
    cycles = int(cycles_per_ms * ms)
    while cycles > 0:  # in pieces that fit any integer width of the sleep
        torch.cuda._sleep(min(cycles, 1 << 30))
        cycles -= 1 << 30


def device_ms(fn, cycles_per_ms: float, reps: int = 20) -> float:
    """Median device time of fn() over `reps` runs, each between two CUDA
    events.  Each run is queued behind a sleep kernel twice as long as the
    host takes to enqueue it, so the card runs it back to back and the events
    see device time, not the host's launch overhead (one run's launches must
    fit the launch queue: a kernel call or a plain version, not a forward)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for s, e in events:
        _sleep(2.0 * host_ms + 0.05, cycles_per_ms)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# ---------------------------------------------------------------------------
# per-kernel work and bounds
# ---------------------------------------------------------------------------

def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def work(name: str, args: tuple, kwargs: dict, out) -> tuple:
    """(bytes, operations, ops rate) the call needs: each input read once,
    each output written once; operations as this call's data needs them."""
    if name in ("zrun_presence", "zrun_rank"):
        keys, q_lo, kz = args
        n_valid = int((q_lo != 2**31 - 1).sum())
        outs = out if isinstance(out, tuple) else (out,)
        # binary search steps + kz compares per valid query
        ops = n_valid * (math.ceil(math.log2(keys.shape[1] + 1)) + kz)
        return _nbytes(keys, q_lo, *outs), ops, INT32_OPS_PER_S
    epi = kwargs.get("epi")
    epi_t = (epi[0], epi[1], epi[3]) if epi else ()
    if name == "gather_conv":
        feats, kmap, kernel = args
        nnz = int(((kmap >= 0) & (kmap < feats.shape[1])).sum())
        ops = 2 * nnz * kernel.shape[1] * kernel.shape[2]
        return _nbytes(feats, kmap, kernel, out, *epi_t), ops, F32_OPS_PER_S
    feats, up_parent, up_koffset, kernel, c_coarse = args
    n_child = int(((up_parent >= 0) & (up_parent < c_coarse)).sum())
    ops = 2 * n_child * kernel.shape[1] * kernel.shape[2]
    return _nbytes(feats, up_parent, up_koffset, kernel, out, *epi_t), ops, F32_OPS_PER_S


def plain_call(name: str, kernels):
    return {
        "zrun_presence": lambda keys, q, kz: kernels.zrun_plain(keys, q, kz)[0],
        "zrun_rank": kernels.zrun_plain,
        "gather_conv": kernels.gather_conv_plain,
        "tdown": kernels.tdown_plain,
    }[name]


def library_call(name: str, args: tuple):
    """One PyTorch call computing the same function, where there is one."""
    if name == "zrun_rank":
        keys, q_lo, _ = args
        q = q_lo.reshape(keys.shape[0], -1)
        return lambda: torch.searchsorted(keys, q, out_int32=True)
    return None


def compare(name: str, got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            e = float((g - w).abs().max())
            scale = float(w.abs().max())
            if not e <= FLOAT_REL_TOL * max(scale, 1e-30):
                raise AssertionError(f"{name}: max abs err {e} against max |plain| {scale}")
        else:
            e = float((g.long() - w.long()).abs().max())
            if e != 0:
                raise AssertionError(f"{name}: integer outputs differ (max {e})")
        err = max(err, e)
    return err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment(cuda_lib):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[env] nvidia-smi: {smi}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    cuda_lib.build_all()
    log(f"[env] kernels built in {cuda_lib.build_seconds:.1f} s into {cuda_lib.BUILD_DIR}")
    for src, text in cuda_lib.ptxas_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[env] ptxas {src}: {line.strip()}")
    return smi


def make_inputs(device, b=None, seed=SEED):
    from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds

    clouds = torch.from_numpy(lidar_scan_clouds(b or B, N_POINTS, seed=seed)).to(device)
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool, device=device)
    return clouds, mask


def phase_kernels(built, kernels, inference, cycles_per_ms):
    """Record every kernel call of one forward, then compare and time each."""
    calls = []
    originals = {fn.__name__: fn for fn in kernels.KERNELS}

    def recorder(name):
        sig = inspect.signature(originals[name])

        def call(*args, **kwargs):
            out = originals[name](*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            vals = dict(bound.arguments)
            # positional tensors and sizes in signature order; `epi` by keyword
            epi = {"epi": vals.pop("epi")} if "epi" in vals else {}
            calls.append((name, tuple(vals.values()), epi, out))
            return out
        return call

    clouds, mask = make_inputs(built.device)
    for name in originals:
        setattr(kernels, name, recorder(name))
    try:
        inference.forward(built, clouds, mask)
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)
    torch.cuda.synchronize()

    rows = {name: dict(name=name, route="cuda", source=REPLACES[name][0],
                       replaces=REPLACES[name][1], launches=None, max_abs_err=0.0,
                       ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                       _bytes_ms=0.0, _ops_ms=0.0, calls=[])
            for name in originals}
    with torch.no_grad():
        for name, args, kwargs, out in calls:
            plain = plain_call(name, kernels)
            want = plain(*args, **kwargs)
            err = compare(name, out, want)
            kern = originals[name]
            ms = device_ms(lambda: kern(*args, **kwargs), cycles_per_ms)
            plain_ms = device_ms(lambda: plain(*args, **kwargs), cycles_per_ms)
            lib = library_call(name, args)
            lib_ms = device_ms(lib, cycles_per_ms) if lib else None
            nbytes, ops, rate = work(name, args, kwargs, out)
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
            row = rows[name]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += ms
            row["plain_ms"] += plain_ms
            row["bound_ms"] += max(bytes_ms, ops_ms)
            row["_bytes_ms"] += bytes_ms
            row["_ops_ms"] += ops_ms
            if lib_ms is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) + lib_ms
            shape = [list(a.shape) if torch.is_tensor(a) else a for a in args]
            row["calls"].append(dict(shapes=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     bytes=nbytes, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                                     max_abs_err=err))
            log(f"[kernels] {name} {shape[:2]} ms {ms:.4f} plain {plain_ms:.4f} "
                f"bound {max(bytes_ms, ops_ms):.4f} err {err:.3g}")
    for row in rows.values():
        row["bound_by"] = "bytes" if row.pop("_bytes_ms") >= row.pop("_ops_ms") else "operations"
    return rows


def phase_slice(built, kernels, inference, pyramid_mod):
    clouds, mask = make_inputs(built.device)
    spec = built.pyramid_spec
    kernels.reset_launches()
    y = inference.forward(built, clouds, mask)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"[slice] launches per forward: {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {launches}, expected {EXPECTED_LAUNCHES}")
    c3 = spec.capacities[3]
    expect = {"global": (B, 256), "descriptors": (B, c3, 128), "keypoints": (B, c3, 3),
              "sigma": (B, c3, 1), "kp_mask": (B, c3)}
    for k, shape in expect.items():
        if tuple(y[k].shape) != shape:
            raise AssertionError(f"{k}: shape {tuple(y[k].shape)}, expected {shape}")
        if y[k].dtype.is_floating_point and not bool(torch.isfinite(y[k]).all()):
            raise AssertionError(f"{k}: non-finite values")
    log(f"[slice] output shapes ok: { {k: tuple(v.shape) for k, v in y.items()} }")
    res = built.quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
    report = pyramid_mod.capacity_report(
        pyramid_mod.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys), spec)
    log(f"[slice] capacity report: {report}")
    if not all(ok for _, _, ok in report.values()):
        raise AssertionError(f"capacity overflow: {report}")

    # the same weights on the CPU, 2 clouds
    cpu = torch.device("cpu")
    built_cpu = dataclasses.replace(built, model=copy.deepcopy(built.model).to(cpu), device=cpu)
    c2, m2 = make_inputs(cpu, b=2, seed=SEED + 1)
    # (a) one shared quantization: pyramids bit-equal, outputs within tolerance
    res2 = built.quantizer.quantize(c2.to(built.device), m2.to(built.device),
                                    spec.capacities[0], need_index=False)
    pg = pyramid_mod.build_pyramid(res2.coords_t, res2.mask, spec, keys0=res2.keys)
    pc = pyramid_mod.build_pyramid(res2.coords_t.cpu(), res2.mask.cpu(), spec,
                                   keys0=res2.keys.cpu())
    for l in range(spec.num_levels + 1):
        for field in ("coords", "mask", "kmap_self", "up_parent", "up_koffset"):
            a, b_ = getattr(pg[l], field), getattr(pc[l], field)
            if (a is None) != (b_ is None) or (a is not None and not torch.equal(a.cpu(), b_)):
                raise AssertionError(f"L{l} {field}: card and CPU pyramids differ")
    with torch.no_grad():
        yg = built.model(pg, built.quantizer)
        yc = built_cpu.model(pc, built.quantizer)
    g_rel = float((yg["global"].cpu() - yc["global"]).abs().max() / yc["global"].abs().max())
    d_err = float((yg["descriptors"].cpu() - yc["descriptors"]).abs().max())
    k_err = float((yg["keypoints"].cpu() - yc["keypoints"]).abs().max())
    s_rel = float(((yg["sigma"].cpu() - yc["sigma"]).abs() / yc["sigma"].abs().clamp_min(1e-30))
                  .max())
    log(f"[slice] card vs CPU, shared quantization: pyramids bit-equal; global rel {g_rel:.3g}, "
        f"descriptors abs {d_err:.3g}, keypoints abs {k_err:.3g} m, sigma rel {s_rel:.3g}")
    if not (g_rel <= 1e-4 and d_err <= 1e-4 and k_err <= 1e-3 and s_rel <= 1e-4
            and torch.equal(yg["kp_mask"].cpu(), yc["kp_mask"])):
        raise AssertionError("card and CPU forwards disagree beyond tolerance")
    # (b) independent quantization end to end (report only)
    vg = built.quantizer.to_polar_voxels(c2.to(built.device)).cpu()
    vc = built_cpu.quantizer.to_polar_voxels(c2)
    mismatch = float((vg != vc).any(dim=1).double().mean())
    ye2 = inference.forward(built, c2.to(built.device), m2.to(built.device))
    yc2 = inference.forward(built_cpu, c2, m2)
    e2e_rel = float((ye2["global"].cpu() - yc2["global"]).abs().max()
                    / yc2["global"].abs().max())
    log(f"[slice] card vs CPU, independent quantization: voxel mismatch rate {mismatch:.3g} "
        f"of {vg.shape[0] * vg.shape[2]} points, global rel {e2e_rel:.3g}")

    # throughput on varied inputs
    gen = torch.Generator(device=built.device).manual_seed(SEED)
    iters = 10
    variants = [clouds + 0.01 * torch.randn(clouds.shape, generator=gen, device=built.device)
                for _ in range(iters)]
    inference.forward(built, variants[0], mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for v in variants:
        inference.forward(built, v, mask)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return dict(launches=launches, capacity=report, global_rel_shared=g_rel,
                descriptors_abs=d_err, keypoints_abs_m=k_err, sigma_rel=s_rel,
                voxel_mismatch_rate=mismatch, global_rel_independent=e2e_rel,
                clouds_per_s=B * iters / sec, forward_ms=sec / iters * 1e3)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from egonn_tpu_torch import inference
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.ops.quantization import PolarQuantizer
    from egonn_tpu_torch.sparse import cuda_lib, kernels
    from egonn_tpu_torch.sparse import pyramid as pyramid_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_environment(cuda_lib)
    device = torch.device("cuda")
    mp = types.SimpleNamespace(model="egonn", quantizer=PolarQuantizer([1.0, 0.3, 0.2]),
                               cap0=CAP0)
    built = create_egonn_model(mp, cap0=CAP0, device=device, seed=SEED)
    cycles_per_ms = _sleep_cycles_per_ms()

    t0 = time.perf_counter()
    rows = phase_kernels(built, kernels, inference, cycles_per_ms)
    log(f"[kernels] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sl = phase_slice(built, kernels, inference, pyramid_mod)
    log(f"[slice] phase done in {time.perf_counter() - t0:.1f} s")
    log(f"[slice] {sl['clouds_per_s']:.1f} clouds/s over 10 forwards of {B} x {N_POINTS} "
        f"points ({sl['forward_ms']:.2f} ms per forward, host clock) on {smi}")
    for name, row in rows.items():
        row["launches"] = sl["launches"][name]

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, slice=sl, kernels=rows, seconds=time.perf_counter() - t_start),
        indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"card: {smi}")
    log(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows.values()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
