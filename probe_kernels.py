#!/usr/bin/env python3
"""Sweeps the launch parameters of the port's kernels on an H100, to check
the rules in `egonn_tpu_torch/sparse/kernels.py` that choose them:

- gather_conv: the column slice (32 or 64, `conv_cols`) and the number of
  blocks that share a tile's offsets (1-4, `offset_groups`), for f32 and,
  on the bf16 forward's, train step's and MinkLoc forward's calls and the
  ResNet-width calls in bf16, bf16 features, there for both bf16 bodies
  (the Hopper one and the SM80 one, `conv_body`);
- gather_dw: the slice of dW a block owns (mb x nb, 32 or 64 each) and the
  number of chunks of its partial pass (`dw_tiling`), at 1/2, 1 and 2 times
  the rule's count for that slice and body; f32 and, on the bf16 train
  step's calls and the ResNet-width calls in bf16, both bf16 bodies
  (`dw_body`);
- on the bf16 calls, the cut-outs of both bodies at their rules' settings
  (CONV_CUTS, DW_CUTS: without the MMA, without the row gather, without the
  map's scan or with the map's load and compaction alone; built into
  libraries of their own, `cuda_lib.probe_function`), which split a call's
  time into barrier and latency, gathering, compaction and MMA;
- tdown: the gathering body, and the streaming body's coarse rows of a
  tile (32, 64, 128) by fine rows of a stage (32, 64, 128) (`tdown_tiling`),
  and its hull launch alone; f32 and, on the bf16 forward's calls, bf16
  (every tiling fits the bf16 bodies, `tdown_tiling_ok`);
- zrun_presence / zrun_rank: the queries of a block (256, 512, 1024,
  `zrun_chunk`);
- stem_ones: the columns of a block (128, 256, 512, `_STEM_THREADS`); on
  the forward's, MinkLoc's and the train step's calls and at the embed
  cells' shapes (the 8 clouds' level-0 maps repeated to 128 EgoNN and 64
  MinkLoc3D clouds), beside its plain form, that form's GEMM alone and its
  bytes bound;
- tconv (the transposed conv, `csrc/tconv.cu`): the column slice (32, 64,
  `tconv_cols`) at MinkLoc3D's b64 cell's shape (64 clouds, L3 -> L2, 256
  wide) and at a MinkLoc3Dv2 staged chunk's (128 submaps, L4 -> L3 and
  L3 -> L2, 256 wide), on the maps of real forwards, beside the slot order's
  counting sort alone (`slot_order`), the bytes / operations bound (three
  TF32 MMAs a product), the all-slot product it replaced (`tconv_plain`)
  and the route of a slot map handed to gather_conv (`slot_kmap`: the map
  built beforehand, the gather conv alone);
- tconv_dw (the transposed conv's weight gradient, `csrc/tconv_dw.cu`) at
  a MinkLoc3Dv2 staged chunk's two top-down steps (128 submaps, 256 wide)
  and at EgoNN's heads on the train step's 32-cloud global batch (64-128
  wide), on the maps of real forwards with a seeded g: both routes, the
  slot order (`tconv_dw_tiling`'s slice at 1/2, 1 and 2 times its chunk
  count, and 32 x 32 slices) and the coarse level's kmap_down (inverted
  beforehand, then gather_dw with its operands swapped: g gathered by the
  map, the coarse features by row), beside the plain form's 8 slot-masked
  products (`tconv_dw_plain`) and the bytes / operations bound;
- lookup (the grouped down-map launch, `lookup_down`): the coarse rows of a
  block's tile (32, 64, 128, 256, `lookup_rows`) by the table rows its
  shared-memory slice holds (1,024 to 8,192, `_LOOKUP_SLICE`), with the
  blocks that overflowed the slice at each setting; and the device kernels
  and device time (`torch.profiler`) of building the lookup-built down maps
  in one grouped launch against the per-level form they replace (each
  level's queries formed by torch ops, then one lookup launch per level).

    python3 probe_kernels.py        # from the repository root; one CUDA card, nvcc
    python3 probe_kernels.py bf16   # the bf16 calls alone (conv and dW)
    python3 probe_kernels.py tconv  # the transposed conv's rows alone
    python3 probe_kernels.py tconv_dw  # its weight gradient's rows alone

The calls are those of one EgoNN forward (f32, and bf16 under
EGONN_BF16_ACTS=1: chip_smoke's phase 3b), the gather_dw calls of one bf16
training step (chip_smoke's phase 5b) and one training step at full width
(recorded as `chip_smoke.py` records them: 8 x 65,536 points, cap0 16384; the
train step of config/config_egonn.txt), the tdown calls of its validation
step (32 + 8 + 8 clouds), one MinkLoc forward
(model_configs/minkloc3d_mulran.txt, cap0 40960, as chip_smoke's phase 6),
phase 7's synthetic ResNet-width calls that the kernels take as they are,
and the lookup-built down maps of phase 6's EgoNN pyramid without up maps
and MinkLoc pyramid with level 2's alone and of phase 8's ResNet14.  Each distinct call shape
prints one line per kernel: every setting's device time (median of 10 runs
between CUDA events, as `chip_smoke.device_ms` times them), the rule's
choice and the fastest setting.  Every setting's output but a cut-out's is
held against the wrapper's (bf16 convs and dW: the plain version's) at
chip_smoke's tolerances, and a miss ends the probe.  Ring depths and stage
rows are the kernels' constants (`csrc/gather_mm_sm90.cuh`, `gather_dw.cu`),
not swept.  The card's name and power limit come first; the whole sweep
goes to build/probe_kernels.json.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import types

import numpy as np
import torch

import chip_smoke


# The bf16 bodies' cut-outs (csrc/bf16.cuh's kCut*, built only into the probe
# libraries of sparse/cuda_lib.py), each run at its body's rule tiling: the
# body without its MMA, without its row gather; the Hopper conv without its
# W^T loads; the SM80 body without the scan of its map (the conv reads the
# compacted lists that a compaction-only launch wrote; dW takes a synthetic
# map of the same density); the conv's map load and compaction alone (no
# stages).  A setting is (.., body, cut).
NO_MMA, NO_GATHER, NO_SCAN, COMPACT_ONLY, NO_WEIGHTS = 1, 2, 3, 4, 5
CONV_CUTS = {"sm80_no_mma": (0, NO_MMA), "sm80_no_gather": (0, NO_GATHER),
             "sm80_no_scan": (0, NO_SCAN), "sm80_compact_only": (0, COMPACT_ONLY),
             "sm90_no_mma": (1, NO_MMA), "sm90_no_gather": (1, NO_GATHER),
             "sm90_compact_only": (1, COMPACT_ONLY), "sm90_no_weights": (1, NO_WEIGHTS)}
DW_CUTS = {"sm80_no_mma": (0, NO_MMA), "sm80_no_gather": (0, NO_GATHER),
           "sm80_no_scan": (0, NO_SCAN), "sm90_no_mma": (1, NO_MMA),
           "sm90_no_gather": (1, NO_GATHER)}
BF16_BODIES = (1, 0)  # the bf16 bodies swept: kernels.SM90, kernels.SM80


def _conv_setting(kernels, cuda_lib, args, kwargs, cols: int, n_groups: int, body=None,
                  cut=0):
    """The gather_conv launch of `args` with a given slice and offset split;
    bf16 features: `body` (kernels.SM90 or SM80; None: the rule's) and its
    cut-out `cut` (0: none)."""
    feats, kmap, kernel = args
    b, c_in, f_in = feats.shape
    k_vol, _, f_out = kernel.shape
    c_out = kmap.shape[2]
    scale, bias, relu, mask = kernels._check_epi(kwargs.get("epi"), b, c_out, f_out)
    out = torch.empty((b, c_out, f_out), dtype=feats.dtype, device=feats.device)
    partial = torch.empty((n_groups, b, c_out, f_out), device=feats.device)
    bf16 = kernels._is_bf16(feats)
    w = kernels._bf16_transposed(kernel) if bf16 else kernel
    fn = cuda_lib.function("gather_conv.cu", "egonn_gather_conv_bf16" if bf16 else
                           "egonn_gather_conv")
    extra = ()
    if bf16:
        body = kernels.conv_body(b, c_out, f_in, f_out, k_vol) if body is None else body
        extra = (body,)
    if cut:
        fn = cuda_lib.probe_function("gather_conv.cu", "egonn_gather_conv_bf16_cut")
        # the compacted lists of every (tile, cloud x group, group of 32 offsets)
        n_lists = -(-c_out // 128) * b * n_groups * 32
        lists = (torch.empty(n_lists * (32 * 130 + 1), dtype=torch.int32, device=feats.device)
                 if body == kernels.SM80 and cut in (NO_SCAN, COMPACT_ONLY) else None)
        extra = (body, cut, kernels._ptr(lists))

    def launch(*body_args):
        kernels._raise_on(fn(feats.data_ptr(), kmap.data_ptr(), w.data_ptr(),
                             kernels._ptr(scale), kernels._ptr(bias), kernels._ptr(mask),
                             out.data_ptr(), partial.data_ptr(), n_groups, b, c_in, f_in, k_vol,
                             c_out, f_out, cols, relu, *body_args, kernels._stream(feats)),
                          "gather_conv")
        return out
    if cut == NO_SCAN:  # its lists, written once up front
        launch(body, COMPACT_ONLY, extra[2])
    return lambda: launch(*extra)


def _dw_setting(kernels, cuda_lib, args, mb: int, nb: int, n_chunks: int, body=None,
                cut=0):
    """The gather_dw launch of `args` with a given slice and chunk count (bf16
    features: `body` kernels.SM90 or SM80 and its cut-out `cut`, g rounded
    to bf16 as the wrapper rounds it)."""
    feats, kmap, g = args
    b, c_in, f_in = feats.shape
    k_vol, c_out = kmap.shape[1], kmap.shape[2]
    f_out = g.shape[2]
    bf16 = kernels._is_bf16(feats)
    g = g.to(feats.dtype)
    partial = torch.empty((n_chunks, k_vol, f_in, f_out), device=feats.device)
    out = torch.empty((k_vol, f_in, f_out), device=feats.device)
    fn = cuda_lib.function("gather_dw.cu", "egonn_gather_dw_bf16" if bf16 else "egonn_gather_dw")
    extra = ()
    if bf16:
        extra = (kernels.dw_body(b, c_out, f_in, f_out, k_vol) if body is None else body,)
    if cut:
        fn = cuda_lib.probe_function("gather_dw.cu", "egonn_gather_dw_bf16_cut")
        extra = (body, cut)

    def run():
        kernels._raise_on(fn(feats.data_ptr(), kmap.data_ptr(), g.data_ptr(), partial.data_ptr(),
                             out.data_ptr(), b, c_in, f_in, k_vol, c_out, f_out, mb, nb, n_chunks,
                             *extra, kernels._stream(feats)), "gather_dw")
        return out
    return run


def _dw_chunks(kernels, b: int, c_out: int, f_in: int, f_out: int, k_vol: int, mb: int,
               nb: int, body: int) -> int:
    """`kernels.dw_tiling`'s chunk count for the slice (mb, nb) and body."""
    blocks = k_vol * (f_in // mb) * (f_out // nb)
    tiles = b * -(-c_out // 64)
    if body == kernels.SM90:
        return max(1, min(tiles, kernels._DW_SM90_BLOCKS // blocks))
    return max(1, min(tiles, -(-kernels._DW_BLOCKS // blocks)))


def _tdown_setting(kernels, args, kwargs, tiling):
    return lambda: kernels._tdown_cuda(*args, kwargs.get("epi"), *tiling)


def _zrun_setting(kernels, name, args, q_chunk: int):
    keys, q_lo, kz = args
    return lambda: kernels._zrun_cuda(keys, q_lo, kz, name == "zrun_rank", q_chunk)


def _lookup_setting(kernels, args, rows: int, cap: int):
    keys, packs, levels = args
    return lambda: kernels._lookup_cuda([keys[l - 1] for l in levels], [keys[l] for l in levels],
                                        [8] * len(levels), [(packs[l], packs[l - 1]) for l in levels],
                                        rows=rows, slice_cap=cap)


def _settings(name, args, kwargs, kernels, cuda_lib):
    """(description, the rule's setting, every setting, setting -> run)."""
    if name == "stem_ones":
        kmap, kernel, n_in = args
        return (chip_smoke.call_desc(name, args), kernels._STEM_THREADS, [128, 256, 512],
                lambda s: lambda: kernels._stem_ones_cuda(kmap, kernel, n_in, s))
    if name == "lookup_down":
        settings = list(itertools.product((32, 64, 128, 256), (1024, 2048, 4096, 8192)))
        return (chip_smoke.call_desc(name, args), (kernels.lookup_rows(8), kernels._LOOKUP_SLICE),
                settings, lambda s: _lookup_setting(kernels, args, *s))
    if name in ("zrun_presence", "zrun_rank"):
        q_lo = args[1]
        valid = float((q_lo != 2**31 - 1).float().mean())
        desc = f"B {q_lo.shape[0]} Kxy {q_lo.shape[1]} C {q_lo.shape[2]} valid {valid:.3f}"
        return (desc, kernels.zrun_chunk(q_lo.shape[2]), [256, 512, 1024],
                lambda s: _zrun_setting(kernels, name, args, s))
    if name == "tdown":
        feats, up_parent, _, kernel, c_coarse = args
        children = int((up_parent < c_coarse).sum())
        desc = f"{chip_smoke.call_desc(name, args)} children {children}"
        rule = kernels.tdown_tiling(*feats.shape)
        bf16 = kernels._is_bf16(feats)
        settings = [(128, 0, True)] + [
            (rows, rc, False) for rows, rc in itertools.product((32, 64, 128), (32, 64, 128))
            if kernels.tdown_tiling_ok(feats.shape[2], kernel.shape[2], rows, rc, bf16=bf16)]
        return desc, rule, settings, lambda s: _tdown_setting(kernels, args, kwargs, s)
    feats, kmap = args[0], args[1]
    b, _, f_in = feats.shape
    k_vol, c_out = kmap.shape[1], kmap.shape[2]
    f_out = args[2].shape[2]
    valid = float(((kmap >= 0) & (kmap < feats.shape[1])).float().mean())
    desc = f"{chip_smoke.call_desc(name, args)} valid {valid:.3f}"
    bf16 = kernels._is_bf16(feats)
    if name == "gather_conv":
        rule = (kernels.conv_cols(b, c_out, f_out, k_vol),
                kernels.offset_groups(b, c_out, f_in, f_out, k_vol))
        groups = range(1, min(4, k_vol) + 1)
        settings = [(c, n) for c in (32, 64) if f_out % c == 0 for n in groups]
        if bf16:  # both bodies, and the cut-outs at each body's rule
            body = kernels.conv_body(b, c_out, f_in, f_out, k_vol)
            rule = (kernels.conv_cols(b, c_out, f_out, k_vol, body),
                    kernels.offset_groups(b, c_out, f_in, f_out, k_vol, body, True), body)
            settings = [(c, n, bd) for bd in BF16_BODIES
                        for c in (64, 32)
                        if f_out % c == 0 for n in groups]
            settings += [(kernels.conv_cols(b, c_out, f_out, k_vol, bd),
                          kernels.offset_groups(b, c_out, f_in, f_out, k_vol, bd, True), bd, cut)
                         for bd, cut in CONV_CUTS.values()]
        return desc, rule, settings, lambda s: _conv_setting(kernels, cuda_lib, args, kwargs, *s)
    bodies = BF16_BODIES if bf16 else (kernels.SM80,)
    rule = kernels.dw_tiling(b, c_out, f_in, f_out, k_vol)
    if bf16:
        body = kernels.dw_body(b, c_out, f_in, f_out, k_vol)
        rule = (*kernels.dw_tiling(b, c_out, f_in, f_out, k_vol, body), body)
    settings = []
    for body, (mb, nb) in itertools.product(bodies, itertools.product((32, 64), (32, 64))):
        if f_in % mb or f_out % nb:
            continue
        n = _dw_chunks(kernels, b, c_out, f_in, f_out, k_vol, mb, nb, body)
        settings += [(mb, nb, c) + ((body,) if bf16 else ())
                     for c in sorted({max(1, n // 2), n, 2 * n})]
    if bf16:
        settings += [(*kernels.dw_tiling(b, c_out, f_in, f_out, k_vol, bd), bd, cut)
                     for bd, cut in DW_CUTS.values()]
    return desc, rule, settings, lambda s: _dw_setting(kernels, cuda_lib, args, *s)


def sweep(tag, name, args, kwargs, kernels, cuda_lib, cycles_per_ms) -> dict:
    """Every setting of one call: times, the rule's choice, the fastest."""
    bf16 = name in ("gather_conv", "gather_dw") and kernels._is_bf16(args[0])
    # bf16 convs and dW against their plain versions (either body may be the
    # wrapper's)
    want = (chip_smoke.plain_call(name, kernels) if bf16 else getattr(kernels, name))(
        *args, **kwargs)
    desc, rule, settings, make = _settings(name, args, kwargs, kernels, cuda_lib)
    times, overflow = {}, {}
    cut_out = (lambda s: len(s) == (4 if name == "gather_conv" else 5)) if bf16 else (
        lambda s: False)
    for s in settings:
        run = make(s)
        before = kernels.lookup_overflow_blocks(want[0].device) if name == "lookup_down" else 0
        if not cut_out(s):  # a cut-out computes something else
            try:
                chip_smoke.compare(name, run(), want)
            except AssertionError as e:
                raise AssertionError(f"[{tag}] {name} {desc} setting {s}: {e}") from e
        if name == "lookup_down":
            overflow[str(s)] = kernels.lookup_overflow_blocks(want[0].device) - before
        times[str(s)] = chip_smoke.device_ms(run, cycles_per_ms, reps=10)
    best = min((str(st) for st in settings if not cut_out(st)), key=times.get)
    hull = ""
    if overflow:
        hull = "; overflow blocks " + ", ".join(f"{s} {v}" for s, v in overflow.items() if v)
    if name == "stem_ones":  # its plain form and that form's GEMM alone
        nbytes, _, _ = chip_smoke.work(name, args, kwargs, want)
        plain = chip_smoke.plain_call(name, kernels)
        times["plain"] = chip_smoke.device_ms(lambda: plain(*args), cycles_per_ms, reps=10)
        times["library"] = chip_smoke.device_ms(chip_smoke.library_call(name, args),
                                                cycles_per_ms, reps=10)
        times["bound"] = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        hull = (f"; plain {times['plain']:.4f}, its GEMM alone {times['library']:.4f}, bytes "
                f"bound {times['bound']:.4f}")
    if name == "tdown":  # its first launch alone, at each tile height
        hull_ms = {r: chip_smoke.device_ms(
            lambda r=r: kernels._tdown_hulls_cuda(args[1], args[4], r), cycles_per_ms, reps=10)
            for r in (32, 64, 128)}
        times.update({f"hulls {r}": v for r, v in hull_ms.items()})
        hull = "; hulls alone " + ", ".join(f"{r} {v:.4f}" for r, v in hull_ms.items())
    chip_smoke.log(f"[{tag}] {name} {desc}: " + ", ".join(f"{s} {times[str(s)]:.4f}"
                                                          for s in settings)
                   + f" ms; rule {rule} {times.get(str(rule), float('nan')):.4f}, best {best} "
                   f"{times[best]:.4f}"
                   + hull)
    return dict(tag=tag, name=name, call=desc, times=times, rule=str(rule), best=best,
                overflow=overflow)


def map_build_kernels(tag, kernels, args) -> dict:
    """Device kernels and device ms of one build of a path's lookup-built
    down maps: the grouped launch (`lookup_down`) against the per-level form
    (`down_queries` in torch ops + one `lookup` launch per level)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    keys, packs, levels = args
    forms = {"grouped": lambda: kernels.lookup_down(keys, packs, levels),
             "per_level": lambda: [kernels.lookup(keys[l - 1],
                                                  kernels.down_queries(keys[l], packs[l],
                                                                       packs[l - 1]))
                                   for l in levels]}
    out = {}
    for form, run in forms.items():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                 for e in events)
        out[form] = dict(kernels=sum(e.count for e in events), device_ms=us / 1e3)
    chip_smoke.log(f"[map-build] {tag} {chip_smoke.call_desc('lookup_down', args)}: "
                   + "; ".join(f"{f} {v['kernels']} device kernels, {v['device_ms']:.4f} ms"
                               for f, v in out.items()))
    return dict(tag=tag, **out)


def slot_kmap(up_parent: torch.Tensor, up_koffset: torch.Tensor, c_coarse: int) -> torch.Tensor:
    """(B, 8, C_fine) int32: the parent where the fine row's slot is k, else
    the sentinel c_coarse: the transposed conv as a gather conv over 8
    offsets (the route the tconv kernel was measured against)."""
    k = torch.arange(8, dtype=torch.int32, device=up_parent.device)[None, :, None]
    return torch.where(up_koffset[:, None, :] == k, up_parent[:, None, :],
                       c_coarse).to(torch.int32).contiguous()


def tconv_row(tag, args, kernels, cycles_per_ms) -> dict:
    """One transposed-conv call (feats, up_parent, up_koffset, kernel): the
    kernel at each column slice over a slot order built beforehand, the slot
    order alone, the all-slot product, the slot-map gather conv; each
    output held against the all-slot product."""
    feats, up_parent, up_koffset, kernel = args[:4]
    c_coarse, f_out = feats.shape[1], kernel.shape[2]
    slots = kernels.slot_order(up_parent, up_koffset, c_coarse)
    kmap = slot_kmap(up_parent, up_koffset, c_coarse)
    want = kernels.tconv_plain(feats, up_parent, up_koffset, kernel)
    runs = {f"tconv cols {c}": (lambda c=c: kernels._tconv_cuda(feats, up_parent, kernel,
                                                                 slots, c))
            for c in (32, 64) if f_out % c == 0}
    runs["gather_conv slot map"] = lambda: kernels.gather_conv(feats, kmap, kernel)
    for name, run in runs.items():
        chip_smoke.compare("tconv", run(), want)
    runs["slot_order"] = lambda: kernels.slot_order(up_parent, up_koffset, c_coarse)
    runs["all-slot"] = lambda: kernels.tconv_plain(feats, up_parent, up_koffset, kernel)
    times = {name: chip_smoke.device_ms(run, cycles_per_ms, reps=10) for name, run in runs.items()}
    nbytes, ops, _ = chip_smoke.work("tconv", args, {}, want)
    times["bound"] = chip_smoke.tc_bound_ms("tconv", nbytes, ops)
    rule = f"tconv cols {kernels.tconv_cols(f_out)}"
    chip_smoke.log(f"[{tag}] tconv {chip_smoke.call_desc('tconv', args)}: "
                   + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
                   + f" ms; rule {rule}; bound by "
                   + ("bytes" if nbytes / chip_smoke.HBM_BYTES_PER_S >=
                      3 * ops / chip_smoke.TF32_OPS_PER_S else "operations")
                   + f", the rule at {100 * times['bound'] / times[rule]:.1f}% of it")
    return dict(tag=tag, name="tconv", call=chip_smoke.call_desc("tconv", args), times=times,
                rule=rule, bytes=nbytes, ops=ops)


def _staged_chunk_tconv_calls(kernels, device) -> list:
    """The tconv calls of a MinkLoc3Dv2 forward on a staged chunk of 128
    submaps."""
    from benchmark.core import submaps
    from egonn_tpu_torch import inference
    from egonn_tpu_torch.config import ModelParams
    from egonn_tpu_torch.models.factory import model_factory

    v2 = model_factory(ModelParams(str(chip_smoke.ROOT / "model_configs" / "minkloc3dv2.txt")),
                       device=device, seed=chip_smoke.SEED)
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    chunk = submaps.make_places(gen, 32, 4, 4096).reshape(128, 4096, 3)
    ones = torch.ones(chunk.shape[:2], dtype=torch.bool, device=device)
    return [c for c in chip_smoke.record_calls(
        kernels, lambda: inference.forward(v2, chunk, ones)) if c[0] == "tconv"]


def tconv_rows(kernels, device, cycles_per_ms) -> list:
    """The transposed convs of a MinkLoc3D forward at the b64 cell's batch
    and of a MinkLoc3Dv2 forward on a staged chunk of 128 submaps."""
    from egonn_tpu_torch import inference
    from egonn_tpu_torch.models.factory import model_factory

    mink = model_factory(chip_smoke._minkloc_params(), cap0=chip_smoke.MINKLOC_CAP0,
                         device=device, seed=chip_smoke.SEED + 3)
    clouds, mask = chip_smoke.make_inputs(device, b=64)
    calls = [("minkloc_b64", c) for c in chip_smoke.record_calls(
        kernels, lambda: inference.forward(mink, clouds, mask)) if c[0] == "tconv"]
    del clouds, mask
    calls += [("staged_chunk", c) for c in _staged_chunk_tconv_calls(kernels, device)]
    with torch.no_grad():
        return [tconv_row(tag, args, kernels, cycles_per_ms) for tag, (_, args, _, _) in calls]


def tconv_dw_row(tag, args, kernels, cycles_per_ms) -> dict:
    """The weight gradient of one transposed-conv call (feats, up_parent,
    up_koffset, kernel) for a seeded g on the rows with a parent: the kernel
    over the slot order at the rule's slice and 1/2, 1 and 2 times its chunk
    count and at 32 x 32 slices (as many blocks); the kmap_down route (the
    map inverted beforehand, then gather_dw of g over it against the coarse
    features, transposed: dW[k]^T); the plain form; each output held
    against the plain form."""
    feats, up_parent, up_koffset, kernel = args[:4]
    b, c_coarse, f_in = feats.shape
    c_fine, f_out = up_parent.shape[1], kernel.shape[2]
    gen = torch.Generator(device=feats.device).manual_seed(chip_smoke.SEED)
    g = torch.randn((b, c_fine, f_out), generator=gen, device=feats.device)
    g = g * (up_parent < c_coarse)[..., None]
    slots = kernels.slot_order(up_parent, up_koffset, c_coarse)
    kmap_down = kernels.invert_up(up_parent, up_koffset, c_coarse)
    want = kernels.tconv_dw_plain(feats, up_parent, up_koffset, g)
    mb, nb, n = kernels.tconv_dw_tiling(b, c_fine, f_in, f_out)
    settings = [(mb, nb, c) for c in sorted({max(1, n // 2), n, 2 * n})]
    if (mb, nb) != (32, 32):  # as many blocks as the rule's
        settings.append((32, 32, max(1, n * 32 * 32 // (mb * nb))))
    runs = {f"slots {m}x{k} chunks {c}": (
        lambda m=m, k=k, c=c: kernels._tconv_dw_cuda(feats, up_parent, slots, g, (m, k, c)))
        for m, k, c in settings}
    runs["kmap_down (gather_dw)"] = lambda: kernels.gather_dw(g, kmap_down, feats).transpose(1, 2)
    for name, run in runs.items():
        chip_smoke.compare("tconv_dw", run(), want)
    runs["plain"] = lambda: kernels.tconv_dw_plain(feats, up_parent, up_koffset, g)
    times = {name: chip_smoke.device_ms(run, cycles_per_ms, reps=10) for name, run in runs.items()}
    dw_args = (feats, up_parent, up_koffset, g)
    nbytes, ops, _ = chip_smoke.work("tconv_dw", dw_args, {}, want)
    times["bound"] = chip_smoke.tc_bound_ms("tconv_dw", nbytes, ops)
    rule = f"slots {mb}x{nb} chunks {n}"
    best = min((k for k in runs if k != "plain"), key=times.get)
    chip_smoke.log(f"[{tag}] tconv_dw {chip_smoke.call_desc('tconv_dw', dw_args)}: "
                   + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
                   + f" ms; rule {rule}, fastest {best}; bound by "
                   + ("bytes" if nbytes / chip_smoke.HBM_BYTES_PER_S >=
                      3 * ops / chip_smoke.TF32_OPS_PER_S else "operations")
                   + f", the rule at {100 * times['bound'] / times[rule]:.1f}% of it")
    return dict(tag=tag, name="tconv_dw", call=chip_smoke.call_desc("tconv_dw", dw_args),
                times=times, rule=rule, fastest=best, bytes=nbytes, ops=ops)


def tconv_dw_rows(kernels, device, cycles_per_ms) -> list:
    """The weight gradients of a MinkLoc3Dv2 staged chunk's transposed convs
    and of EgoNN's heads' on the train step's global batch (32 clouds), at
    the maps and features of their forwards."""
    from egonn_tpu_torch import inference
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.ops.quantization import PolarQuantizer

    calls = [("staged_chunk", c) for c in _staged_chunk_tconv_calls(kernels, device)]
    mp = types.SimpleNamespace(model="egonn", quantizer=PolarQuantizer([1.0, 0.3, 0.2]),
                               cap0=chip_smoke.CAP0)
    built = create_egonn_model(mp, cap0=chip_smoke.CAP0, device=device, seed=chip_smoke.SEED)
    clouds, mask = chip_smoke.make_inputs(device, b=32)
    calls += [("egonn_b32", c) for c in chip_smoke.record_calls(
        kernels, lambda: inference.forward(built, clouds, mask)) if c[0] == "tconv"]
    with torch.no_grad():
        return [tconv_dw_row(tag, args, kernels, cycles_per_ms)
                for tag, (_, args, _, _) in calls]


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_kernels: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:] not in ([], ["bf16"], ["tconv"], ["tconv_dw"]):
        print(f"probe_kernels: unknown arguments {sys.argv[1:]} (none, `bf16`, `tconv` or "
              "`tconv_dw`)", file=sys.stderr)
        return 2
    from egonn_tpu_torch import inference
    from egonn_tpu_torch.models.factory import create_egonn_model, model_factory
    from egonn_tpu_torch.ops.quantization import PolarQuantizer
    from egonn_tpu_torch.sparse import cuda_lib, kernels

    os.environ.pop("EGONN_BF16_ACTS", None)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.phase_environment(cuda_lib)
    device = torch.device("cuda")
    cycles_per_ms = chip_smoke._sleep_cycles_per_ms()
    tconv = (tconv_rows(kernels, device, cycles_per_ms)
             if sys.argv[1:] in ([], ["tconv"]) else [])
    tconv_dw = (tconv_dw_rows(kernels, device, cycles_per_ms)
                if sys.argv[1:] in ([], ["tconv_dw"]) else [])
    if sys.argv[1:] in (["tconv"], ["tconv_dw"]):
        chip_smoke.OUT_DIR.mkdir(exist_ok=True)
        (chip_smoke.OUT_DIR / "probe_kernels.json").write_text(
            json.dumps(dict(card=smi, tconv=tconv, tconv_dw=tconv_dw), indent=1))
        chip_smoke.log(f"card: {smi}")
        return 0
    mp = types.SimpleNamespace(model="egonn", quantizer=PolarQuantizer([1.0, 0.3, 0.2]),
                               cap0=chip_smoke.CAP0)
    built = create_egonn_model(mp, cap0=chip_smoke.CAP0, device=device, seed=chip_smoke.SEED)
    clouds, mask = chip_smoke.make_inputs(device)
    step, g, l, lr = _train_step(device)
    mink = model_factory(chip_smoke._minkloc_params(), cap0=chip_smoke.MINKLOC_CAP0,
                         device=device, seed=chip_smoke.SEED + 3)
    os.environ["EGONN_BF16_ACTS"] = "1"
    try:
        paths = {"bf16_forward": chip_smoke.record_calls(
            kernels, lambda: inference.forward(built, clouds, mask)),
                 "bf16_train": chip_smoke.record_calls(
            kernels, lambda: step(g, l, torch.Generator(device=device).manual_seed(0), lr, True))}
    finally:
        os.environ.pop("EGONN_BF16_ACTS", None)
    # MinkLoc's convs (its model keeps f32 activations) and phase 7's
    # ResNet-width conv and dW calls that take one bf16 launch, in bf16
    paths["bf16_minkloc"] = [
        (name, (args[0].to(torch.bfloat16), *args[1:]), kwargs, x)
        for name, args, kwargs, x in chip_smoke.record_calls(
            kernels, lambda: inference.forward(mink, clouds, mask))
        if name == "gather_conv" and args[0].shape[-1] % 8 == 0]
    rng = np.random.default_rng(chip_smoke.SEED)
    paths["bf16_wide"] = [
        (name, tuple(a.to(torch.bfloat16) if a.is_floating_point() and (i == 0 or name ==
                                                                          "gather_dw") else a
                     for i, a in enumerate(chip_smoke._wide_call(rng, name, k_vol, f_in, f_out,
                                                                 device))), {}, None)
        for name, k_vol, f_in, f_out in chip_smoke.WIDE_CALLS
        if name != "tdown" and kernels.width_plan(
            f_in, f_out, dw=name == "gather_dw", bf16=True) == kernels.WidthPlan(
            f_in, f_out, ((0, f_in),), ((0, f_out),))]
    builds = []
    if sys.argv[1:] != ["bf16"]:
        builds = _f32_paths(paths, built, clouds, mask, device, (step, g, l, lr), mink)
    del step
    rows, seen = [], set()
    with torch.no_grad():
        for tag, calls in paths.items():
            for name, args, kwargs, _ in calls:
                # the validation step's tdown calls, the bf16 train step's conv and
                # dW calls (the stem is f32 on every path: swept on the f32 ones;
                # the transposed conv and its dW have rows of their own,
                # `tconv_rows`, `tconv_dw_rows`)
                if (name in ("lookup", "tconv", "slot_order", "tconv_dw")
                        or (tag == "val" and name != "tdown")
                        or (tag in ("bf16_train", "bf16_minkloc", "bf16_wide")
                            and name not in ("gather_conv", "gather_dw"))
                        or (tag == "bf16_forward" and name == "stem_ones")):
                    continue
                shapes = chip_smoke._shape(args)
                key = (tag, name, str(shapes), kwargs.get("epi") is not None)
                if key not in seen:
                    seen.add(key)
                    rows.append(sweep(tag, name, args, kwargs, kernels, cuda_lib,
                                      cycles_per_ms))
    chip_smoke.OUT_DIR.mkdir(exist_ok=True)
    (chip_smoke.OUT_DIR / "probe_kernels.json").write_text(
        json.dumps(dict(card=smi, rows=rows, map_builds=builds, tconv=tconv,
                        tconv_dw=tconv_dw), indent=1))
    chip_smoke.log(f"card: {smi}")
    return 0


def _train_step(device) -> tuple:
    """chip_smoke's phase 4 train step and batch: (step, g, l, lr)."""
    from egonn_tpu_torch.config import TrainingParams
    from egonn_tpu_torch.data.train_batch import make_train_batch
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.train.state import make_lr_schedule
    from egonn_tpu_torch.train.trainer import make_train_step

    root = chip_smoke.ROOT
    tp = TrainingParams(str(root / "config" / "config_egonn.txt"),
                        str(root / "model_configs" / "egonn.txt"), require_dataset=False)
    built_t = create_egonn_model(tp.model_params, cap0=chip_smoke.CAP0, device=device,
                                 seed=chip_smoke.SEED + 1)
    g, l = make_train_batch(tp, built_t.quantizer, device, n_places=chip_smoke.N_PLACES,
                            n_points=chip_smoke.N_POINTS, seed=chip_smoke.SEED)
    return make_train_step(built_t, tp), g, l, make_lr_schedule(tp)(0)


def _f32_paths(paths, built, clouds, mask, device, train, mink) -> list:
    """Adds the f32 paths' recorded calls to `paths` (`train`: `_train_step`'s
    step, batch and lr; `mink` the MinkLoc model); returns the lookup-built
    map builds' device kernels."""
    from egonn_tpu_torch import inference
    from egonn_tpu_torch.models.factory import model_factory
    from egonn_tpu_torch.sparse import kernels
    from egonn_tpu_torch.sparse import pyramid as pyramid_mod

    paths["forward"] = chip_smoke.record_calls(
        kernels, lambda: inference.forward(built, clouds, mask))
    step, g, l, lr = train
    gen = torch.Generator(device=device).manual_seed(0)
    paths["train"] = chip_smoke.record_calls(kernels, lambda: step(g, l, gen, lr, True))
    # the validation step (three eval forwards): tdown's largest user
    paths["val"] = chip_smoke.record_calls(kernels, lambda: step(g, l, None, lr, False))
    paths["minkloc"] = chip_smoke.record_calls(
        kernels, lambda: inference.forward(mink, clouds, mask))
    # the stem at the embed cells' shapes: the 8 clouds' level-0 maps repeated
    # to 128 (EgoNN) and 64 (MinkLoc3D) clouds
    paths["stem_cells"] = []
    for tag, reps in (("forward", 16), ("minkloc", 8)):
        _, (kmap, kernel, n_in), _, _ = next(c for c in paths[tag] if c[0] == "stem_ones")
        paths["stem_cells"].append(("stem_ones", (kmap.repeat(reps, 1, 1), kernel, n_in), {},
                                    None))
    rng = np.random.default_rng(chip_smoke.SEED)
    paths["wide"] = [(name, chip_smoke._wide_call(rng, name, k_vol, f_in, f_out, device), {},
                      None) for name, k_vol, f_in, f_out in chip_smoke.WIDE_CALLS
                     if name != "tdown" and kernels.width_plan(f_in, f_out) == kernels.WidthPlan(
                         f_in, f_out, ((0, f_in),), ((0, f_out),))]
    # the lookup-built down maps: EgoNN without up maps, MinkLoc with level
    # 2's alone, ResNet14's spec on MinkLoc's quantizer
    res_spec = chip_smoke.resnet_spec(pyramid_mod)
    for tag, q, spec in (("maps", built.quantizer,
                          dataclasses.replace(built.pyramid_spec, up_levels=())),
                         ("minkloc_lookup", mink.quantizer,
                          dataclasses.replace(mink.pyramid_spec, up_levels=(2,))),
                         ("resnet", mink.quantizer, res_spec)):
        res = q.quantize(clouds, mask, spec.capacities[0], need_index=False)
        paths[tag] = [c for c in chip_smoke.record_calls(kernels, lambda: pyramid_mod.build_pyramid(
            res.coords_t, res.mask, spec, keys0=res.keys)) if c[0] == "lookup_down"]
    return [map_build_kernels(tag, kernels, paths[tag][0][1])
            for tag in ("maps", "minkloc_lookup", "resnet")]


if __name__ == "__main__":
    sys.exit(main())
