"""`minkunet34c.segment-b8`: its files load by name and hold the published
sizes; its readers (`metrics/decoder_ms.fwd.py`, `devoxelize_ms.fwd.py`,
`tconv_roofline.fwd.py` over `core/tconv_work.py`) read hand-written
traces and a hand count; at CPU sizes the sound program passes every limit
and each fault of `segment_controls.FAULTS` planted in the program fails
one (the cell run whole, past the harness's look for a card, with the
configuration's capacities cut to the CPU traffic's 2,048 points)."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import segment_controls
from benchmark.core import runner, tconv_work, work
from benchmark.core.layers import LayerContext
from benchmark.reference import models as ref_models
from benchmark.reference import sparse
from conftest import make_small_copy, run_small
from test_portbench_spans import (FWD_HOST, FWD_KERNELS, FWD_SPANS, RED, chrome_trace, context,
                                  fwd_context, read)

CELL, CONFIG = "minkunet34c.segment-b8", "minkunet34c_semantickitti"
NEW_METRICS = ("decoder_ms.fwd", "devoxelize_ms.fwd", "tconv_roofline.fwd")
LISTED = ("idle_share.fwd", "gather_conv_roofline.fwd", "mfu.fwd", "torch_kernels_ms.fwd",
          "quantize_ms.fwd", "pyramid_ms.fwd", "trunk_ms.fwd", "enqueue_ms.fwd",
          "launches.fwd", "syncs.fwd", "tconv_ms.fwd")
TCONV = "void egonn::tconv_kernel<64>(float const*, int const*)"


@pytest.fixture(scope="module")
def segment_bench(tmp_path_factory):
    bench = make_small_copy(tmp_path_factory.mktemp("segment"))
    path = bench / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg["model"]["capacities"] = [2048] * 5
    path.write_text(json.dumps(cfg))
    return bench


def test_cell_loads_by_name():
    workload, cfg, adapter, traffic = runner.load_cell(runner.BENCH_DIR, CELL)
    assert workload["traffic"] == "segment" and cfg["name"] == CONFIG
    assert adapter.OUTPUTS == ("logits",) and hasattr(traffic, "run")
    assert set(workload["limits"]) == {"logits_gap", "point_mask_mismatches", "dropped_voxels"}
    bench = json.loads((runner.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert entry["reduced"] == ["points_range"] == cfg["reduced"]
    assert runner.cell_entry(bench, CELL)["chips"] == 1
    e2e = runner.metrics_of(bench["end_to_end"], CELL)
    assert {m["name"] for m in e2e} == {"clouds_per_s", "setup_s"}
    per_layer = {m["name"] for m in runner.metrics_of(bench["per_layer"], CELL,
                                                      {m["name"] for m in e2e})}
    assert per_layer == set(NEW_METRICS) | set(LISTED)
    for name in per_layer:
        assert (runner.BENCH_DIR / "metrics" / f"{name}.py").is_file()


def test_published_sizes():
    workload, cfg, _, _ = runner.load_cell(runner.BENCH_DIR, CELL)
    m, p = cfg["model"], workload["traffic_params"]
    assert (m["init_dim"], m["planes"], m["layers"]) == (
        32, [32, 64, 128, 256, 256, 128, 96, 96], [2, 3, 4, 6, 2, 2, 2, 2])
    assert (m["in_channels"], m["num_classes"], m["quantization_step"]) == (4, 19, 0.05)
    assert (m["pack_bits"], m["pack_offsets"]) == ([11, 11, 8], [1024, 1024, 128])
    assert (p["batch"], p["points"], p["pool"], p["scene_seed"]) == (8, 131072, 2, 0)


def test_tconv_work_is_a_hand_count():
    """Two coarse voxels, three fine children (two of the first, one of the
    second) and a padding row: 3 useful rows of one slot each."""
    pack = sparse.PackSpec()
    fine = torch.tensor([[[0, 1, 2, 0], [0, 0, 0, 0], [0, 0, 0, 0]]], dtype=torch.int32)
    keys = sparse.pack_keys(fine, torch.tensor([[True, True, True, False]]), pack)
    keys, _, _, _ = sparse.dedup(keys, 4)
    levels = sparse.build_pyramid(keys, sparse.PyramidSpec((4, 4), 3, 3, pack))
    feats = torch.ones(1, 4, 6)
    with ref_models.record_work([]) as log:
        ref_models.tconv2x2(feats, levels[0], torch.ones(8, 6, 10))
    (r,) = tconv_work.records(log)
    shape = (r["b"], r["c_in"], r["c_out"], r["f_in"], r["f_out"], r["nnz"])
    assert shape == (1, 4, 4, 6, 10, 3)
    assert tconv_work.ops(r) == 2 * 3 * 6 * 10
    assert tconv_work.nbytes(r) == 4 * (4 * 6 + 2 * 4 + 8 * 6 * 10 + 4 * 10)
    assert tconv_work.least_seconds([r]) == max(tconv_work.nbytes(r) / work.HBM_BYTES_PER_S,
                                                tconv_work.ops(r) / work.F32_OPERAND_OPS_PER_S)


# two forwards of a U-Net: the heads' spans of `test_portbench_spans` as the
# decoder and devoxelization, the global head's reduction a transposed conv
MU_SPANS = [(n.replace("global_head", "decoder").replace("local_head", "devoxelize"), s, e)
            for n, s, e in FWD_SPANS]
MU_KERNELS = [(launch, at, TCONV if kernel == RED else kernel, ks, kd)
              for launch, at, kernel, ks, kd in FWD_KERNELS]
TCONV_RECORD = dict(role="tconv", train=False, b=2, c_in=1000, c_out=2000, f_in=64, f_out=32,
                    k=8, nnz=1500)


def test_readers_leave_a_program_without_the_spans_out(tmp_path):
    _tracer, ctx = fwd_context(tmp_path)
    for name in NEW_METRICS:
        assert read(name, ctx) is None, name


def test_readers_on_a_segmenting_forward(tmp_path):
    _tracer, ctx = context(tmp_path, chrome_trace((0, 1000), MU_SPANS, MU_KERNELS, FWD_HOST),
                           2, [TCONV_RECORD] * 2)
    assert read("decoder_ms.fwd", ctx) == pytest.approx(0.008, rel=1e-12)
    assert read("devoxelize_ms.fwd", ctx) == pytest.approx(0.030, rel=1e-12)
    # the least time of both calls' transposed convs over their 16 us
    want = 100.0 * tconv_work.least_seconds([TCONV_RECORD] * 2) / 16e-6
    assert read("tconv_roofline.fwd", ctx) == pytest.approx(want, rel=1e-9)
    # no transposed conv record: nothing to read
    assert read("tconv_roofline.fwd", LayerContext(ctx.trace, 2, [])) is None


def test_sound_program_is_correct(segment_bench, capsys):
    rc, result = run_small(segment_bench, CELL, capsys)
    assert rc == 0 and result["correct"], result["checks"]
    assert result["checks"]["dropped_voxels"]["value"] == 0
    assert result["checks"]["point_mask_mismatches"]["value"] == 0
    assert set(result["metrics"]) == {"clouds_per_s", "setup_s"}
    # a traced run reads nothing of the device on the CPU, and raises nothing
    rc, result = run_small(segment_bench, CELL, capsys, trace=1)
    assert rc == 0 and result["correct"] and result["metrics"] == {}, result


@pytest.mark.parametrize("fault", sorted(segment_controls.FAULTS))
def test_fault_is_not_correct(segment_bench, fault, capsys):
    with segment_controls.FAULTS[fault]():
        rc, result = run_small(segment_bench, CELL, capsys)
    assert rc == 0 and not result["correct"], result["checks"]
