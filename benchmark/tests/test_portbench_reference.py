"""The reference held against the port's CPU path (its kernels' plain
versions) at a small size: quantizers, the pyramid and its maps, the
EgoNN and MinkLoc3D forwards (ECA blocks, GeM, the local head), the train
step (augmentation, both losses, autograd, Adam with coupled L2), and the
work records the rooflines count.  The tests import the port; the
reference does not."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark.core import scans, weights, work
from benchmark.core.train_batch import make_train_batch
from benchmark.reference import models as rm
from benchmark.reference import sparse
from benchmark.reference import train as rt
from benchmark.models import egonn, minkloc3d_mulran
from conftest import REPO

ADAPTERS = {"egonn": egonn, "minkloc3d_mulran": minkloc3d_mulran}


def _cfg(name: str, cap0: int) -> dict:
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    cfg["model"]["cap0"] = cap0
    return cfg


def _weighted(name: str, cap0: int, seed: int = 3):
    cfg = _cfg(name, cap0)
    adapter = ADAPTERS[name]
    model, quantizer, spec = adapter.reference(cfg)
    state = weights.seeded_state({k: v.shape for k, v in model.state_dict().items()},
                                 rm.param_kinds(model), seed, "cpu")
    model.load_state_dict(state)
    built = adapter.program(cfg, "cpu")
    built.model.load_state_dict(state)
    return cfg, built, model.eval(), quantizer, spec


def _clouds(b: int, n: int, seed: int = 1):
    clouds = scans.lidar_scans(b, n, scans.generator("cpu", seed))
    return clouds, torch.ones(clouds.shape[:2], dtype=torch.bool)


@pytest.mark.parametrize("name,cap0", [("egonn", 1024), ("minkloc3d_mulran", 2048)])
def test_pyramid_and_maps_equal_the_ports(name, cap0):
    from egonn_tpu_torch.sparse.pyramid import build_pyramid

    cfg, built, _, quantizer, spec = _weighted(name, cap0)
    clouds, mask = _clouds(2, 4096)
    res = built.quantizer.quantize(clouds, mask, built.pyramid_spec.capacities[0],
                                   need_index=False)
    port = build_pyramid(res.coords_t, res.mask, built.pyramid_spec, keys0=res.keys,
                         with_kmap_down=True)
    keys, _, n_unique = sparse.quantize(quantizer, clouds, mask, spec.capacities[0], spec.pack)
    assert torch.equal(keys, res.keys) and torch.equal(n_unique, res.n_unique)
    ref = sparse.build_pyramid(keys, spec)
    assert spec.capacities == built.pyramid_spec.capacities
    for l, (a, b) in enumerate(zip(port.levels, ref)):
        assert torch.equal(a.coords, b.coords) and torch.equal(a.mask, b.mask)
        c = a.mask.shape[1]
        if l == 0:  # the stem's map records presence only
            assert torch.equal(a.kmap_self < c, b.kmap_self < c)
        else:
            assert torch.equal(a.kmap_self, b.kmap_self)
            assert torch.equal(a.kmap_down, b.kmap_down)
        if l < len(ref) - 1:
            assert torch.equal(a.up_parent, b.up_parent)
            assert torch.equal(a.up_koffset, b.up_koffset)


@pytest.mark.parametrize("name,cap0", [("egonn", 1024), ("minkloc3d_mulran", 2048)])
def test_forward_matches_the_ports(name, cap0):
    from egonn_tpu_torch import inference

    _, built, model, quantizer, spec = _weighted(name, cap0)
    clouds, mask = _clouds(2, 4096)
    with torch.no_grad():
        port = inference.forward(built, clouds, mask)
        log = []
        with rm.record_work(log):
            ref = rt.forward(model, quantizer, spec, clouds, mask)
    assert set(port) == set(ref)
    for k in ref:
        if k == "kp_mask":
            assert torch.equal(port[k], ref[k])
        else:
            torch.testing.assert_close(port[k], ref[k], rtol=1e-5, atol=1e-5 * ref[k].abs().max())
    # the records: every conv of the model, eval mode, valid entries counted
    roles = [r["role"] for r in log]
    n_levels = len(cfg_planes := _cfg(name, cap0)["model"]["planes"])
    assert roles.count("self") == 2 * n_levels and roles.count("down") == n_levels
    assert roles.count("ones") == 1
    assert all(not r["train"] and r["nnz"] > 0 for r in log)
    assert work.total_ops(log) > 0 and work.least_seconds(log) > 0
    assert len(cfg_planes) == n_levels


def test_train_step_matches_the_ports():
    from egonn_tpu_torch.train.trainer import make_train_step

    cfg, built, model, quantizer, spec = _weighted("egonn", 1024)
    t = cfg["train"]
    g, l = make_train_batch(quantizer, scans.generator("cpu", 9), 2, 2, 2048, t["rot_max"],
                            t["trans_max"])
    step = make_train_step(built, egonn.train_params(cfg))
    stats = step(g, l, scans.generator("cpu", 10), t["lr"], True)
    opt = step.state.optimizer
    port_grad = {n: opt.state[p]["exp_avg"] / (1 - 0.9) for n, p in built.model.named_parameters()}

    adam = rt.Adam(dict(model.named_parameters()), t["lr"], t["weight_decay"])
    log = []
    with rm.record_work(log):
        loss, grads, parts = rt.train_step(model, quantizer, spec, adam, g, l,
                                    scans.generator("cpu", 10), t)
    torch.testing.assert_close(stats["loss"], loss, rtol=1e-5, atol=0)
    for k, v in parts.items():  # the loss's parts under the program's stats names
        assert abs(float(stats[k]) - v) <= 1e-5 * max(1.0, abs(v)), k
    for n, gr in grads.items():
        torch.testing.assert_close(port_grad[n], gr, rtol=2e-3, atol=2e-4 * gr.abs().max() + 1e-12)
    # Adam's first step moves every element by lr times the sign of its
    # gradient, so the rare element whose gradient is round-off may move
    # another way; every other element agrees
    port_state = built.model.state_dict()
    for n, v in model.state_dict().items():
        diff = (port_state[n] - v).abs()
        assert float((diff > 1e-5).float().mean()) < 1e-3 and float(diff.max()) <= 2.01 * t["lr"]
    # backward records: each self conv's dX and dW, the down convs' dW
    roles = {r["role"] for r in log}
    assert {"self", "down", "tconv", "self_dx", "self_dw", "down_dw", "tconv_dx"} <= roles
    kinds = {work.kernel_of(r) for r in log}
    assert {"gather_conv", "gather_dw"} <= kinds


def test_adam_is_torch_adam_with_coupled_decay():
    gen = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(5, 3, generator=gen), "b": torch.randn(7, generator=gen)}
    mine = {k: torch.nn.Parameter(v.clone()) for k, v in p.items()}
    theirs = [torch.nn.Parameter(v.clone()) for v in p.values()]
    adam = rt.Adam(mine, 1e-3, 1e-4)
    opt = torch.optim.Adam(theirs, lr=1e-3, weight_decay=1e-4)
    for _ in range(3):
        grads = [torch.randn(v.shape, generator=gen) for v in p.values()]
        for q, g in zip(mine.values(), grads):
            q.grad = g.clone()
        for q, g in zip(theirs, grads):
            q.grad = g.clone()
        adam.step()
        opt.step()
    for q, r in zip(mine.values(), theirs):
        torch.testing.assert_close(q, r, rtol=0, atol=1e-7)
