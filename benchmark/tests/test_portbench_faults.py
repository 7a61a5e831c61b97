"""`correct` comes out false when the timed path is broken underneath: each
cell is run whole (at CPU sizes, past the harness's look for a card) with
one fault planted in the program, once for each fault the cell can have."""
from __future__ import annotations

import pytest
import torch

from conftest import run_small


def _altered_answer(monkeypatch):
    """One cloud's global descriptor changed where it is produced."""
    from egonn_tpu_torch import inference

    real = inference.forward

    def forward(*args, **kwargs):
        out = real(*args, **kwargs)
        out["global"] = out["global"].clone()
        out["global"][0, 0] += 1e-3 * out["global"][0].abs().max()
        return out

    monkeypatch.setattr(inference, "forward", forward)


def _half_the_clouds(monkeypatch):
    """The second half of each batch left out: its outputs are those of the
    first half's first cloud."""
    from egonn_tpu_torch import inference

    real = inference.forward

    def forward(built, clouds, mask, with_local=True):
        if clouds.shape[0] < 2:
            return real(built, clouds, mask, with_local)
        h = clouds.shape[0] // 2
        out = real(built, clouds[:h], mask[:h], with_local)
        return {k: torch.cat([v, v[:1].expand(clouds.shape[0] - h, *v.shape[1:])])
                for k, v in out.items()}

    monkeypatch.setattr(inference, "forward", forward)


def _unchanged_state(monkeypatch):
    """The optimizer's step returns the state unchanged."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_the_batch_after_set_up(monkeypatch):
    """Half of the batch left out from the step after set-up's three on: a
    program that changes what it does once it has run a while."""
    from egonn_tpu_torch.train.trainer import TrainStep

    real, calls = TrainStep.__call__, []

    def call(self, g, l, gen, lr, train):
        calls.append(1)
        if len(calls) > 3:
            hg, hl = g["clouds"].shape[0] // 2, l["anc_clouds"].shape[0] // 2
            g = {k: (v[:hg, :hg] if k.endswith("s_mask") else v[:hg]) for k, v in g.items()}
            l = {k: v[:hl] for k, v in l.items()}
        return real(self, g, l, gen, lr, train)

    monkeypatch.setattr(TrainStep, "__call__", call)


def _doubled_weight_gradients(monkeypatch):
    """Every weight gradient of the gather convs doubled where it is
    produced."""
    from egonn_tpu_torch.sparse import kernels

    real = kernels.gather_dw
    monkeypatch.setattr(kernels, "gather_dw", lambda *args, **kwargs: 2 * real(*args, **kwargs))


def _half_the_batch(monkeypatch):
    """Half of the global batch and of the pairs left out, the means taken
    over the rest."""
    from egonn_tpu_torch.train.trainer import TrainStep

    real = TrainStep.__call__

    def call(self, g, l, gen, lr, train):
        hg, hl = g["clouds"].shape[0] // 2, l["anc_clouds"].shape[0] // 2
        g = {k: (v[:hg, :hg] if k.endswith("s_mask") else v[:hg]) for k, v in g.items()}
        return real(self, g, {k: v[:hl] for k, v in l.items()}, gen, lr, train)

    monkeypatch.setattr(TrainStep, "__call__", call)


FAULTS = [
    ("egonn.embed-b128", _altered_answer),
    ("egonn.embed-b128", _half_the_clouds),
    ("minkloc3d.embed-b64", _altered_answer),
    ("minkloc3d.embed-b64", _half_the_clouds),
    ("egonn.train-b48", _unchanged_state),
    ("egonn.train-b48", _half_the_batch),
    ("egonn.train-b48", _half_the_batch_after_set_up),
    ("egonn.train-b48", _doubled_weight_gradients),
]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_fault_is_not_correct(small_bench, workload, fault, capsys, monkeypatch):
    rc, result = run_small(small_bench, workload, capsys)
    assert rc == 0 and result["correct"], result
    fault(monkeypatch)
    rc, result = run_small(small_bench, workload, capsys)
    assert rc == 0 and not result["correct"], result["checks"]
