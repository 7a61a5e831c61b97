"""The port stands alone: egonn_tpu_torch and chip_smoke.py import neither JAX
(nor flax, optax, orbax) nor the JAX package, and run on CUDA by default."""
import ast
import inspect
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "egonn_tpu")


def _port_files():
    return sorted((ROOT / "egonn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_pulls_in_no_jax():
    code = ("import sys, egonn_tpu_torch, egonn_tpu_torch.inference, "
            "egonn_tpu_torch.utils.weights, egonn_tpu_torch.data.lidar_sim, "
            "egonn_tpu_torch.train.trainer, egonn_tpu_torch.config, "
            "egonn_tpu_torch.data.train_batch, egonn_tpu_torch.profile_forward, "
            "egonn_tpu_torch.models.factory, egonn_tpu_torch.models.resnet, "
            "egonn_tpu_torch.utils.checkpoint_convert; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_entry_points_default_to_cuda():
    from egonn_tpu_torch.models import factory

    for fn in (factory.create_egonn_model, factory.create_minkloc_model, factory.model_factory):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default) == torch.device("cuda"), fn.__name__
