"""Loaded by pytest before any other conftest of the repository: gives each
configuration of `benchmark/configs/` that the benchmark tests' CPU-size
table (`benchmark/tests/conftest.py::SMALL_CAP0`) lacks its entry, the cap0
its file already holds, so that `make_small_copy` copies every
configuration of the folder whichever test files run.  The table is found
on the conftest module pytest loaded from `benchmark/tests/` by its path;
nothing happens where it is not loaded."""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCH_TESTS_CONFTEST = ROOT / "benchmark" / "tests" / "conftest.py"


def pytest_collection_modifyitems(session, config, items):
    for plugin in config.pluginmanager.get_plugins():
        path = getattr(plugin, "__file__", None)
        if path and Path(path).resolve() == BENCH_TESTS_CONFTEST:
            for cfg_path in sorted((ROOT / "benchmark" / "configs").glob("*.json")):
                cfg = json.loads(cfg_path.read_text())
                plugin.SMALL_CAP0.setdefault(cfg["name"], cfg["model"]["cap0"])
