"""Loaded by pytest before `tests/conftest.py` for any test under
`benchmark/`: gives the configurations added after that file's CPU-size
table (`SMALL_CAP0`) their entry, the cap0 their files already hold, so
that `make_small_copy` copies every configuration of the folder.  The
table is found on the conftest module pytest loaded from `tests/` by its
path, whatever other module holds the name `conftest`."""
from __future__ import annotations

from pathlib import Path

LATER_CAP0 = {"minkloc3dv2_oxford": 4096}
TESTS_CONFTEST = Path(__file__).resolve().parent / "tests" / "conftest.py"


def pytest_collection_modifyitems(session, config, items):
    for plugin in config.pluginmanager.get_plugins():
        path = getattr(plugin, "__file__", None)
        if path and Path(path).resolve() == TESTS_CONFTEST:
            for name, cap0 in LATER_CAP0.items():
                plugin.SMALL_CAP0.setdefault(name, cap0)
