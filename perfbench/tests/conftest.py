"""The benchmark's own tests (``python -m pytest -q perfbench/tests`` from
the repository root). ``gpu``-marked tests run on the card and skip here."""

import sys
from importlib.util import find_spec
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_addoption(parser):
    # pyproject.toml's pytest-timeout keys, inert when the plugin is absent.
    if find_spec("pytest_timeout") is None:
        parser.addini("timeout", "per-test timeout (inert)")
        parser.addini("timeout_method", "timeout method (inert)")
