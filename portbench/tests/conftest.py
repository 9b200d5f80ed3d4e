"""The benchmark's own tests (``python -m pytest portbench/tests``), on the
CPU at small sizes; tests marked ``card`` run only where a CUDA card is
present (``python -m pytest portbench/tests -m card`` on the card's
machine) and skip elsewhere."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
