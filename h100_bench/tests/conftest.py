"""CPU tests of the benchmark, and its card-only tests (marked ``cuda``:
run them on a card with ``python -m pytest -m cuda h100_bench/tests``)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; decides inside the test")
