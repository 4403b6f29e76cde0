"""CPU tests of the benchmark's harness: ``python -m pytest bench/tests``
from the root of the checkout. Tests marked ``gpu`` need a CUDA card and
skip without one."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT, Path(__file__).parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench_tiny import tiny_config  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture
def tiny_cell():
    """A cell of BENCHMARK.json on a tiny configuration of the same
    network, or of the spec chain ``specs``, its traffic slowed to what the
    CPU serves."""
    from bench import harness

    def make(workload: str, specs=None, **traffic):
        cell = copy.deepcopy(harness.load_cell(workload))
        cell.config = tiny_config(cell.config["name"], specs)
        cell.traffic.update(traffic)
        return cell
    return make
