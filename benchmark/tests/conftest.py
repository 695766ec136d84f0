"""Tests of the benchmark harness.  They run on the CPU at small sizes:
``pytest benchmark/tests``.  A test marked ``chip`` needs a CUDA card; it
decides inside the test and skips without one."""
import json
from pathlib import Path

import pytest

from benchmark.harness import cell

#: ``tiny/<cell>.json``: the small sizes of each cell, for the CPU (a few
#: atoms and frames, small k-sets, every k of a checked call compared), as
#: ``run_cell``'s ``overrides``.
TINY = Path(__file__).resolve().parent / 'tiny'


class SmallSizes(dict):
    """The small sizes of the cells that have them; a test that asks for a
    cell without them skips (``test_every_cell_has_its_small_sizes`` fails
    for that cell)."""

    def __missing__(self, name):
        pytest.skip(f"{name} has no small sizes: no {TINY.name}/{name}.json")


def small_sizes(names) -> SmallSizes:
    return SmallSizes({n: json.loads((TINY / f'{n}.json').read_text())
                       for n in names if (TINY / f'{n}.json').is_file()})


def pytest_configure(config):
    config.addinivalue_line('markers', 'chip: needs an NVIDIA GPU (CUDA); skipped without one')


@pytest.fixture
def tiny():
    return small_sizes(w['name'] for w in cell.load_spec()['workloads'])
