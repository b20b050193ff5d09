"""Shared pieces of the benchmark's tests.

The tests run on the CPU at a tiny size through the harness's own code
(`harness.run` with `overrides`); tests marked `card` need a CUDA card and
run the cells at their own size (`python -m pytest benchmark/tests -m
card` on the chip). Whether there is a card is decided inside the `card`
fixture, never while a module is imported.
"""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# a tiny model and data for every configuration, and what each traffic
# mix needs to fit it
TINY_CONFIG = {'n_var': 12, 'units': [8, 8, 6, 6], 'dim': 4,
               'num_codes': 16, 'n_train': 200, 'n_valid': 40,
               'n_test': 50}
TINY_TRAFFIC = {'train': {'batch': 8}, 'cmll': {'burn_in': 3},
                'score': {'max_rows': 30, 'size_block': 16,
                          'requests': 320, 'check_requests': 20,
                          'rate_per_s': 200, 'traced_seconds': 0.2}}


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card; run on the chip with -m card')


def tiny(driver: str) -> dict:
    return {'config': dict(TINY_CONFIG),
            'traffic': dict(TINY_TRAFFIC[driver])}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: run on the chip with -m card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return 'cuda:0'


@pytest.fixture
def cpu_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
