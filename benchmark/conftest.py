"""pytest settings of the benchmark's own tests (benchmark/tests).

Registers the `card` marker: a test so marked needs an NVIDIA card and is
skipped without one, decided by the `card` fixture when the test runs,
never while a module is imported.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skipped on a machine "
        "without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the benchmark on a card")
    return torch.device("cuda")
