"""Settings of the benchmark's own tests (`python -m pytest portbench/tests`).

Tests marked `chip` need an NVIDIA card: they take the `card` fixture,
which skips them where none is visible. On the card run them alone with
`python -m pytest portbench/tests -m chip`.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips where none is visible)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run with -m chip on the card")
    return "cuda"
