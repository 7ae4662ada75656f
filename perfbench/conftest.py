"""pytest settings of the benchmark's own tests (``perfbench/tests``):

    python -m pytest -o addopts="" perfbench/tests -q             # here, on the CPU
    python -m pytest -o addopts="" perfbench/tests -q -m chip     # on the card

Tests marked ``chip`` need the card; the ``card`` fixture skips them
elsewhere, deciding inside the test, never at import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs the CUDA card (skips elsewhere)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"
