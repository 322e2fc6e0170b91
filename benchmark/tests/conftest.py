"""The benchmark's tests: on the CPU at small sizes, and under the marker
`card` on a CUDA card at the cells' own sizes (they skip without one; the
card is looked for inside each test, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")
