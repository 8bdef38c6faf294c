"""The benchmark's own tests: ``python3 -m pytest benchmarks/tests``
(the CPU cases here; the ``cuda`` cases on a machine with a card)."""

import pytest
import torch

from . import tiny


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped without one")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny-benchmark"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
