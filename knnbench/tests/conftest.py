"""The harness's own tests, on the CPU (``python -m pytest knnbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and skip inside a
fixture, never at import, where there is none; on the card they run with
the same command."""

from __future__ import annotations

import pytest

from kb_helpers import make_tiny_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
