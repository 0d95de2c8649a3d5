"""Fixtures of the benchmark's CPU tests."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout-shaped tree whose cells run at test sizes."""
    from gnnbench.tests import tinyroot

    return tinyroot.make(str(tmp_path_factory.mktemp("gnnbench")))


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
