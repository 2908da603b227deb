"""Torch on one thread in test files that run torch beside a JAX program.

The suite runs its files in several processes at once (pytest-xdist).
torch's default of one intra-op thread a core in each process, whose
OpenMP workers spin between small operations, beside XLA's own pool in the
same process and the pools of the other processes, starves them all: a
plain int8 conv that takes a second alone took minutes under six workers.

A test file takes the fixture by importing it::

    from torch_threads import one_torch_thread  # noqa: F401
"""

from __future__ import annotations

import contextlib

import pytest
import torch


@contextlib.contextmanager
def torch_threads(n: int = 1):
    """Run with ``n`` torch threads, then restore the count."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    with torch_threads():
        yield
