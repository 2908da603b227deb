"""Kernel launch counts, one set per kernel module.

Each wrapper adds one to its count where it launches its kernel, on the
CUDA path only.  Launches made while a CUDA graph is captured run only when
the graph is replayed: the capturing thread records them (``recording``)
instead of counting them, and the engine credits what it recorded on every
replay (``credit``).
"""

from __future__ import annotations

import contextlib
import threading

_local = threading.local()
_ALL: list["LaunchCounts"] = []  # every wrapper module's counts, in import order


class LaunchCounts:
    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(names, 0)  # guarded-by: _lock
        _ALL.append(self)

    def count(self, name: str) -> None:
        recorded = getattr(_local, "recorded", None)
        if recorded is not None:  # a launch into a graph under capture
            mine = recorded.setdefault(self, {})
            mine[name] = mine.get(name, 0) + 1
            return
        with self._lock:
            self._counts[name] += 1

    def snapshot(self) -> dict[str, int]:
        """Kernel launches per wrapper since the last reset (CUDA path only)."""
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            for k in self._counts:
                self._counts[k] = 0

    def credit(self, counts: dict[str, int]) -> None:
        """Add launches that ran without their wrapper: a graph's replay."""
        with self._lock:
            for k, n in counts.items():
                self._counts[k] += n


def totals() -> dict[str, int]:
    """Every imported wrapper's launches since its last reset, by name."""
    out: dict[str, int] = {}
    for counts in list(_ALL):
        out.update(counts.snapshot())
    return out


@contextlib.contextmanager
def recording():
    """Within the block, this thread's launches are recorded, not counted;
    yields ``{LaunchCounts: {wrapper: launches}}``."""
    recorded: dict[LaunchCounts, dict[str, int]] = {}
    _local.recorded = recorded
    try:
        yield recorded
    finally:
        _local.recorded = None


def credit(recorded: dict[LaunchCounts, dict[str, int]]) -> None:
    """Count what ``recording`` recorded, once (one replay)."""
    for counts, launches in recorded.items():
        counts.credit(launches)
