"""Training checkpoint and resume (the port of ``training/checkpoint.py``).

Periodic snapshots of the whole ``TrainState`` (step, parameters, batch
statistics, optimizer state) with retention, and restore into a live
state, so an interrupted run resumes at its last saved step.

The file format is the port's own (the JAX package writes orbax):
``<dir>/<step>/state.pt``, one ``torch.save`` of plain tensors, ints and
dicts, read back with ``torch.load(weights_only=True)``.  Each snapshot is
written into ``<dir>/.tmp-<step>`` and renamed into place, so a reader
never sees half a checkpoint and a scan skips a crashed write.

``save`` copies the state to host memory synchronously, then writes it on
a background thread: the training loop updates the parameters and the
optimizer state in place, and a writer that read device memory after
``save`` returned would see the next steps' values.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import shutil
from typing import Any

import torch

STATE_FILE = "state.pt"


def _to_host(x: Any) -> Any:
    """A host copy of every tensor in a nested dict / list (never a view
    of a tensor the training loop goes on to update)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


class Checkpointer:
    """Snapshots of a ``TrainState`` under ``directory``, keeping the
    newest ``max_to_keep``.  Writes run on one background thread;
    ``wait()`` joins them and raises the first write error."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(1, "kdlt-torch-ckpt")
        self._pending: list[concurrent.futures.Future] = []

    def all_steps(self) -> list[int]:
        """Steps on disk, ascending (written and renamed into place)."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if re.fullmatch(r"\d+", d)
                      and os.path.isfile(os.path.join(self.directory, d, STATE_FILE)))

    def save(self, state) -> bool:
        """Snapshot ``state`` at its own step; False (nothing written) when
        that step is already saved."""
        step = int(state.step)
        self.wait()
        if step in self.all_steps():
            return False
        snapshot = _to_host({
            "step": step,
            "params": state.params,
            "batch_stats": state.batch_stats,
            "optimizer": state.optimizer.state_dict(),
        })
        self._pending.append(self._pool.submit(self._write, step, snapshot))
        return True

    def _write(self, step: int, snapshot: dict) -> None:
        final = os.path.join(self.directory, str(step))
        staging = os.path.join(self.directory, f".tmp-{step}")
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging)
        torch.save(snapshot, os.path.join(staging, STATE_FILE))
        os.rename(staging, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def latest_step(self) -> int | None:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state):
        """Load the latest snapshot into the live ``state``: parameters and
        statistics copied in place, the optimizer's state loaded, the step
        set.  Returns ``state``, or None when there is no checkpoint yet."""
        step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step), STATE_FILE)
        snap = torch.load(path, map_location="cpu", weights_only=True)
        for name in ("params", "batch_stats"):
            live, saved = getattr(state, name), snap[name]
            if live.keys() != saved.keys():
                raise ValueError(f"checkpoint {path} {name} keys differ from the state's")
            with torch.no_grad():
                for k, t in live.items():
                    t.copy_(saved[k])
        state.optimizer.load_state_dict(snap["optimizer"])
        state.step = int(snap["step"])
        return state

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
