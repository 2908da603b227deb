"""Input pipeline: background host-to-device prefetch for the training loop,
synthetic batches and an image-folder reader (the port of
``training/data.py``).

A daemon thread stages the next batches on the device while the current
step runs.  On CUDA it copies from pinned host memory on a side stream of
its own and records an event after each batch; the consumer makes its
current stream wait on that event before it hands the batch out, and
marks the tensors as used on that stream, so neither the copy nor the
caching allocator races the step.  Each batch gets a fresh pinned buffer,
so no host buffer is overwritten while a copy from it is in flight.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from kubernetes_deep_learning_tpu_torch.models import resolve_device
from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
from kubernetes_deep_learning_tpu_torch.ops.preprocess import preprocess_bytes


DEPTH = 2  # batches staged ahead of the consumer


class PrefetchIterator:
    """Wrap an iterator of host batches (tuples of arrays, e.g. (images,
    labels)); yield tuples of tensors on ``device``.

    Errors raised by the host iterator surface at the consuming ``next()``
    call.  ``close()`` stops the producer; the consumer (``loop.fit``)
    calls it on every exit path.
    """

    _DONE = object()

    def __init__(self, source: Iterable, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=DEPTH)
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(iter(source),), name="kdlt-torch-prefetch", daemon=True
        )
        self._thread.start()

    def _put(self, batch):
        """(device batch, event or None)."""
        if self._stream is None:
            return tuple(torch.as_tensor(a) for a in batch), None
        with torch.cuda.stream(self._stream):
            out = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                        .to(self.device, non_blocking=True) for a in batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _enqueue(self, item) -> bool:
        """put() that gives up on close(): with a bounded queue and an
        endless source a plain blocking put would pin this thread (and
        DEPTH + 1 device batches) once the consumer walks away."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it: Iterator) -> None:
        try:
            for batch in it:
                if self._stop.is_set() or not self._enqueue(self._put(batch)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._enqueue(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch:
                t.record_stream(current)
        return batch

    def close(self) -> None:
        """Stop the producer and drop staged batches.  Idempotent."""
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def synthetic_batches(
    spec: ModelSpec, batch: int, steps: int | None = None, seed: int = 0
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Endless (or ``steps``-bounded) random (uint8 images, int32 labels):
    the JAX package's generator, so both give the same batches."""
    rng = np.random.default_rng(seed)
    n = 0
    while steps is None or n < steps:
        images = rng.integers(0, 256, size=(batch, *spec.input_shape), dtype=np.uint8)
        labels = rng.integers(0, spec.num_classes, size=(batch,), dtype=np.int32)
        yield images, labels
        n += 1


def map_batches(source: Iterable, fn: Callable[[Any], Any]) -> Iterator[Any]:
    """Lazy per-batch transform (augmentation hook) on the host side."""
    for batch in source:
        yield fn(batch)


# The JAX reader's extension set: the scan (and so each epoch's order) is
# the same; files outside JPEG and PNG are refused when they are read.
IMAGE_EXTS = frozenset({".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp"})


def _read_image(path: str, size: tuple[int, int], resize_filter: str) -> np.ndarray:
    """The gateway's host pipeline (decode, then resize with the spec's
    filter) on one file; a file it cannot decode raises naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return preprocess_bytes(data, size, filter=resize_filter)
    except ValueError as e:
        ext = os.path.splitext(path)[1].lower()
        raise ValueError(f"cannot read {path!r} ({ext} file): {e}") from e


def image_folder_batches(
    root: str,
    spec: ModelSpec,
    batch: int,
    epochs: int | None = None,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(uint8 images, int32 labels) batches from a ``<root>/<label>/<file>``
    tree (one directory per class, as the clothing dataset is laid out).

    As the JAX reader: labels map through ``spec.labels`` (any other
    directory raises ``ValueError``), an empty tree raises
    ``FileNotFoundError``, fewer images than ``batch`` with
    ``drop_remainder`` raises ``ValueError``; each epoch is
    ``default_rng(seed)``'s next permutation; ``epochs=None`` repeats
    forever.  Images are decoded and resized on the host as the gateway
    does (``ops.preprocess.preprocess_bytes``, pixel-equal to PIL for JPEG
    and PNG); a BMP, GIF or WebP file, which the JAX reader opens with
    PIL, raises a ``ValueError`` naming it.
    """
    label_to_index = {label: i for i, label in enumerate(spec.labels)}
    samples: list[tuple[str, int]] = []
    for entry in sorted(os.listdir(root)):
        class_dir = os.path.join(root, entry)
        if not os.path.isdir(class_dir):
            continue
        if entry not in label_to_index:
            raise ValueError(f"directory {entry!r} is not a spec label; expected one of "
                             f"{list(spec.labels)}")
        for fname in sorted(os.listdir(class_dir)):
            path = os.path.join(class_dir, fname)
            # Filtered at scan time: a stray README or subdirectory must not
            # stop an epoch half way.
            if os.path.splitext(fname)[1].lower() in IMAGE_EXTS and os.path.isfile(path):
                samples.append((path, label_to_index[entry]))
    if not samples:
        raise FileNotFoundError(f"no class directories with images under {root!r}")
    if drop_remainder and len(samples) < batch:
        # Every epoch would yield nothing, and with epochs=None the
        # generator would spin forever inside fit()'s next().
        raise ValueError(f"drop_remainder=True but only {len(samples)} sample(s) under "
                         f"{root!r} < batch={batch}: every epoch would yield zero batches")

    rng = np.random.default_rng(seed)
    size = spec.input_shape[:2]
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(samples))
        for start in range(0, len(order), batch):
            idx = order[start:start + batch]
            if drop_remainder and len(idx) < batch:
                break
            images = np.empty((len(idx), *spec.input_shape), np.uint8)
            labels = np.empty(len(idx), np.int32)
            for row, i in enumerate(idx):
                path, labels[row] = samples[i]
                images[row] = _read_image(path, size, spec.resize_filter)
            yield images, labels
        epoch += 1
