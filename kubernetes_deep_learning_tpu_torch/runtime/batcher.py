"""Dynamic batcher: aggregate concurrent single-image requests into batches.

The port of the JAX package's ``runtime/batcher.py``, with the same flush
policy and surface.  The reference's gateway sends one image per request,
so without this every request would run as its own bucket-1 forward.

Flush policy: a dispatch thread takes whatever is queued the moment it goes
idle (continuous batching) but, when the batch is small, waits up to
``max_delay`` for more work to arrive.  Under light load a request
therefore pays at most max_delay extra latency; under heavy load the
engine is never idle and batches grow to ``max_batch`` naturally, with no
timer on the hot path.

Pipelined dispatch: against an engine exposing ``predict_async`` the
dispatch thread hands each assembled batch to an InFlightDispatcher
(runtime.engine) and immediately loops back to assemble the NEXT batch --
batch N+1's gather, staging and kernel launches overlap batch N's device
execution, and the dispatcher's completion thread fans results out to the
request futures.  Backpressure comes from the dispatcher's bounded
in-flight depth: submit blocks once ``pipeline_depth`` batches are in
flight, so the queue (not unbounded device work) absorbs overload.  At
depth 1, or with a plain engine (no ``predict_async``), the loop is
dispatch-then-sync.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np

from kubernetes_deep_learning_tpu_torch.runtime.errors import BatcherClosed, QueueFull  # noqa: F401
from kubernetes_deep_learning_tpu_torch.runtime.engine import (
    InFlightDispatcher,
    resolve_pipeline_depth,
)
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib
from kubernetes_deep_learning_tpu_torch.utils import trace as trace_lib


class DynamicBatcher:
    def __init__(
        self,
        engine,
        max_batch: int | None = None,
        max_delay_ms: float = 2.0,
        queue_cap: int = 2048,
        registry: metrics_lib.Registry | None = None,
        pipeline_depth: int | None = None,
        dispatcher: InFlightDispatcher | None = None,
    ):
        """``pipeline_depth`` bounds how many batches may be in flight on the
        device at once (None = $KDLT_PIPELINE_DEPTH or 2; 1 = serial
        dispatch).  ``dispatcher`` injects a shared InFlightDispatcher --
        e.g. the served model's, so the batcher and the direct multi-image
        path share one in-flight budget; the batcher then does NOT close it.
        """
        self._engine = engine
        self.max_batch = max_batch or engine.max_batch
        self.max_delay = max_delay_ms / 1000.0
        self.queue_cap = queue_cap
        # (image, future, trace, enqueue wall time)
        self._queue: list[tuple] = []  # guarded-by: _cond
        self._cond = threading.Condition()
        self._closed = False  # guarded-by: _cond

        registry = registry or getattr(engine, "registry", None) or metrics_lib.Registry()
        self._dispatcher = dispatcher
        self._owns_dispatcher = False
        if dispatcher is None:
            depth = resolve_pipeline_depth(pipeline_depth)
            if depth > 1 and hasattr(engine, "predict_async"):
                self._dispatcher = InFlightDispatcher(engine, depth=depth, registry=registry)
                self._owns_dispatcher = True
        self._m_batch_size = registry.histogram(
            "kdlt_batcher_batch_size",
            "dispatched batch sizes",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
        )
        self._m_queue_full = registry.counter(
            "kdlt_batcher_rejected_total", "requests rejected because queue was full"
        )
        self._thread = threading.Thread(target=self._run, name="kdlt-batcher", daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, trace=None) -> Future:
        """Enqueue one HWC uint8 image; resolves to its logits row.

        ``trace`` (utils.trace.RequestTrace, optional) gets a
        ``batcher.queue_wait`` span for the time spent coalescing, then the
        dispatcher's four pipeline-stage spans (or, without a dispatcher,
        an ``engine.predict`` span)."""
        image = np.asarray(image)
        expected = getattr(getattr(self._engine, "spec", None), "input_shape", None)
        if expected is not None and tuple(image.shape) != tuple(expected):
            raise ValueError(f"image shape {tuple(image.shape)} != expected {tuple(expected)}")
        if image.dtype != np.uint8:
            # np.stack would silently upcast a mixed uint8/float batch and the
            # uint8 rows would skip normalization; keep the batcher single-dtype.
            raise ValueError(f"batcher takes uint8 images, got {image.dtype}")
        fut: Future = Future()
        enq_w = trace_lib.now_s() if trace is not None else 0.0
        with self._cond:
            if self._closed:
                raise BatcherClosed("batcher is shut down")
            if len(self._queue) >= self.queue_cap:
                self._m_queue_full.inc()
                raise QueueFull("request queue full")
            self._queue.append((image, fut, trace, enq_w))
            self._cond.notify()
        return fut

    def predict(self, image: np.ndarray, timeout: float = 20.0, trace=None) -> np.ndarray:
        """Blocking single-image predict (the gateway's call).  The default
        timeout mirrors the reference's 20 s gRPC deadline."""
        return self.submit(image, trace=trace).result(timeout=timeout)

    def _take_batch(self) -> list[tuple]:
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait()
            if self._closed and not self._queue:
                return []
            # Small batch and engine idle: linger briefly for stragglers.
            if len(self._queue) < self.max_batch and self.max_delay > 0:
                deadline = time.monotonic() + self.max_delay
                while len(self._queue) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(timeout=remaining):
                        break
            batch = self._queue[: self.max_batch]
            del self._queue[: len(batch)]
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return  # closed and drained
            self._m_batch_size.observe(len(batch))
            traces = [tr for _, _, tr, _ in batch if tr is not None]
            taken_w = 0.0
            if traces:
                # Queue-wait span per member: enqueue -> batch assembly.
                taken_w = trace_lib.now_s()
                tags = {"batch": len(batch)}
                for _, _, tr, enq_w in batch:
                    if tr is not None:
                        tr.defer(((trace_lib.SPAN_BATCHER_QUEUE_WAIT, enq_w, taken_w - enq_w,
                                   tags),))
            if self._dispatcher is not None:
                # Pipelined path: enqueue and IMMEDIATELY go assemble the
                # next batch.  submit() itself provides backpressure (blocks
                # at the in-flight depth limit); the dispatcher's completion
                # thread runs _publish via the done callback.
                try:
                    fut_batch = self._dispatcher.submit(
                        np.stack([img for img, _, _, _ in batch]), traces=traces)
                except Exception as e:  # closed or stalled dispatcher, bad batch
                    _fail(batch, e)
                    continue
                fut_batch.add_done_callback(lambda f, batch=batch: self._publish(batch, f))
                continue
            try:
                logits = self._engine.predict(np.stack([img for img, _, _, _ in batch]))
            except Exception as e:  # propagate to all waiters, keep serving
                _fail(batch, e)
                continue
            if traces:
                done_w = trace_lib.now_s()
                for tr in traces:
                    tr.defer(((trace_lib.SPAN_ENGINE_PREDICT, taken_w, done_w - taken_w,
                               {"batch": len(batch)}),))
            _resolve(batch, logits)

    @staticmethod
    def _publish(batch, fut_batch: Future) -> None:
        """Fan one completed batch's rows (or its failure) out to its
        waiters.  Runs on the dispatcher's completion thread; must not
        raise (it would kill result delivery for later batches)."""
        exc = fut_batch.exception()
        if exc is not None:
            _fail(batch, exc)
        else:
            _resolve(batch, fut_batch.result())

    def close(self, drain: bool = True) -> None:
        with self._cond:
            self._closed = True
            if not drain:
                _fail(self._queue, BatcherClosed("batcher shut down"))
                self._queue.clear()
            self._cond.notify_all()
        self._thread.join(timeout=30.0)
        # After the dispatch thread has exited nothing else submits, so a
        # dispatcher close cannot race; it drains the in-flight batches and
        # resolves their futures.  A shared (injected) dispatcher belongs
        # to its creator.
        if self._owns_dispatcher:
            self._dispatcher.close(drain=True)


def _resolve(batch, logits) -> None:
    for i, (_, fut, _, _) in enumerate(batch):
        if not fut.cancelled():
            fut.set_result(logits[i])


def _fail(batch, exc: BaseException) -> None:
    for _, fut, _, _ in batch:
        if not fut.cancelled():
            fut.set_exception(exc)
