"""Gateway-side upstream micro-batching: fat requests to the model tier.

The port's copy of the JAX package's ``serving/microbatch.py``, over the
port's ``BatcherClosed`` and ``QueueFull`` and its pipeline-depth knob.

Throughput math that motivates this (measured in BENCH.md's host-path
section): the model server is ONE Python process per accelerator, so its
HTTP/protocol handling is GIL-serialized -- per-request host cost caps its
single-image ingest rate regardless of handler threads.  Gateways, by
contrast, are stateless and scale horizontally (the reference's own replica
mechanism).  Coalescing concurrent single-image gateway requests into one
upstream predict moves the per-request overhead to the tier that scales,
and turns the model tier's workload into few, large requests whose
per-image host cost is tens of microseconds.

This is the same policy/shape as the model tier's own DynamicBatcher
(queue + linger + size trigger) applied one tier up; the model tier's
batcher stays useful for traffic arriving from MANY gateway replicas.

Pipelined flushes: the dispatcher thread hands each assembled batch to a
small bounded pool (``pipeline_depth`` workers, default 2 -- the same knob
as the model tier's in-flight dispatch) and immediately assembles the next
batch, so upstream HTTP round-trip time overlaps gateway-side batch
assembly exactly the way device execution overlaps H2D in the engine
pipeline.  Batches are independent (each waiter's future is wired to its
own batch), so cross-batch completion order does not matter; depth 1
restores the strictly serial flush loop.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np

# An unresponsive upstream must surface as an error, not an eternal hang;
# matches the model tier's own batcher wait bound (runtime/batcher.py) and
# comfortably exceeds the gateway's upstream read timeout.
RESULT_TIMEOUT_S = 120.0


class UpstreamStall(RuntimeError):
    """The micro-batched upstream produced no result within the bound.

    Typed (rather than letting concurrent.futures.TimeoutError escape) so
    the gateway can map it to a retryable 503 without catching the builtin
    TimeoutError -- which, on Python >= 3.11, IS futures.TimeoutError and
    would swallow client-side image-fetch timeouts too.
    """


class UpstreamMicroBatcher:
    """Coalesce single-image predicts into one upstream batch call.

    ``predict_batch(images, request_id) -> (logit_rows, labels)`` is the
    gateway's existing upstream call; requests enqueue (image, future) and a
    single dispatcher thread flushes on max_batch or linger expiry.
    Upstream failures propagate to every waiter of the flushed batch.
    """

    def __init__(
        self,
        predict_batch,
        max_batch: int = 64,
        max_delay_ms: float = 2.0,
        max_queue: int = 1024,
        pipeline_depth: int | None = None,
    ):
        from kubernetes_deep_learning_tpu_torch.runtime.engine import resolve_pipeline_depth

        self._predict_batch = predict_batch
        self.max_batch = max_batch
        self._max_delay_s = max_delay_ms / 1e3
        self._max_queue = max_queue
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._queue: list[tuple[np.ndarray, str, Future]] = []
        self._closed = False
        # Up to pipeline_depth upstream flushes in flight; the semaphore is
        # the backpressure (the dispatcher blocks on a slot before handing
        # off, so assembly never runs unboundedly ahead of the upstream).
        # Flushes run on short-lived DAEMON threads rather than a pool:
        # every thread here must stay daemonic so a wedged upstream can
        # never block interpreter exit (waiters bail out on their own
        # RESULT_TIMEOUT_S regardless).
        self._flush_depth = resolve_pipeline_depth(pipeline_depth)
        self._flush_slots = (
            threading.Semaphore(self._flush_depth)
            if self._flush_depth > 1
            else None
        )
        self._thread = threading.Thread(
            target=self._run, name="kdlt-upstream-batcher", daemon=True
        )
        self._thread.start()

    def predict(
        self, image: np.ndarray, request_id: str = "", timeout: float | None = None
    ):
        """One image (H,W,C) -> (logit_row, labels); blocks until served.

        ``timeout`` is the caller's REMAINING deadline budget
        (serving.admission): with only the fixed RESULT_TIMEOUT_S bound, a
        waiter whose caller timed out at 20 s kept blocking a gateway
        thread for up to 120 s -- a slow leak under sustained overload.
        The wait is bounded by min(budget, RESULT_TIMEOUT_S), and a
        timed-out waiter's entry is discarded from the queue if it has not
        been flushed yet, so abandoned work never reaches the model tier.
        """
        from kubernetes_deep_learning_tpu_torch.runtime.errors import BatcherClosed, QueueFull

        fut: Future = Future()
        with self._lock:
            if self._closed:
                # Typed so the gateway maps shutdown races to a retryable
                # 5xx, never a client-fault 400.
                raise BatcherClosed("upstream batcher is closed")
            if len(self._queue) >= self._max_queue:
                raise QueueFull(
                    f"upstream batch queue at {self._max_queue} entries"
                )
            self._queue.append((image, request_id, fut))
            self._nonempty.notify()
        bound = (
            RESULT_TIMEOUT_S if timeout is None
            else max(0.0, min(timeout, RESULT_TIMEOUT_S))
        )
        try:
            return fut.result(timeout=bound)
        except FuturesTimeout:
            self._discard(fut)
            raise UpstreamStall(
                f"no upstream response in {bound:.1f}s"
            ) from None

    def _discard(self, fut: Future) -> None:
        """Drop a timed-out waiter's entry if it is still queued (its caller
        is gone; flushing it upstream would be pure wasted work)."""
        with self._lock:
            for i, (_, _, f) in enumerate(self._queue):
                if f is fut:
                    del self._queue[i]
                    return

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._nonempty.wait()
                if self._closed and not self._queue:
                    return
                # Linger: once something is queued, keep waiting until the
                # batch fills or the deadline passes.  wait() wakes on EVERY
                # enqueue notify, so the deadline must be re-checked in a
                # loop (a single wait(delay) would flush ~size-2 batches
                # under steady load; same pattern as DynamicBatcher).
                deadline = time.monotonic() + self._max_delay_s
                while len(self._queue) < self.max_batch and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._nonempty.wait(remaining):
                        break
                batch = self._queue[: self.max_batch]
                del self._queue[: self.max_batch]
            if not batch:
                continue
            if self._flush_slots is not None:
                # Pipelined: block only on a flush SLOT (backpressure at
                # pipeline_depth in-flight upstream calls), then go straight
                # back to assembling the next batch while this one rides
                # the upstream round trip on its own thread.
                self._flush_slots.acquire()
                threading.Thread(
                    target=self._flush, args=(batch,),
                    name="kdlt-upstream-flush", daemon=True,
                ).start()
                continue
            self._flush(batch)

    def _flush(self, batch) -> None:
        """One upstream call + fan-out; runs inline (depth 1) or on a
        flush thread.  Must not raise: an escaping exception would strand
        a flush slot / kill the dispatcher loop."""
        try:
            images = np.stack([b[0] for b in batch])
            # Trace the coalesced flush under EVERY member's request id
            # (joined, truncated): with only the first waiter's id, the
            # gateway->model hop was invisible to an X-Request-Id grep for
            # the other members (ADVICE r2).  The upstream log line carries
            # the batch size so the fan-in stays visible from either tier.
            rids = [b[1] for b in batch if b[1]]
            rid = ",".join(rids[:8]) + (f",+{len(rids) - 8}" if len(rids) > 8 else "")
            try:
                rows, labels = self._predict_batch(images, rid)
                if len(rows) < len(batch):
                    raise RuntimeError(
                        f"upstream returned {len(rows)} rows for "
                        f"{len(batch)} images"
                    )
            except BaseException as e:  # noqa: BLE001 - fan the failure out
                for _, _, fut in batch:
                    fut.set_exception(e)
                return
            # Fan-out must also never kill the dispatcher: a failure here
            # (anything unexpected) resolves the remaining futures with the
            # error instead of leaving waiters blocked forever.
            for i, (_, _, fut) in enumerate(batch):
                try:
                    fut.set_result((rows[i], labels))
                except BaseException as e:  # noqa: BLE001
                    if not fut.done():
                        fut.set_exception(e)
        finally:
            if self._flush_slots is not None:
                self._flush_slots.release()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()
        self._thread.join(timeout=5)
        if self._flush_slots is not None:
            # The dispatcher thread has exited, so no new flushes start;
            # drain the in-flight ones with a BOUNDED wait -- a wedged
            # upstream must not turn close() into a hang (its waiters
            # resolve via their own timeout, and the flush thread is
            # daemonic so it cannot pin the process either).
            deadline = time.monotonic() + 10.0
            for _ in range(self._flush_depth):
                self._flush_slots.acquire(
                    timeout=max(0.0, deadline - time.monotonic())
                )
