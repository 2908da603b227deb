"""NativeBatcher: the C++ batch queue (``native/batchqueue.cc``) binding.

The port of the JAX package's ``runtime/native_batcher.py``: the policy and
surface of ``runtime.batcher.DynamicBatcher`` -- continuous batching with a
bounded linger for stragglers, the queue cap, blocking ``predict`` with the
reference's 20 s deadline, each failed batch's error raised by its own
waiters, close with or without drain -- but the queue, the linger timer and
the gather of request images into one contiguous batch live in C++ outside
the interpreter lock (ctypes releases it around every call).  Request
threads block in native code, so a Python pause cannot stretch the
batching window.

The dispatch thread gathers each batch straight into its destination: on
the card, a pinned staging slot the engine lends (``lend_staging``), so an
image is copied once on the host, by the gather, before its H2D copy; on
the CPU, a numpy ring of ``pipeline_depth + 1`` buffers, which the engine
pads as it does any batch.  Batches go through an ``InFlightDispatcher``
(the served model's, shared with the chunked path, or one of its own), so
the pipeline stages and the depth limit are the Python batcher's, and its
completion thread hands each batch's rows (or its failure) back to the
queue.  ``submit`` returns a Future, as the Python batcher's does.
"""

from __future__ import annotations

import ctypes
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np

from kubernetes_deep_learning_tpu_torch.runtime.batcher import BatcherClosed, QueueFull
from kubernetes_deep_learning_tpu_torch.runtime.engine import (
    InFlightDispatcher,
    StagedBatch,
    resolve_pipeline_depth,
)
from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib
from kubernetes_deep_learning_tpu_torch.utils import trace as trace_lib

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)

# kdlt_bq_wait's answers.
_OK, _TIMED_OUT, _FAILED = 0, 1, 2


class NativeBatcher:
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
        """As ``DynamicBatcher``.  Raises if the queue cannot be built."""
        from kubernetes_deep_learning_tpu_torch.ops import _native

        self._lib = _native.load()
        self._engine = engine
        spec = engine.spec
        self.max_batch = max_batch or engine.max_batch
        self.max_delay = max_delay_ms / 1000.0
        self._item_shape = tuple(spec.input_shape)
        self._out_floats = int(spec.num_classes)
        depth = resolve_pipeline_depth(pipeline_depth)
        # Slots for the queued requests, and for those taken off the queue
        # that still await their rows: up to depth batches in flight, one
        # being dispatched and one gathered.
        capacity = queue_cap + self.max_batch * (depth + 2)
        self._q = self._lib.kdlt_bq_create(capacity, int(np.prod(self._item_shape)),
                                           self._out_floats)
        if not self._q:
            raise RuntimeError("kdlt_bq_create failed")
        self.queue_cap = queue_cap

        registry = registry or getattr(engine, "registry", None) or metrics_lib.Registry()
        self._dispatcher = dispatcher
        self._owns_dispatcher = False
        if dispatcher is None and depth > 1 and hasattr(engine, "predict_async"):
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

        self._closed = False
        self._destroyed = False
        self._close_lock = threading.Lock()
        # Failed-batch errors keyed by ticket, so each waiter raises ITS
        # batch's exception.  Entries whose waiters never woke (abandoned
        # after a timeout) are pruned by age: a live waiter reads its entry
        # within its own timeout, so expiring well past that never steals
        # an error from a live request.
        self._errors: dict[int, tuple[BaseException, float]] = {}  # guarded-by: _errors_lock
        self._errors_lock = threading.Lock()
        self._error_ttl_s = 120.0
        # submit()'s Futures by ticket, resolved when their batch completes.
        self._futures: dict[int, Future] = {}  # guarded-by: _futures_lock
        self._futures_lock = threading.Lock()

        self._lends = bool(getattr(engine, "lends_staging", False))
        self._ring = [] if self._lends else [
            np.empty((self.max_batch, *self._item_shape), np.uint8) for _ in range(depth + 1)
        ]
        self._tickets = np.empty(self.max_batch, np.int64)
        self._thread = threading.Thread(target=self._run, name="kdlt-native-batcher",
                                        daemon=True)
        self._thread.start()

    @property
    def queue_cap(self) -> int:
        """Queued (not yet taken) requests beyond which a submit is refused."""
        return self._queue_cap

    @queue_cap.setter
    def queue_cap(self, n: int) -> None:
        self._queue_cap = int(n)
        self._lib.kdlt_bq_set_max_pending(self._q, self._queue_cap)

    def pending(self) -> int:
        """Requests queued and not yet taken into a batch."""
        return self._lib.kdlt_bq_pending(self._q)

    # --- dispatcher --------------------------------------------------------

    def _run(self) -> None:
        tix = self._tickets.ctypes.data_as(_I64P)
        i = 0
        while True:
            slot = self._engine.lend_staging() if self._lends else None
            dst = slot.array if slot is not None else self._ring[i]
            # Waits in C (no interpreter lock) until work arrives, lingers,
            # gathers the batch into dst.  0: closed and drained.
            n = self._lib.kdlt_bq_take(self._q, dst.ctypes.data, self.max_batch,
                                       self.max_delay, -1.0, tix)
            if n == 0:
                if slot is not None:
                    self._engine.return_staging(slot)
                return
            self._m_batch_size.observe(n)
            tickets = self._tickets[:n].copy()
            batch = StagedBatch(slot, n) if slot is not None else dst[:n]
            try:
                if self._dispatcher is not None:
                    fut = self._dispatcher.submit(batch, engine=self._engine)
                    fut.add_done_callback(lambda f, t=tickets: self._publish(t, f))
                else:  # serial: dispatch and sync now
                    self._complete(tickets, self._engine.predict(batch))
            except Exception as e:  # closed or stalled dispatcher, engine error
                self._fail(tickets, e)
            finally:
                if slot is not None:  # its H2D copy, if any, is enqueued
                    self._engine.return_staging(slot)
            if not self._lends:
                i = (i + 1) % len(self._ring)

    def _publish(self, tickets: np.ndarray, fut: Future) -> None:
        """A batch's rows or failure back to its waiters.  Runs on the
        dispatcher's completion thread; must not raise (it would stop
        result delivery for later batches)."""
        try:
            exc = fut.exception()
            if exc is not None:
                self._fail(tickets, exc)
            else:
                self._complete(tickets, fut.result())
        except Exception as e:  # noqa: BLE001 - fail the batch, keep delivering
            self._fail(tickets, e)

    def _complete(self, tickets: np.ndarray, logits) -> None:
        rows = np.ascontiguousarray(np.asarray(logits)[: len(tickets)], dtype=np.float32)
        self._lib.kdlt_bq_complete(self._q, tickets.ctypes.data_as(_I64P), len(tickets),
                                   rows.ctypes.data_as(_F32P), self._out_floats)
        self._resolve_futures(tickets)

    def _fail(self, tickets: np.ndarray, e: BaseException) -> None:
        """Record the error per ticket and wake the batch's waiters."""
        now = time.monotonic()
        with self._errors_lock:
            for t in [t for t, (_, ts) in self._errors.items() if now - ts > self._error_ttl_s]:
                del self._errors[t]
            for t in tickets:
                self._errors[int(t)] = (e, now)
        self._lib.kdlt_bq_fail(self._q, tickets.ctypes.data_as(_I64P), len(tickets))
        self._resolve_futures(tickets)

    def _resolve_futures(self, tickets: np.ndarray) -> None:
        """Collect the rows of the tickets ``submit`` handed out (their batch
        has resolved, so the wait returns at once) into their Futures."""
        with self._futures_lock:
            futs = [(int(t), self._futures.pop(int(t), None)) for t in tickets]
        for ticket, fut in futs:
            if fut is None:
                continue
            try:
                row = self._collect(ticket, 0.0)
            except BaseException as e:  # noqa: BLE001 - the Future carries it
                if not fut.cancelled():
                    fut.set_exception(e)
            else:
                if not fut.cancelled():
                    fut.set_result(row)

    # --- request side ------------------------------------------------------

    def _enqueue(self, image: np.ndarray) -> int:
        if self._closed:
            raise BatcherClosed("batcher is shut down")
        image = np.ascontiguousarray(image)
        if tuple(image.shape) != self._item_shape:
            raise ValueError(f"image shape {tuple(image.shape)} != expected {self._item_shape}")
        if image.dtype != np.uint8:
            raise ValueError(f"batcher takes uint8 images, got {image.dtype}")
        ticket = self._lib.kdlt_bq_submit(self._q, image.ctypes.data_as(_U8P))
        if ticket == -1:
            self._m_queue_full.inc()
            raise QueueFull("request queue full")
        if ticket == -2:
            raise BatcherClosed("batcher is shut down")
        return ticket

    def _collect(self, ticket: int, timeout: float, trace=None) -> np.ndarray:
        """Wait in C for the ticket's row; ``trace`` gets the wait as one
        ``batcher.wait`` span."""
        out = np.empty(self._out_floats, np.float32)
        w0 = trace_lib.now_s() if trace is not None else 0.0
        rc = self._lib.kdlt_bq_wait(self._q, ticket, out.ctypes.data_as(_F32P), timeout)
        if trace is not None:
            trace.record(trace_lib.SPAN_BATCHER_WAIT, w0, trace_lib.now_s() - w0, rc=rc)
        if rc == _OK:
            return out
        if rc == _TIMED_OUT:
            raise FuturesTimeout(f"predict timed out after {timeout}s")
        if rc == _FAILED:
            with self._errors_lock:
                entry = self._errors.pop(ticket, None)
            if entry is not None:
                raise entry[0]
            raise BatcherClosed("request failed during batcher shutdown")
        raise BatcherClosed(f"batcher ticket invalid (rc={rc})")

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one HWC uint8 image; resolves to its logits row."""
        fut: Future = Future()
        # Held across the enqueue, so the batch cannot resolve before its
        # Future is registered.
        with self._futures_lock:
            self._futures[self._enqueue(image)] = fut
        return fut

    def predict(self, image: np.ndarray, timeout: float = 20.0, trace=None) -> np.ndarray:
        """Blocking single-image predict (the gateway's call), waiting in C.
        The default timeout mirrors the reference's 20 s gRPC deadline.

        ``trace`` (utils.trace.RequestTrace, optional) records ONE coarse
        ``batcher.wait`` span covering queue + dispatch + execute +
        readback: the C++ ticket queue carries no per-request Python
        objects to the dispatch loop, so this path trades per-stage
        attribution for its GIL-free hot path (the scheduler's lane and the
        Python batcher give the full stage breakdown)."""
        return self._collect(self._enqueue(image), timeout, trace)

    # --- lifecycle ---------------------------------------------------------

    def close(self, drain: bool = True) -> None:
        """Stop intake; with drain, let queued work finish first.

        The C++ queue is NOT freed here: a handler thread past the closed
        check may still be inside submit/wait, so freeing now would be a
        use after free.  close stops intake (new predicts raise
        BatcherClosed; without drain, queued waiters fail now); the free
        happens in __del__, which cannot run while any thread is inside a
        method of this object.
        """
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            if drain:
                self._lib.kdlt_bq_close(self._q)  # queued work still served
            else:
                self._lib.kdlt_bq_abort(self._q)  # queued waiters fail now
            self._thread.join(timeout=30.0)
            # The dispatch thread has exited, so nothing else submits: the
            # owned dispatcher drains the in-flight batches, whose callbacks
            # hand their rows to the queue.  An injected dispatcher belongs
            # to its creator.
            if self._owns_dispatcher:
                self._dispatcher.close(drain=True)
            if not drain:  # submit()'s Futures of requests the abort failed
                with self._futures_lock:
                    left = np.fromiter(self._futures, np.int64)
                self._resolve_futures(left)

    def __del__(self):  # the only place the C++ queue is freed
        try:
            if not getattr(self, "_q", None) or self._destroyed:
                return
            if not self._closed:
                self.close(drain=False)
            if not self._thread.is_alive():
                self._destroyed = True
                self._lib.kdlt_bq_destroy(self._q)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
